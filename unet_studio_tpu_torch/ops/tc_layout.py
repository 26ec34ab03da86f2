"""Operand layouts of the bf16 tensor-core conv kernels (``csrc/conv_tc.cu``).

Each kernel is an implicit GEMM ``out (M, N) = A (M, K) @ B (K, N)`` on
``mma.sync.m16n8k16``: M output voxels, N output channels, K walked in
k-steps of 16.  The wrappers (``ops/conv.py``) build B here, on the
weights' device, before each launch:

- ``k1_weight_matrix``: K1's B, K in (source, tap, channel) order, tap =
  kz*9 + ky*3 + kx, so k-step ``(s*27 + tap)*Ci/16 + chunk`` holds 16
  channels of one tap of one source;
- ``entry_weight_matrix``: the 1->C entry's B, its 27 taps padded to 32
  with zero rows;
- ``s2dx_weight_matrix``: K7's B, K in (tap, g channel) order over the
  taps of ``s2dx_taps``, the 8 parity classes one after another;
- ``pack_b``: B in mma fragment order, the layout the kernels read;
- ``pack_weights``: one of those matrices packed, as one gather through
  an index built once per layout and weight shape (the wrappers' path:
  a few small launches per call, where building it afresh takes dozens).

The kernels recompute the same K order from their loop indices; the CPU
tests hold these matrices, through a plain im2col GEMM, to the convs'
twins, and the card tests hold the kernels to the twins.

K5 (``dw_tc_kernel``) packs no weights: it reads x and g as they are.
Its geometry is here as plain functions (``dw_*``, ``swizzle``), the
same arithmetic as the kernel's: the tiles each block walks, the halo and
a tap's voxel offset in it, the 16-byte chunk swizzle, the rows each lane
hands ldmatrix, which warp owns which (tap, m-tile) job, the grid and the
partial buffer.  The wrapper sizes the launch with them; the CPU tests
replay the kernel's GEMM through them against ``conv_dw_plain``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

# per axis, the (g offset, conv tap) pairs of a dx voxel of parity 0 and 1
_S2_AXIS = {0: ((0, 1),), 1: ((0, 2), (1, 0))}


def pack_b(wm: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (K/16, N/16, 32, 8): for each k-step and each pair of
    8-wide n-tiles, lane l's 8 values, one 16-byte load, as the registers
    [b0, b1] of n-tile 2p then of n-tile 2p+1 of ``mma.m16n8k16``'s B
    fragment: lane l holds column n = l // 4 of its n-tile, b0 the rows
    k = 2(l % 4) and 2(l % 4) + 1, b1 those rows + 8 (lower k in the lower
    half of each 32-bit register)."""
    k_dim, n_dim = wm.shape
    if k_dim % 16 or n_dim % 16:
        raise ValueError(f"pack_b: ({k_dim}, {n_dim}) is not a multiple of 16")
    dev = wm.device
    ks = torch.arange(k_dim // 16, device=dev).view(-1, 1, 1, 1, 1)
    p = torch.arange(n_dim // 16, device=dev).view(1, -1, 1, 1, 1)
    lane = torch.arange(32, device=dev).view(1, 1, -1, 1, 1)
    reg = torch.arange(4, device=dev).view(1, 1, 1, -1, 1)  # b0, b1, b0', b1'
    half = torch.arange(2, device=dev).view(1, 1, 1, 1, -1)
    n = (2 * p + reg // 2) * 8 + lane // 4
    k = ks * 16 + (lane % 4) * 2 + half + 8 * (reg % 2)
    return wm[k, n].reshape(k_dim // 16, n_dim // 16, 32, 8).contiguous()


def k1_weight_matrix(w: torch.Tensor, nsrc: int = 1) -> torch.Tensor:
    """(Co, nsrc*Ci, 3, 3, 3) -> (nsrc*27*Ci, Co), K = (source, tap, channel)."""
    co, cin = w.shape[:2]
    ci = cin // nsrc
    return w.reshape(co, nsrc, ci, 27).permute(1, 3, 2, 0).reshape(nsrc * 27 * ci, co)


def entry_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """(Co, 1, 3, 3, 3) -> (32, Co): the 27 taps, then 5 zero rows."""
    return F.pad(w.reshape(w.shape[0], 27).T, (0, 0, 0, 5))


def s2dx_taps() -> list[tuple[int, tuple[int, int, int], tuple[int, int, int]]]:
    """The 27 taps of K7 in the kernel's order: (class p, g offset (z, y,
    x), conv tap (kz, ky, kx)).  Class p = 4*pz + 2*py + px takes the dx
    voxels 2q + (pz, py, px); per axis parity 0 reads tap 1 of g[q], parity
    1 tap 2 of g[q] and tap 0 of g[q+1]; z outermost."""
    out = []
    for p in range(8):
        pz, py, px = p >> 2, (p >> 1) & 1, p & 1
        for oz, kz in _S2_AXIS[pz]:
            for oy, ky in _S2_AXIS[py]:
                for ox, kx in _S2_AXIS[px]:
                    out.append((p, (oz, oy, ox), (kz, ky, kx)))
    return out


def s2dx_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """The stride-2 conv's (Co, Ci, 3, 3, 3) -> (27*Co, Ci), K = (tap of
    ``s2dx_taps``, g channel), N = dx channel."""
    return torch.cat([w[:, :, kz, ky, kx] for _, _, (kz, ky, kx) in s2dx_taps()])


LAYOUTS = {
    "k1": k1_weight_matrix,
    "k1_dual": functools.partial(k1_weight_matrix, nsrc=2),
    "entry": entry_weight_matrix,
    "s2dx": s2dx_weight_matrix,
}


@functools.lru_cache(maxsize=None)
def _pack_index(layout: str, shape: tuple, device: str) -> torch.Tensor:
    """For each packed position, 1 + the flat index of its weight in a
    tensor of ``shape``, or 0 for a padding zero."""
    ids = torch.arange(1, math.prod(shape) + 1, dtype=torch.float64).reshape(shape)
    return pack_b(LAYOUTS[layout](ids)).to(torch.int64).to(device)


def pack_weights(w: torch.Tensor, layout: str) -> torch.Tensor:
    """``pack_b(LAYOUTS[layout](w))``, gathered in one pass."""
    idx = _pack_index(layout, tuple(w.shape), str(w.device))
    return torch.cat([w.new_zeros(1), w.reshape(-1)])[idx]


# ---------------------------------------------------------------------------
# K5 on the tensor cores: dw_tc_kernel's geometry
# ---------------------------------------------------------------------------

DW_TX = 16  # output x per k-step (one mma K of 16 voxels)
DW_NB = 16  # output channels per block: grid.y slices Co
DW_WARPS = 9  # stride 1: one warp per (dz, dx) tap column
DWE_WARPS = 8  # the entry: warps share out the k-rows
DW_CI = (1, 16, 32, 64)  # input channels with an instance (1: the entry)
DW_CO = (16, 32, 64)
# blocks per SM the grid assumes (registers and the double-buffered tiles'
# shared memory of each instance allow these many at once; fewer would
# only add a second wave)
DW_BLOCKS_PER_SM = {1: 3, 16: 3, 32: 2, 64: 1}


def swizzle(nc: int, v, c):
    """Physical 16-byte chunk of logical chunk ``c`` of voxel row ``v``
    in a tile of ``nc`` chunks per row (``swz<NC>`` of conv_tc.cu): 8
    consecutive rows reading one logical chunk land in 8 distinct bank
    groups.  An involution: the same call maps physical back to logical."""
    if nc >= 8:
        return c ^ (v & 7)
    return c ^ ((v // (8 // nc)) & (nc - 1))


def dw_tile(ci: int) -> tuple[int, int, int]:
    """(TZ, TY, TX) output voxels of one tile; K is walked one x row of 16
    voxels (a k-row) at a time, TZ * TY k-rows per tile."""
    return (1 if ci == 64 else 2), 8, DW_TX


def dw_halo(ci: int) -> tuple[int, int, int]:
    """(HZ, HY, HX) voxels of x staged per tile: the tile and one voxel
    around it, origin at the tile's (z0 - 1, y0 - 1, x0 - 1)."""
    tz, ty, tx = dw_tile(ci)
    return tz + 2, ty + 2, tx + 2


def dw_tiles(dims, ci: int) -> list[tuple[int, int, int]]:
    """(z0, y0, x0) of every tile, in tile-index order (x fastest); block
    b of a co slice takes tiles b, b + nblk, ..."""
    tz, ty, tx = dw_tile(ci)
    d, h, w = dims
    return [(z, y, x) for z in range(0, d, tz) for y in range(0, h, ty) for x in range(0, w, tx)]


def dw_ntiles(dims, ci: int) -> int:
    """``len(dw_tiles(dims, ci))``, without listing them."""
    return math.prod(-(-n // t) for n, t in zip(dims, dw_tile(ci)))


def dw_tap_offset(tap: int, ci: int) -> int:
    """Halo voxel offset of tap (dz, dy, dx) = (tap // 9, tap // 3 % 3,
    tap % 3): the tap's A is the halo read that many voxels further on."""
    _, hy, hx = dw_halo(ci)
    return ((tap // 9) * hy + (tap // 3) % 3) * hx + tap % 3


def dw_krow_base(r: int, ci: int) -> int:
    """Halo voxel of k-row ``r`` (tile row (r // TY, r % TY)) at x 0."""
    _, ty, _ = dw_tile(ci)
    _, hy, hx = dw_halo(ci)
    return ((r // ty) * hy + r % ty) * hx


def dw_lane_rows() -> dict[str, torch.Tensor]:
    """The (row, chunk) each lane hands ``ldmatrix.x4.trans``.  A (x^T):
    rows are k-step voxels 0-7 for matrices 0 and 1, 8-15 for 2 and 3,
    chunk +0 for matrices 0 and 2, +1 for 1 and 3 (the m-tile's channels
    0-7, 8-15), giving the mma's a0..a3.  B (g): voxels 0-7 then 8-15 at
    chunk 0 (b0, b1 of n-tile 0), then at chunk 1 (n-tile 1)."""
    lane = torch.arange(32)
    return {"a_row": (lane & 7) + ((lane >> 4) << 3), "a_chunk": (lane >> 3) & 1,
            "b_row": (lane & 7) + (((lane >> 3) & 1) << 3), "b_chunk": lane >> 4}


def dw_jobs(ci: int) -> list[tuple[int, int]]:
    """(tap, m-tile) jobs in job order: 27 taps x Ci/16 m-tiles; the
    entry's one job per m-tile of its 32 padded taps (tap 0 stands for
    the whole im2col row)."""
    if ci == 1:
        return [(0, mt) for mt in range(2)]
    return [(j // (ci // 16), j % (ci // 16)) for j in range(27 * (ci // 16))]


def dw_warps(ci: int) -> int:
    return DWE_WARPS if ci == 1 else DW_WARPS


def dw_warp_jobs(ci: int, warp: int) -> list[int]:
    """The jobs ``warp`` owns.  Stride 1: the tap column (dz, dx) = (warp
    // 3, warp % 3), its three dy taps and every m-tile (a window of three
    A fragments slides down the k-rows of a z plane, halo row y + dy
    serving tap dy at k-row y).  The entry: both jobs, the warp taking
    the k-rows r = warp + 8 i instead."""
    if ci == 1:
        return [0, 1]
    dz, dx = divmod(warp, 3)
    mt_n = ci // 16
    return [(dz * 9 + dy * 3 + dx) * mt_n + mt for mt in range(mt_n) for dy in range(3)]


def dw_warp_krows(ci: int, warp: int) -> list[int]:
    tz, ty, _ = dw_tile(ci)
    return list(range(warp, tz * ty, DWE_WARPS)) if ci == 1 else list(range(tz * ty))


def dw_blocks(dims, ci: int, co: int, n_sm: int) -> int:
    """Blocks per co slice (grid.x): one wave over the card, no more than
    there are tiles."""
    per_slice = DW_BLOCKS_PER_SM[ci] * n_sm // (co // DW_NB)
    return max(1, min(dw_ntiles(dims, ci), per_slice))


def dw_partial_shape(nblk: int, ci: int, co: int) -> tuple[int, int, int, int]:
    """The per-block partial sums, added over blocks in order into dW."""
    return nblk, 27, ci, co
