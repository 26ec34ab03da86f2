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
- ``k3_weight_matrix``: K3's B, K1's order, Co = 128 as two halves of 64
  channels one after the other along K (a block of K3 takes one half);
- ``s2dx_weight_matrix``: K7's B, K in (tap, g channel) order over the
  taps of ``s2dx_taps``, the 8 parity classes one after another;
- ``pack_b``: B in mma fragment order, the layout the kernels read;
- ``pack_weights``: one of those matrices packed, as one gather through
  an index built once per layout and weight shape (the wrappers' path:
  a few small launches per call, where building it afresh takes dozens).

The kernels recompute the same K order from their loop indices; the CPU
tests hold these matrices, through a plain im2col GEMM, to the convs'
twins, and the card tests hold the kernels to the twins.

K3's tile geometry is here too (``k3_*``, ``s2_slot``): its input halo
is staged split by x parity, so a tap's 16 A rows are consecutive.

K5 and K6 (``dw_tc_kernel``, ``dw_s2_tc_kernel``) pack no weights: they
read x and g as they are.  Their geometry is here as plain functions
(``dw_*`` with ``stride`` 1 or 2, ``swizzle``), the same arithmetic as the
kernels': the tiles each block walks, the halo and a tap's voxel offset
in it, the 16-byte chunk swizzle, the rows each lane hands ldmatrix,
which warp owns which (tap, m-tile) job, the grid and the partial buffer.
The wrappers size the launches with them; the CPU tests replay the
kernels' GEMMs through them against ``conv_dw_plain``.
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


# K3 (and K6): output channels per block, Co = 128 split over grid.y
K3_NB = 64
# (Ci, Co) of the stride-2 convs with a tensor-core instance (K3 and K6)
S2_PAIRS = ((16, 32), (32, 64), (64, 128))


def k3_nb(co: int) -> int:
    return min(co, K3_NB)


def k3_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) -> (Co / NB * 27 * Ci, NB): K1's (27 * Ci, Co)
    matrix cut into its column slices of NB = ``k3_nb(Co)``, stacked along
    K, so that slice h's k-steps are the h-th contiguous run of the packed
    weights."""
    wm = k1_weight_matrix(w)
    return torch.cat(wm.split(k3_nb(wm.shape[1]), dim=1), 0)


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
    "k3": k3_weight_matrix,
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
# the stride-2 input halo of K3 and K6 (s2_tc_kernel, dw_s2_tc_kernel)
# ---------------------------------------------------------------------------

S2_HX = 33  # halo x of a tile of 16 output x: the 16 even input x, then the 17 odd


def s2_slot(dx: int) -> int:
    """Halo slot of tap dx for output x offset 0 (add the offset m): the
    even input x 2(x0 + m) at slot m (dx = 1), the odd 2(x0 + m) - 1 and
    2(x0 + m) + 1 at slots 16 + m (dx = 0) and 17 + m (dx = 2)."""
    return 0 if dx == 1 else 16 + dx // 2


def s2_slot_x(sl: int) -> int:
    """Input x of halo slot ``sl`` less the tile's 2 * x0 - 1."""
    return 2 * sl + 1 if sl < 16 else 2 * (sl - 16)


def s2_halo(tz: int, ty: int) -> tuple[int, int, int]:
    """(HZ, HY, HX) input voxels staged for a tile of tz x ty x 16 output
    voxels, origin at input (2 z0 - 1, 2 y0 - 1, 2 x0 - 1)."""
    return 2 * tz + 1, 2 * ty + 1, S2_HX


def s2_tap_offset(tap: int, tz: int, ty: int) -> int:
    """Halo voxel offset of tap (dz, dy, dx) from the row base of output
    row (0, 0) (``s2_row_base``)."""
    _, hy, hx = s2_halo(tz, ty)
    return ((tap // 9) * hy + (tap // 3) % 3) * hx + s2_slot(tap % 3)


def s2_row_base(r: int, tz: int, ty: int) -> int:
    """Halo voxel of tile row r = (r // ty, r % ty) at tap (0, 0, 1), x 0."""
    _, hy, hx = s2_halo(tz, ty)
    return (2 * (r // ty) * hy + 2 * (r % ty)) * hx


TC_WARPS = 4  # warps of the forward tensor-core kernels


def k3_tile(ci: int) -> tuple[int, int, int]:
    """(TZ, TY, TX) output voxels of one K3 tile; row block r = warp * MT +
    mt, MT = TZ * TY / 4, is the output row (r // TY, r % TY)."""
    return (1 if ci == 64 else 2), 4, 16


def k3_tiles(out_dims, ci: int) -> list[tuple[int, int, int]]:
    """(z0, y0, x0) of every K3 tile in tile-index order (x fastest); block
    b takes tiles b, b + grid, ..."""
    tz, ty, tx = k3_tile(ci)
    d, h, w = out_dims
    return [(z, y, x) for z in range(0, d, tz) for y in range(0, h, ty) for x in range(0, w, tx)]


# ---------------------------------------------------------------------------
# K5 and K6 on the tensor cores: dw_tc_kernel's and dw_s2_tc_kernel's geometry
# ---------------------------------------------------------------------------

DW_TX = 16  # output x per k-step (one mma K of 16 voxels)
DW_NB = 16  # stride 1: output channels per block, grid.y slices Co
DW_WARPS = 9  # one warp per (dz, dx) tap column
DWE_WARPS = 8  # the entry: warps share out the k-rows
DW_CI = (1, 16, 32, 64)  # stride 1: input channels with an instance (1: the entry)
DW_CO = (16, 32, 64)  # stride 1; stride 2 takes the (Ci, Co) of S2_PAIRS
# blocks per SM the grid assumes (registers and the double-buffered tiles'
# shared memory of each instance allow these many at once; fewer would
# only add a second wave)
DW_BLOCKS_PER_SM = {1: 3, 16: 3, 32: 2, 64: 1}
DW_S2_BLOCKS_PER_SM = {16: 2, 32: 1, 64: 1}


def swizzle(nc: int, v, c):
    """Physical 16-byte chunk of logical chunk ``c`` of voxel row ``v``
    in a tile of ``nc`` chunks per row (``swz<NC>`` of conv_tc.cu): 8
    consecutive rows reading one logical chunk land in 8 distinct bank
    groups.  An involution: the same call maps physical back to logical."""
    if nc >= 8:
        return c ^ (v & 7)
    return c ^ ((v // (8 // nc)) & (nc - 1))


def dw_nb(ci: int, stride: int = 1) -> int:
    """Output channels per block (grid.y slices Co): 16 at stride 1; at
    stride 2, 32 (x's halo staged once per 32 channels) but 16 at Ci = 64,
    where the accumulators would not fit."""
    return 32 if stride == 2 and ci != 64 else DW_NB


def dw_tile(ci: int, stride: int = 1) -> tuple[int, int, int]:
    """(TZ, TY, TX) voxels of g in one tile; K is walked one x row of 16
    voxels (a k-row) at a time, TZ * TY k-rows per tile."""
    if stride == 2:
        return 2, (2 if ci == 64 else 4), DW_TX
    return (1 if ci == 64 else 2), 8, DW_TX


def dw_halo(ci: int, stride: int = 1) -> tuple[int, int, int]:
    """(HZ, HY, HX) voxels of x staged per tile.  Stride 1: the tile and
    one voxel around it, origin at the tile's (z0 - 1, y0 - 1, x0 - 1).
    Stride 2: ``s2_halo``, each row split by x parity."""
    tz, ty, tx = dw_tile(ci, stride)
    if stride == 2:
        return s2_halo(tz, ty)
    return tz + 2, ty + 2, tx + 2


def dw_tiles(dims, ci: int, stride: int = 1) -> list[tuple[int, int, int]]:
    """(z0, y0, x0) of every tile of g's ``dims``, in tile-index order (x
    fastest); block b of a co slice takes tiles b, b + nblk, ..."""
    tz, ty, tx = dw_tile(ci, stride)
    d, h, w = dims
    return [(z, y, x) for z in range(0, d, tz) for y in range(0, h, ty) for x in range(0, w, tx)]


def dw_ntiles(dims, ci: int, stride: int = 1) -> int:
    """``len(dw_tiles(dims, ci, stride))``, without listing them."""
    return math.prod(-(-n // t) for n, t in zip(dims, dw_tile(ci, stride)))


def dw_tap_offset(tap: int, ci: int, stride: int = 1) -> int:
    """Halo voxel offset of tap (dz, dy, dx) = (tap // 9, tap // 3 % 3,
    tap % 3): the tap's A is the halo read that many voxels further on."""
    if stride == 2:
        tz, ty, _ = dw_tile(ci, 2)
        return s2_tap_offset(tap, tz, ty)
    _, hy, hx = dw_halo(ci)
    return ((tap // 9) * hy + (tap // 3) % 3) * hx + tap % 3


def dw_krow_base(r: int, ci: int, stride: int = 1) -> int:
    """Halo voxel of k-row ``r`` (tile row (r // TY, r % TY)) at x 0."""
    tz, ty, _ = dw_tile(ci, stride)
    if stride == 2:
        return s2_row_base(r, tz, ty)
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
    """The jobs ``warp`` owns, at either stride: the tap column (dz, dx) =
    (warp // 3, warp % 3), its three dy taps and every m-tile (a window of
    A fragments slides down the k-rows of a z plane, halo row y + dy
    serving tap dy at k-row y at stride 1, row 2y + dy at stride 2).  The
    entry: both jobs, the warp taking the k-rows r = warp + 8 i instead."""
    if ci == 1:
        return [0, 1]
    dz, dx = divmod(warp, 3)
    mt_n = ci // 16
    return [(dz * 9 + dy * 3 + dx) * mt_n + mt for mt in range(mt_n) for dy in range(3)]


def dw_warp_krows(ci: int, warp: int, stride: int = 1) -> list[int]:
    tz, ty, _ = dw_tile(ci, stride)
    return list(range(warp, tz * ty, DWE_WARPS)) if ci == 1 else list(range(tz * ty))


def dw_blocks(dims, ci: int, co: int, n_sm: int, stride: int = 1) -> int:
    """Blocks per co slice (grid.x) for g's ``dims``: one wave over the
    card, no more than there are tiles; at stride 2 also few enough that
    the partials (``dw_partial_shape``) stay within half the bytes of the
    bf16 inputs x and g (at the flagship's level 2, 27 x 64 x 128 f32 per
    block against 20.6 MB of inputs)."""
    per_sm = DW_S2_BLOCKS_PER_SM[ci] if stride == 2 else DW_BLOCKS_PER_SM[ci]
    nblk = min(dw_ntiles(dims, ci, stride), per_sm * n_sm // (co // dw_nb(ci, stride)))
    if stride == 2:
        in_bytes = 2 * (8 * ci + co) * math.prod(dims)
        nblk = min(nblk, in_bytes // 2 // (27 * ci * co * 4))
    return max(1, nblk)


def dw_partial_shape(nblk: int, ci: int, co: int) -> tuple[int, int, int, int]:
    """The per-block partial sums, added over blocks in order into dW."""
    return nblk, 27, ci, co
