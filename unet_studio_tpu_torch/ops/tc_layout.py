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
