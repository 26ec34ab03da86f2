"""K2: the reductions of the JAX package's lane-reduce kernel
(unet_studio_tpu/ops/packed.py ``_lane_reduce_kernel``), in all of its
modes, with their plain PyTorch twins:

- per channel of a channels-last volume: ``sum_sq`` (``lane_sum_sq``),
  the instance norm's statistics, and the two modes the JAX package
  defines but never calls, ``sum`` (``lane_sum``) and ``sqdiff``
  (``lane_sqdiff``);
- ``norm_bwd`` (``norm_bwd_sums``), the two sums of the norm's backward;
- ``max`` (``lane_max``) over a whole volume of any shape: the peak that
  scales the augmentation's packed image + label warp.

Each wrapper runs its twin when the tensor lies on the CPU and launches
the CUDA kernel (``csrc/reduce.cu``) when it lies on a card, where it
raises on what the kernel does not take.  A launch is one ctypes call and
one kernel: it writes every value of its output, which the wrapper
allocates uninitialised (``torch.empty`` launches nothing).  The
per-block partial sums go to a scratch buffer, and the last block is
found through a ticket word; both belong to the launch's (card, stream)
and every launch on that stream reuses them (launches on one stream run
in order, and each writes its partials before its last block reads
them), so launches on two streams may overlap in time.  The kernels sum
in a fixed order (per block, then the blocks in order), so a result is
bitwise the same from run to run; it agrees with the twin to f32
rounding of a long sum.  ``max`` is exact.
"""

from __future__ import annotations

import torch

from . import _cuda


def channel_sum_sq_plain(x: torch.Tensor) -> torch.Tensor:
    """(2, C) f32: per-channel sum and sum of squares over all voxels."""
    flat = x.reshape(-1, x.shape[-1]).float()
    return torch.stack([flat.sum(0), (flat * flat).sum(0)])


def norm_bwd_sums_plain(g, x, mean, inv) -> torch.Tensor:
    """(2, C) f32: per-channel sum of g and of g * (x - mean) * inv."""
    c = x.shape[-1]
    gf, xf = g.reshape(-1, c).float(), x.reshape(-1, c).float()
    return torch.stack([gf.sum(0), (gf * (xf - mean.float()) * inv.float()).sum(0)])


def channel_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """(C,) f32: per-channel sum over all voxels."""
    return x.reshape(-1, x.shape[-1]).float().sum(0)


def channel_sqdiff_plain(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """(C,) f32: per-channel sum of (x - mean)^2, ``mean`` rounded to x's
    dtype first as the TPU kernel takes it."""
    m = mean.to(device=x.device, dtype=x.dtype).float()
    return (x.reshape(-1, x.shape[-1]).float() - m).square().sum(0)


def volume_max_plain(x: torch.Tensor) -> torch.Tensor:
    """0-d f32: max(0, max(x)), the TPU kernel's zero-initialised max."""
    return x.float().max().clamp_min(0.0)


def _check_dense(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, expected cuda or cpu")
    if x.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not in (float32, bfloat16)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be contiguous and 16-byte aligned")


def _check_volume(x: torch.Tensor, name: str) -> int:
    _check_dense(x, name)
    c = x.shape[-1]
    if c & (c - 1) or not 8 <= c <= 1024:
        raise ValueError(f"{name}: C={c} must be a power of two in [8, 1024]")
    return c


# moments modes of csrc/reduce.cu (rows of the output)
_SUM, _SUM_SQ, _SQDIFF = 0, 1, 2
# RED_MAX_BLOCKS of csrc/reduce.cu: the most blocks, so partials, per launch
_MAX_BLOCKS = 1024
# per (card index, raw stream handle): the partial-sum scratch, grown when a
# launch needs more, and the ticket (one word, 0 at allocation; the kernels
# leave it 0 after every launch)
_scratch: dict[tuple[int, int], torch.Tensor] = {}
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _partials(x: torch.Tensor, rows: int, c: int) -> tuple[int, int]:
    """Addresses of the scratch for ``_MAX_BLOCKS`` partial (rows, C) sums
    and of the ticket of ``x``'s card and current stream."""
    key = (x.device.index, _cuda.stream_ptr(x))
    n = _MAX_BLOCKS * rows * c
    buf = _scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = _scratch[key] = torch.empty(n, dtype=torch.float32, device=x.device)
    ticket = _tickets.get(key)
    if ticket is None:
        ticket = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=x.device)
    return buf.data_ptr(), ticket.data_ptr()


def _moments(x: torch.Tensor, mode: int, mean: torch.Tensor | None, name: str) -> torch.Tensor:
    """(2, C) for ``_SUM_SQ``, else (C,)."""
    c = _check_volume(x, name)
    rows = 2 if mode == _SUM_SQ else 1
    out = torch.empty((2, c) if rows == 2 else (c,), dtype=torch.float32, device=x.device)
    with _cuda.on_device(x):
        rc = _cuda.lib().unet_channel_moments(
            x.data_ptr(), _cuda.ptr(mean), x.numel() // c, c, mode,
            *_partials(x, rows, c), out.data_ptr(), _cuda.DTYPE_CODES[x.dtype],
            _cuda.stream_ptr(x),
        )
    _cuda.check(rc, name)
    return out


def channel_sum_sq(x: torch.Tensor) -> torch.Tensor:
    """K2 ``sum_sq``: (2, C) f32 per-channel sum and sum of squares of a
    (..., C) channels-last tensor, in one read."""
    if x.device.type == "cpu":
        return channel_sum_sq_plain(x)
    out = _moments(x, _SUM_SQ, None, "channel_sum_sq")
    channel_sum_sq.launches += 1
    return out


def channel_sum(x: torch.Tensor) -> torch.Tensor:
    """K2 ``sum``: (C,) f32 per-channel sum of a (..., C) channels-last
    tensor."""
    if x.device.type == "cpu":
        return channel_sum_plain(x)
    out = _moments(x, _SUM, None, "channel_sum")
    channel_sum.launches += 1
    return out


def channel_sqdiff(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """K2 ``sqdiff``: (C,) f32 per-channel sum of (x - mean)^2 of a
    (..., C) channels-last tensor and a (C,) ``mean``, which is rounded to
    x's dtype first, as the TPU kernel takes it."""
    if x.device.type == "cpu":
        return channel_sqdiff_plain(x, mean)
    c = x.shape[-1]
    if mean.shape != (c,):
        raise ValueError(f"channel_sqdiff: mean must be ({c},)")
    m = mean.to(device=x.device, dtype=x.dtype).float().contiguous()
    out = _moments(x, _SQDIFF, m, "channel_sqdiff")
    channel_sqdiff.launches += 1
    return out


def volume_max(x: torch.Tensor) -> torch.Tensor:
    """K2 ``max``: 0-d f32 max(0, max(x)) over a whole volume of any shape
    (the TPU kernel's zero-initialised accumulator: an all-negative volume
    gives 0)."""
    if x.device.type == "cpu":
        return volume_max_plain(x)
    _check_dense(x, "volume_max")
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with _cuda.on_device(x):
        rc = _cuda.lib().unet_volume_max(x.data_ptr(), x.numel(), *_partials(x, 1, 1),
                                         out.data_ptr(), _cuda.DTYPE_CODES[x.dtype],
                                         _cuda.stream_ptr(x))
    _cuda.check(rc, "volume_max")
    volume_max.launches += 1
    return out


def norm_bwd_sums(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                  inv: torch.Tensor) -> torch.Tensor:
    """K2 ``norm_bwd``: (2, C) f32 per-channel sum of ``g`` and of
    ``g * (x - mean) * inv`` for channels-last ``g`` and ``x`` of one
    shape and dtype and f32 ``(C,)`` ``mean`` and ``inv``, in one read of
    the two volumes (the instance norm's backward)."""
    if g.device.type == "cpu":
        return norm_bwd_sums_plain(g, x, mean, inv)
    c = _check_volume(g, "norm_bwd_sums")
    _check_volume(x, "norm_bwd_sums")
    if x.shape != g.shape or x.dtype != g.dtype:
        raise ValueError("norm_bwd_sums: g and x differ in shape or dtype")
    mean = mean.to(device=g.device, dtype=torch.float32).contiguous()
    inv = inv.to(device=g.device, dtype=torch.float32).contiguous()
    if mean.shape != (c,) or inv.shape != (c,):
        raise ValueError(f"norm_bwd_sums: mean and inv must be ({c},)")
    out = torch.empty((2, c), dtype=torch.float32, device=g.device)
    with _cuda.on_device(g):
        rc = _cuda.lib().unet_channel_norm_bwd(
            g.data_ptr(), x.data_ptr(), mean.data_ptr(), inv.data_ptr(), g.numel() // c, c,
            *_partials(g, 2, c), out.data_ptr(), _cuda.DTYPE_CODES[g.dtype],
            _cuda.stream_ptr(g),
        )
    _cuda.check(rc, "norm_bwd_sums")
    norm_bwd_sums.launches += 1
    return out


WRAPPERS = (channel_sum_sq, channel_sum, channel_sqdiff, norm_bwd_sums, volume_max)
for _fn in WRAPPERS:
    _fn.launches = 0
