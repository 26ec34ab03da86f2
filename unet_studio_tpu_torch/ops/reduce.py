"""K2: per-channel reductions of a channels-last volume, with the plain
PyTorch twin.  So far the ``sum_sq`` mode of the JAX package's lane
reduction (unet_studio_tpu/ops/packed.py ``_lane_reduce_kernel``,
``lane_sum_sq``); its ``max`` and ``norm_bwd`` modes come with training.

The wrapper runs the twin when the tensor lies on the CPU and launches
the CUDA kernel (``csrc/reduce.cu``) when it lies on a card, where it
raises on what the kernel does not take.  The kernel's atomics change
the order of the sum from run to run: it agrees with the twin to f32
rounding of a long sum, not bitwise.
"""

from __future__ import annotations

import torch

from . import _cuda


def channel_sum_sq_plain(x: torch.Tensor) -> torch.Tensor:
    """(2, C) f32: per-channel sum and sum of squares over all voxels."""
    flat = x.reshape(-1, x.shape[-1]).float()
    return torch.stack([flat.sum(0), (flat * flat).sum(0)])


def channel_sum_sq(x: torch.Tensor) -> torch.Tensor:
    """K2 ``sum_sq``: (2, C) f32 per-channel sum and sum of squares of a
    (..., C) channels-last tensor, in one read."""
    if x.device.type == "cpu":
        return channel_sum_sq_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_sum_sq: tensor on {x.device}, expected cuda or cpu")
    if x.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"channel_sum_sq: dtype {x.dtype} not in (float32, bfloat16)")
    c = x.shape[-1]
    if c & (c - 1) or not 8 <= c <= 1024:
        raise ValueError(f"channel_sum_sq: C={c} must be a power of two in [8, 1024]")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("channel_sum_sq: input must be contiguous and 16-byte aligned")
    out = torch.zeros((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _cuda.lib().unet_channel_sum_sq(
            x.data_ptr(), x.numel() // c, c, out.data_ptr(),
            _cuda.DTYPE_CODES[x.dtype], _cuda.stream_ptr(x),
        )
    _cuda.check(rc, "channel_sum_sq")
    channel_sum_sq.launches += 1
    return out


channel_sum_sq.launches = 0
