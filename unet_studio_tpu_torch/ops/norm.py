"""The training instance norm: ``InstanceNormTrain``, the counterpart of
the JAX package's ``packed.instance_norm_packed`` (a custom VJP,
unet_studio_tpu/ops/packed.py), and its plain twin.

Forward: per-channel statistics from one K2 ``sum_sq`` read, variance
E[x^2] - mean^2 clamped at 0 (as the packed route; the JAX package's XLA
route takes two passes, so the two agree to f32 rounding, not bitwise),
then ``x*a + b`` in the compute dtype.  Only ``x`` and the f32 ``(C,)``
mean and inv are saved.  Backward: the sums of g and g*xhat from one K2
``norm_bwd`` read, then ``dx = coef*(g - mean(g) - xhat*mean(g*xhat))``
in the compute dtype with ``xhat`` built from mean and inv cast to it;
the scale and bias gradients in f32.  Layout: channels-last ``(D, H, W,
C)``, one item.
"""

from __future__ import annotations

import torch

from .reduce import channel_sum_sq, channel_sum_sq_plain, norm_bwd_sums


def norm_stats(st: torch.Tensor, n_vox: int, eps: float = 1e-5):
    """(mean, inv) f32 ``(C,)`` from (2, C) sum / sum of squares."""
    mean = st[0] / n_vox
    var = torch.clamp_min(st[1] / n_vox - mean * mean, 0.0)
    return mean, torch.rsqrt(var + eps)


def _apply(x, scale, bias, mean, inv):
    s = scale.float()
    a = (inv * s).to(x.dtype)
    b = (bias.float() - mean * inv * s).to(x.dtype)
    return x * a + b


class InstanceNormTrain(torch.autograd.Function):
    """InstanceNorm3d(affine), eps 1e-5, on one ``(D, H, W, C)`` item."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        n = x.numel() // x.shape[-1]
        mean, inv = norm_stats(channel_sum_sq(x), n)
        ctx.save_for_backward(x, scale, mean, inv)
        return _apply(x, scale, bias, mean, inv)

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, inv = ctx.saved_tensors
        dt = x.dtype
        n = x.numel() // x.shape[-1]
        g = g.to(dt).contiguous()
        sums = norm_bwd_sums(g, x, mean, inv)
        g_mean, gx_mean = sums[0] / n, sums[1] / n
        xhat = (x - mean.to(dt)) * inv.to(dt)
        coef = (inv * scale.float()).to(dt)
        dx = coef * (g - g_mean.to(dt) - xhat * gx_mean.to(dt))
        return dx, gx_mean * n, g_mean * n


def instance_norm_train_plain(x, scale, bias):
    """The twin: the same statistics and affine under plain autograd."""
    mean, inv = norm_stats(channel_sum_sq_plain(x), x.numel() // x.shape[-1])
    return _apply(x, scale, bias, mean, inv)
