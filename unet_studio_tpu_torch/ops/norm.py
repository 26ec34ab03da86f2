"""The training instance norm, the counterpart of the JAX package's
``packed.instance_norm_packed`` (a custom VJP,
unet_studio_tpu/ops/packed.py): ``InstanceNormActTrain``, the norm and
the leaky ReLU that may follow it in one Function on hand-written
kernels, which the training forward runs; ``InstanceNormTrain``, the
norm alone with its elementwise steps as PyTorch ops, the reference the
kernels are held to bit for bit; and the plain twin.

Forward: per-channel statistics from one K2 ``sum_sq`` read, variance
E[x^2] - mean^2 clamped at 0 (as the packed route; the JAX package's XLA
route takes two passes, so the two agree to f32 rounding, not bitwise),
then ``x*a + b`` in the compute dtype.  Only ``x`` and the f32 ``(C,)``
mean and inv are saved.  Backward: the sums of g and g*xhat from one K2
``norm_bwd`` read, then ``dx = coef*(g - mean(g) - xhat*mean(g*xhat))``
in the compute dtype with ``xhat`` built from mean and inv cast to it;
the scale and bias gradients in f32.  Layout: channels-last ``(D, H, W,
C)``, one item.

``InstanceNormActTrain`` computes what ``InstanceNormTrain`` followed by
``ops/conv.py`` ``_LeakyReLU`` (or nothing) computes, bit for bit, in
fewer passes over the volume: ``norm_act`` reads x and writes act(x*a +
b) in one pass; the backward's K2 read (``norm_act_bwd`` after a leaky
ReLU, which forms its input gradient g' from g and x, y not being saved;
``norm_bwd`` without) sums g', then ``norm_act_dx`` reads g and x and
writes dx.  On the CPU the wrappers run their twins, which are that
composition.
"""

from __future__ import annotations

import torch

from . import _cuda
from .conv import activation, activation_train, leaky_grad
from .reduce import (
    channel_sum_sq,
    channel_sum_sq_plain,
    channel_sums2,
    launch_channels,
    norm_bwd_sums,
    norm_bwd_sums_plain,
)

# the activations InstanceNormActTrain takes
NORM_ACTS = (None, "leaky_relu")


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


def norm_act_plain(x, scale, bias, mean, inv, act):
    """Twin of ``norm_act``: the norm's affine, then the activation."""
    return activation(_apply(x, scale, bias, mean, inv), act)


def _leaky_grad_of(g, x, scale, bias, mean, inv):
    """g' = ``_LeakyReLU``'s input gradient, its output recomputed from x."""
    return leaky_grad(g, norm_act_plain(x, scale, bias, mean, inv, "leaky_relu"))


def norm_act_bwd_sums_plain(g, x, mean, inv, scale, bias) -> torch.Tensor:
    """Twin of ``norm_act_bwd_sums``: ``norm_bwd_sums_plain`` of g'."""
    return norm_bwd_sums_plain(_leaky_grad_of(g, x, scale, bias, mean, inv), x, mean, inv)


def norm_act_dx_plain(g, x, scale, bias, mean, inv, means, act):
    """Twin of ``norm_act_dx``: g' (``g`` itself when ``act`` is None),
    then the norm's input gradient from it, ``means`` the (2, C) f32
    mean of g' and of g' * xhat."""
    dt = x.dtype
    if act:
        g = _leaky_grad_of(g, x, scale, bias, mean, inv)
    xhat = (x - mean.to(dt)) * inv.to(dt)
    coef = (inv * scale.float()).to(dt)
    return coef * (g - means[0].to(dt) - xhat * means[1].to(dt))


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
        n = x.numel() // x.shape[-1]
        g = g.to(x.dtype).contiguous()
        means = norm_bwd_sums(g, x, mean, inv) / n
        dx = norm_act_dx_plain(g, x, scale, None, mean, inv, means, None)
        return dx, means[1] * n, means[0] * n


def instance_norm_train_plain(x, scale, bias):
    """The twin: the same statistics and affine under plain autograd."""
    mean, inv = norm_stats(channel_sum_sq_plain(x), x.numel() // x.shape[-1])
    return _apply(x, scale, bias, mean, inv)


def _act_code(act, name: str) -> tuple[int]:
    if act not in NORM_ACTS:
        raise ValueError(f"{name}: activation {act!r} has no in-kernel form")
    return (_cuda.ACT_CODES[act],)


def norm_act(x, scale, bias, mean, inv, act):
    """act(x*a + b) of a channels-last ``x`` in its dtype, a and b the
    norm's affine from the f32 ``(C,)`` ``scale``, ``bias``, ``mean`` and
    ``inv`` and ``act`` None or "leaky_relu": one read of x, one write."""
    if x.device.type == "cpu":
        return norm_act_plain(x, scale, bias, mean, inv, act)
    code = _act_code(act, "norm_act")
    out = launch_channels("unet_norm_act", "norm_act", (x,), (mean, inv, scale, bias),
                          lambda c: code, torch.empty_like(x))
    norm_act.launches += 1
    return out


def norm_act_bwd_sums(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K2 ``norm_act_bwd``: ``norm_bwd_sums`` of g' = where(y >= 0, g,
    g * 0.01) for ``g`` the gradient of ``norm_act``'s leaky ReLU output
    y, which the kernel recomputes from ``x`` and the f32 ``(C,)``
    ``mean``, ``inv``, ``scale`` and ``bias``: one read of g and x, and
    g' never written."""
    if g.device.type == "cpu":
        return norm_act_bwd_sums_plain(g, x, mean, inv, scale, bias)
    out = channel_sums2("unet_channel_norm_act_bwd", "norm_act_bwd_sums", g, x,
                        (mean, inv, scale, bias))
    norm_act_bwd_sums.launches += 1
    return out


def norm_act_dx(g, x, scale, bias, mean, inv, means, act):
    """The input gradient of the norm and activation from ``g``, the
    gradient of their output, ``x``, and ``means``, the (2, C) f32 mean of
    g' and of g' * xhat over the voxels: one read of g and x, one write."""
    if x.device.type == "cpu":
        return norm_act_dx_plain(g, x, scale, bias, mean, inv, means, act)
    code = _act_code(act, "norm_act_dx")
    out = launch_channels("unet_norm_act_dx", "norm_act_dx", (g, x),
                          (mean, inv, scale, bias, means), lambda c: code, torch.empty_like(x))
    norm_act_dx.launches += 1
    return out


class InstanceNormActTrain(torch.autograd.Function):
    """``InstanceNormTrain`` then ``act`` (None or "leaky_relu", the
    latter with ``_LeakyReLU``'s gradient, 1 at 0), on one ``(D, H, W, C)``
    item: the same statistics, then ``norm_act``; saves what
    ``InstanceNormTrain`` saves, and the bias.  Backward: K2
    ``norm_act_bwd`` (``norm_bwd`` without an activation), then
    ``norm_act_dx``."""

    @staticmethod
    def forward(ctx, x, scale, bias, act):
        n = x.numel() // x.shape[-1]
        mean, inv = norm_stats(channel_sum_sq(x), n)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.act = act
        return norm_act(x, scale, bias, mean, inv, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean, inv = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        g = g.to(x.dtype).contiguous()
        if ctx.act:
            sums = norm_act_bwd_sums(g, x, mean, inv, scale, bias)
        else:
            sums = norm_bwd_sums(g, x, mean, inv)
        means = sums / n
        dx = norm_act_dx(g, x, scale, bias, mean, inv, means, ctx.act)
        return dx, means[1] * n, means[0] * n, None


def instance_norm_act_train(x, scale, bias, act):
    """The training norm of a layer the kernels take, and its activation:
    ``InstanceNormActTrain`` takes a leaky ReLU (or none); relu and elu
    follow it as ``activation_train``."""
    if act in NORM_ACTS:
        return InstanceNormActTrain.apply(x, scale, bias, act)
    return activation_train(InstanceNormActTrain.apply(x, scale, bias, None), act)


WRAPPERS = (norm_act, norm_act_bwd_sums, norm_act_dx)
for _fn in WRAPPERS:
    _fn.launches = 0
