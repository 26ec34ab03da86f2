"""The plain reference U-Net, written from the architecture DSL's layer
equations (UNet-Studio's unet.cpp; the layers of the program's
``models/unet3d.py`` ``forward``): plain ``torch.nn.functional`` layers on
(N, C, D, H, W) tensors, in float32, with no kernel, no fused norm and no
packed layout.

- ``conv``: ``F.conv3d`` (pad (ks - 1) // 2), ``conv_trans``:
  ``F.conv_transpose3d`` (ks 2, stride 2), their weight gradients summed
  tap by tap by matmuls (``_Conv``); weights in the torch layouts of the
  ``.nz`` file, keyed ``"{module}.{layer}.{w|b}"``.
- ``norm``: InstanceNorm3d(affine), eps 1e-5, two-pass statistics.
- leaky ReLU, slope 0.01, with gradient 1 at 0 (``jax.nn.leaky_relu``'s,
  which the program's training forward keeps).
- The deep-supervision heads: every level's head in training, level 0's
  alone at inference.

``precision="fp8"`` is the control: each conv's input and weight, and in
the backward the gradient it receives, are rounded to float8 e4m3 with
one scale per tensor (its absolute maximum to 448), as a float8 training
feeds both of its GEMMs: the step a later change would be tempted to take
below bfloat16.

The caller sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False (``no_tf32``) so that
float32 is float32 on the card.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .dsl import LayerSpec, UNetSpec

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 convs and matmuls in float32 on the card, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def param_order(spec: UNetSpec) -> list[tuple[str, LayerSpec, str]]:
    """(key, layer, "w" | "b") in the ``.nz`` order."""
    out = []
    for mod_name, layers in spec.module_names():
        for i, layer in enumerate(layers):
            if layer.has_params:
                out.append((f"{mod_name}.{i}.w", layer, "w"))
                out.append((f"{mod_name}.{i}.b", layer, "b"))
    return out


def param_shape(layer: LayerSpec, which: str) -> tuple[int, ...]:
    if which == "b":
        return (layer.out_c,)
    if layer.kind == "conv":
        return (layer.out_c, layer.in_c, layer.ks, layer.ks, layer.ks)
    if layer.kind == "conv_trans":
        return (layer.in_c, layer.out_c, 2, 2, 2)
    return (layer.in_c,)


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale (its absolute maximum to
    448), back in x's dtype."""
    s = FP8_MAX / x.detach().abs().amax().float().clamp_min(1e-30)
    return ((x.float() * s).to(torch.float8_e4m3fn).float() / s).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """``_fp8_round``; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Conv(torch.autograd.Function):
    """``F.conv3d`` (pad (ks - 1) // 2), or with ``trans``
    ``F.conv_transpose3d`` (ks 2, stride 2), whose weight gradient is
    summed tap by tap, as one matmul over the voxels per tap:
    dW[:, :, a, b, c] = g x_abc^T, with x_abc the input that tap (a, b, c) sees
    (cuDNN's float32 weight gradient of a 3-D conv takes seconds at these
    sizes).  The input gradient is cuDNN's."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int, trans: bool, fp8: bool):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, trans, fp8)
        if trans:
            return F.conv_transpose3d(x, w, b, stride=2)
        return F.conv3d(x, w, b, stride=stride, padding=(w.shape[-1] - 1) // 2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, trans, fp8 = ctx.conf
        g = _fp8_round(g) if fp8 else g.contiguous()
        k = w.shape[-1]
        if trans:
            dw = torch.empty_like(w)
            dx = F.conv3d(g, w, None, stride=2) if ctx.needs_input_grad[0] else None
            xf = x.movedim(1, 0).reshape(x.shape[1], -1)
            for a in range(2):
                for b in range(2):
                    for c in range(2):
                        gs = g[:, :, a::2, b::2, c::2].movedim(1, 0).reshape(g.shape[1], -1)
                        dw[:, :, a, b, c] = xf @ gs.T
        else:
            pad = (k - 1) // 2
            dx = (torch.nn.grad.conv3d_input(x.shape, w, g, stride=stride, padding=pad)
                  if ctx.needs_input_grad[0] else None)
            dw = sum(_dw_s1(xn, gn, k) if stride == 1 else _dw_strided(xn, gn, k, stride)
                     for xn, gn in zip(x, g))
        return dx, dw, g.sum(dim=(0, 2, 3, 4)), None, None, None


def _dw_s1(x, g, k: int):
    """The weight gradient of a stride-1 conv of one item, ``x`` (Ci, D, H,
    W), ``g`` (Co, D, H, W): the padded input flattened, each tap's input
    is the same flat buffer shifted by the tap's offset, read in place; g
    is laid on the padded grid (zeros outside), so that the positions past
    a row's end add nothing."""
    p = (k - 1) // 2
    ci, co = x.shape[0], g.shape[0]
    d, h, w = g.shape[1:]
    hp, wp = h + 2 * p, w + 2 * p
    sz, vol = hp * wp, (d + 2 * p) * hp * wp
    buf = x.new_zeros(ci * vol + 2 * p * sz + 2 * p * wp + 2 * p)
    buf[:ci * vol].view(ci, d + 2 * p, hp, wp)[:, p:p + d, p:p + h, p:p + w] = x
    gp = g.new_zeros(co, d, hp, wp)
    gp[:, :, :h, :w] = g
    gf = gp.view(co, -1)
    out = g.new_empty(co, ci, k, k, k)
    for a in range(k):
        for b in range(k):
            for c in range(k):
                xs = buf.as_strided((ci, d * sz), (vol, 1), a * sz + b * wp + c)
                out[:, :, a, b, c] = gf @ xs.T
    return out


def _dw_strided(x, g, k: int, stride: int):
    """The weight gradient of a strided conv of one item: each tap's input
    view copied out, then one matmul over the voxels."""
    p = (k - 1) // 2
    xp = F.pad(x, (p,) * 6)
    d, h, w = g.shape[1:]
    gf = g.reshape(g.shape[0], -1)
    out = g.new_empty(g.shape[0], x.shape[0], k, k, k)
    for a in range(k):
        for b in range(k):
            for c in range(k):
                xs = xp[:, a:a + stride * (d - 1) + 1:stride, b:b + stride * (h - 1) + 1:stride,
                        c:c + stride * (w - 1) + 1:stride]
                out[:, :, a, b, c] = gf @ xs.reshape(x.shape[0], -1).T
    return out


class _LeakyReLU(torch.autograd.Function):
    """Slope 0.01; gradient 1 where the output is >= 0."""

    @staticmethod
    def forward(ctx, x):
        y = F.leaky_relu(x, 0.01)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y >= 0, g, g * 0.01)


def _act(x, name):
    if name is None:
        return x
    if name == "leaky_relu":
        return _LeakyReLU.apply(x)
    if name == "relu":
        return torch.relu(x)
    if name == "elu":
        return F.elu(x)
    raise ValueError(name)


def _instance_norm(x, scale, bias, eps=1e-5):
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale.view(1, -1, 1, 1, 1) + \
        bias.view(1, -1, 1, 1, 1)


def _level(params, mod_name, layers, x, precision):
    q = _Fp8.apply if precision == "fp8" else (lambda t: t)
    for i, layer in enumerate(layers):
        if isinstance(x, tuple):
            x = torch.cat(x, dim=1)  # decoder entry: (skip, up)
        w = params.get(f"{mod_name}.{i}.w")
        b = params.get(f"{mod_name}.{i}.b")
        if layer.kind == "conv":
            x = _Conv.apply(q(x), q(w), b, layer.stride, False, precision == "fp8")
        elif layer.kind == "conv_trans":
            x = _Conv.apply(q(x), q(w), b, 2, True, precision == "fp8")
        elif layer.kind == "norm":
            x = _instance_norm(x, w, b)
        elif layer.kind == "max_pool":
            x = F.max_pool3d(x, 2, 2)
        elif layer.kind == "upsample":
            x = x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
        else:
            raise NotImplementedError(f"layer kind {layer.kind}")
        x = _act(x, layer.act)
    return x


def forward(spec: UNetSpec, params: dict, x: torch.Tensor, *, precision: str = "f32",
            heads: str = "all") -> list:
    """``x`` (N, D, H, W, in_count) -> per-level logits (N, D_l, H_l, W_l,
    out_count) f32; with ``heads="level0"`` only level 0's (the others
    None)."""
    if precision not in ("f32", "fp8"):
        raise ValueError(precision)
    t = x.float().permute(0, 4, 1, 2, 3)
    n_enc = len(spec.encoders)
    skips = []
    for level in range(n_enc):
        t = _level(params, f"encode{level}", spec.encoders[level], t, precision)
        if level < n_enc - 1:
            skips.append(t)
    results: list = [None] * len(spec.decoders)
    for level in range(n_enc - 2, -1, -1):
        t = _level(params, f"decode{level}", spec.decoders[level], (skips[level], t), precision)
        skips[level] = None
        if spec.heads[level] and (heads == "all" or level == 0):
            r = _level(params, f"output{level}", spec.heads[level], t, precision)
            results[level] = r.permute(0, 2, 3, 4, 1).contiguous()
        if spec.tails[level]:
            t = _level(params, f"decode_tail{level}", spec.tails[level], t, precision)
    return results
