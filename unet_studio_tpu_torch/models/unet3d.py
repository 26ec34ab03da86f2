"""The 3D U-Net in PyTorch: parameter bookkeeping, the plain forward, the
inference forward through the CUDA kernels with deferred instance norm,
and the training forward through the kernels' autograd Functions (the
counterpart of unet_studio_tpu/models/unet3d.py).

* Activations are channels-last ``(N, D, H, W, C)`` at ``forward`` and
  ``(D, H, W, C)`` inside ``forward_fused``, as in the JAX package.
* Parameters are a flat ``dict[str, Tensor]`` keyed
  ``"{module}.{layer_idx}.{w|b}"`` in the torch layouts of the ``.nz``
  file: conv ``(O, I, k, k, k)``, conv_trans ``(I, O, 2, 2, 2)``, norm
  ``(C,)``.  ``UNet3d`` is an ``nn.Module`` whose ``parameters()`` order
  is the ``.nz`` positional ``tensor0..tensorN`` order.
* ``norm`` is InstanceNorm3d(affine) (eps 1e-5, f32 statistics);
  ``bnorm`` is BatchNorm3d(eps=0) with identity running statistics at
  inference (the reference resets them, unet.cpp:7-22).
* ``forward`` returns per-level deep-supervision logits, ``results[0]``
  full resolution (unet.cpp:168-193).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import conv as K
from ..ops.conv import activation, activation_train, dhwc, ncdhw
from ..ops.losses import ChannelLeading
from ..ops.norm import NORM_ACTS, instance_norm_act_train, instance_norm_train_plain
from ..ops.reduce import channel_sum_sq, channel_sum_sq_plain
from ..utils.device import resolve_device
from ..utils.profiling import count
from .dsl import LayerSpec, UNetSpec, parse_architecture

# ---------------------------------------------------------------------------
# parameter bookkeeping
# ---------------------------------------------------------------------------


def param_order(spec: UNetSpec) -> list[tuple[str, LayerSpec, str]]:
    """(param_key, layer, "w"|"b") in LibTorch parameters() order: one
    entry per .nz ``tensorN`` record."""
    out = []
    for mod_name, layers in spec.module_names():
        for i, layer in enumerate(layers):
            if layer.has_params:
                out.append((f"{mod_name}.{i}.w", layer, "w"))
                out.append((f"{mod_name}.{i}.b", layer, "b"))
    return out


def torch_param_shape(layer: LayerSpec, which: str) -> tuple[int, ...]:
    if which == "b":
        return (layer.out_c,)
    if layer.kind == "conv":
        return (layer.out_c, layer.in_c, layer.ks, layer.ks, layer.ks)
    if layer.kind == "conv_trans":
        return (layer.in_c, layer.out_c, 2, 2, 2)
    return (layer.in_c,)  # norm scale


def _init_shape(layer: LayerSpec, which: str) -> tuple[int, ...]:
    """The shape the JAX package draws its initial weights in (DHWIO
    conv, (I,2,2,2,O) conv_trans): drawing in that shape from the same
    seed gives identical weights."""
    if which == "b":
        return (layer.out_c,)
    if layer.kind == "conv":
        return (layer.ks, layer.ks, layer.ks, layer.in_c, layer.out_c)
    if layer.kind == "conv_trans":
        return (layer.in_c, 2, 2, 2, layer.out_c)
    return (layer.in_c,)


def to_torch_layout(layer: LayerSpec, which: str, arr: np.ndarray) -> np.ndarray:
    """A weight in the JAX package's layout -> the torch layout (a copy)."""
    arr = np.array(arr, np.float32)
    if which == "b":
        return arr
    if layer.kind == "conv":
        return np.ascontiguousarray(arr.transpose(4, 3, 0, 1, 2))
    if layer.kind == "conv_trans":
        return np.ascontiguousarray(arr.transpose(0, 4, 1, 2, 3))
    return arr


def init_params(spec: UNetSpec, seed: int = 0) -> dict[str, np.ndarray]:
    """Initial parameters (numpy, torch layout) matching torch's module
    defaults: conv/conv_trans U(+-1/sqrt(fan_in)) for weight and bias;
    norm scale 1, bias 0.  The same draws as the JAX package's
    ``init_params`` for the same seed, so both start from one network."""
    params: dict[str, np.ndarray] = {}
    rng = np.random.default_rng(np.random.SeedSequence(entropy=seed))
    for name, layer, which in param_order(spec):
        shape = _init_shape(layer, which)
        if layer.kind in ("norm", "bnorm"):
            params[name] = (
                np.ones(shape, np.float32) if which == "w" else np.zeros(shape, np.float32)
            )
            continue
        if layer.kind == "conv":
            fan_in = layer.in_c * layer.ks**3
        else:  # conv_trans: torch computes fan_in on (I,O,k,k,k) as O*k^3
            fan_in = layer.out_c * 8
        bound = 1.0 / math.sqrt(fan_in)
        params[name] = to_torch_layout(
            layer, which, rng.uniform(-bound, bound, shape).astype(np.float32)
        )
    return params


def init_state(spec: UNetSpec) -> dict[str, np.ndarray]:
    """BatchNorm running statistics at identity (not stored in .nz)."""
    state: dict[str, np.ndarray] = {}
    for mod_name, layers in spec.module_names():
        for i, layer in enumerate(layers):
            if layer.kind == "bnorm":
                state[f"{mod_name}.{i}.mean"] = np.zeros(layer.in_c, np.float32)
                state[f"{mod_name}.{i}.var"] = np.ones(layer.in_c, np.float32)
    return state


def round_up_size(shape_xyz, multiple=32) -> tuple[int, int, int]:
    """Round each dim up to a multiple (train.cpp:1131)."""
    return tuple(int(-(-int(s) // multiple) * multiple) for s in shape_xyz)


# ---------------------------------------------------------------------------
# plain layers (N, C, D, H, W inside the plain forward)
# ---------------------------------------------------------------------------


def _moments(x32: torch.Tensor, dims, slab=None):
    """f32 mean and variance over ``dims`` (kept), in two passes.  Over a
    volume split into z-slabs (``slab``, ``parallel/spatial.py``) each
    pass's sums are added over the slabs: Σx gives the mean, then
    Σ(x - mean)^2 the variance."""
    if slab is None:
        mean = x32.mean(dim=dims, keepdim=True)
        return mean, (x32 - mean).square().mean(dim=dims, keepdim=True)
    n = math.prod(x32.shape[d] for d in dims) * slab.n
    mean = slab.psum(x32.sum(dim=dims, keepdim=True)) / n
    return mean, slab.psum((x32 - mean).square().sum(dim=dims, keepdim=True)) / n


def _in_stats(x: torch.Tensor, eps: float, slab=None):
    """Per-(sample, channel) mean and rsqrt(var+eps) in f32 over the
    spatial axes of an (N, C, D, H, W) tensor (``_moments``)."""
    mean, var = _moments(x.float(), (2, 3, 4), slab)
    return mean, torch.rsqrt(var.clamp_min(0.0) + eps)


def _instance_norm(x, scale, bias, eps=1e-5, slab=None):
    mean, inv = _in_stats(x, eps, slab)
    s = scale.float().view(1, -1, 1, 1, 1)
    a = (inv * s).to(x.dtype)
    b = (bias.float().view(1, -1, 1, 1, 1) - mean * inv * s).to(x.dtype)
    return x * a + b


def _batch_norm(x, scale, bias, mean, var, eps=0.0):
    v = lambda t: t.float().view(1, -1, 1, 1, 1)  # noqa: E731
    y = (x.float() - v(mean)) * torch.rsqrt(v(var) + eps) * v(scale) + v(bias)
    return y.to(x.dtype)


def _run_sequential(params, state, mod_name, layers, x, slab=None, train=False):
    """One level of the plain forward on (N, C, D, H, W).  ``slab``: this
    rank's z-slab of a volume split over ranks (``parallel/spatial.py``):
    each conv first takes its halo planes from the neighbouring slabs and
    pads only H and W, and the norms' statistics are summed over the
    slabs.  ``train``: the JAX package's gradients for leaky ReLU and
    batch statistics for ``bnorm``, as its ``forward(train=True)``."""
    act = activation_train if train else activation
    for i, layer in enumerate(layers):
        if isinstance(x, tuple):
            x = torch.cat(x, dim=1)  # decoder entry: (skip, up)
        w = params.get(f"{mod_name}.{i}.w")
        b = params.get(f"{mod_name}.{i}.b")
        if layer.kind == "conv":
            pad = (layer.ks - 1) // 2
            if slab is not None:
                # the output planes of this slab read `pad` planes below it
                # and ks - stride - pad above it (the slab starts on a
                # multiple of the stride)
                x = slab.halo(x, pad, max(0, layer.ks - layer.stride - pad))
                pad = (0, pad, pad)
            x = F.conv3d(x, w.to(x.dtype), b.to(x.dtype), stride=layer.stride, padding=pad)
        elif layer.kind == "conv_trans":
            x = F.conv_transpose3d(x, w.to(x.dtype), b.to(x.dtype), stride=2)
        elif layer.kind == "max_pool":
            x = F.max_pool3d(x, 2, 2)
        elif layer.kind == "upsample":
            x = x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
        elif layer.kind == "norm":
            x = _instance_norm(x, w, b, slab=slab)
        elif layer.kind == "bnorm":
            if train:
                mean, var = (v.flatten() for v in _moments(x.float(), (0, 2, 3, 4), slab))
            else:
                mean = torch.as_tensor(state.get(f"{mod_name}.{i}.mean", torch.zeros(layer.in_c)),
                                       device=x.device)
                var = torch.as_tensor(state.get(f"{mod_name}.{i}.var", torch.ones(layer.in_c)),
                                      device=x.device)
            x = _batch_norm(x, w, b, mean, var)
        x = act(x, layer.act)
    return x


def _level(run, x, remat: bool):
    """``run(x)`` for one level's input ``x``, a tensor or the decoder's
    (skip, up) pair.  ``remat`` checkpoints it (non-reentrant
    ``torch.utils.checkpoint``, the pair as two tensor arguments): only
    its inputs stay alive, and the backward reruns it, as
    ``jax.checkpoint`` does per level in the JAX package."""
    if not remat:
        return run(x)
    xs = x if isinstance(x, tuple) else (x,)
    return torch.utils.checkpoint.checkpoint(lambda *a: run(a if len(a) > 1 else a[0]), *xs,
                                             use_reentrant=False)


def _walk(spec: UNetSpec, run_level, x, head):
    """The U-Net's walk, the same for every forward: the encoders, each
    output but the deepest kept as a skip; then the decoders from the
    deepest up, each on its (skip, up) pair, releasing the skip, then its
    level's head through ``head(level, layers, t)`` (the logits, or None)
    and its tail.  ``run_level(name, layers, x)`` runs one module.
    Returns the per-level logits."""
    n_enc = len(spec.encoders)
    skips = []
    for level in range(n_enc):
        x = run_level(f"encode{level}", spec.encoders[level], x)
        if level < n_enc - 1:
            skips.append(x)
    results: list = [None] * len(spec.decoders)
    for level in range(n_enc - 2, -1, -1):
        x = run_level(f"decode{level}", spec.decoders[level], (skips[level], x))
        skips[level] = None
        if spec.heads[level]:
            results[level] = head(level, spec.heads[level], x)
        if spec.tails[level]:
            x = run_level(f"decode_tail{level}", spec.tails[level], x)
    return results


def forward(spec: UNetSpec, params: dict, x: torch.Tensor, *, state: dict | None = None,
            compute_dtype=torch.float32, slab=None, train: bool = False,
            remat: bool = False):
    """The plain forward (the JAX package's XLA route, ``forward``),
    inference unless ``train``.  ``x``: (N, D, H, W, in_count), or this
    rank's z-slab of it with ``slab`` (``parallel/spatial.py``).  Returns
    the per-level logits, each (N, D_l, H_l, W_l, out_count) float32.
    ``remat=True`` checkpoints each level (``_level``)."""
    state = state or {}

    def seq(name, layers, x):
        return _level(lambda v: _run_sequential(params, state, name, layers, v, slab, train),
                      x, remat)

    def head(level, layers, t):
        return seq(f"output{level}", layers, t).permute(0, 2, 3, 4, 1).float().contiguous()

    return _walk(spec, seq, x.to(compute_dtype).permute(0, 4, 1, 2, 3), head)


# ---------------------------------------------------------------------------
# the kernels' route, and the layers no kernel takes (D, H, W, C)
# ---------------------------------------------------------------------------


def _route(layer: LayerSpec, c: int, dhw, pair: bool = False) -> str | None:
    """The kernel that runs ``layer`` on a (D, H, W, c) input of spatial
    shape ``dhw`` in both kernel forwards: "dual", "s1", "entry", "s2",
    "trans" or "norm" (``ops/conv.py`` ``kernel_takes``), or None for
    plain PyTorch.  ``pair``: the input is a decoder entry's (skip, up)
    pair whose halves have one shape, c channels each; only the dual conv
    takes it whole."""
    conv3 = layer.kind == "conv" and layer.ks == 3
    if pair:
        op = "dual" if conv3 and layer.stride == 1 else None
    elif conv3 and layer.stride == 2:
        op = None if any(n % 2 for n in dhw) else "s2"
    elif conv3:
        op = "entry" if c == 1 else "s1"
    else:
        op = {"conv_trans": "trans", "norm": "norm"}.get(layer.kind)
    return op if op and K.kernel_takes(op, c, layer.out_c) else None


def _plain_layer(layer: LayerSpec, x, w, b):
    """A layer on a (D, H, W, C) tensor through plain PyTorch (cuDNN on a
    card), as the JAX package leaves the layers its kernels do not take
    to XLA."""
    if layer.kind == "upsample":
        return x.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    if layer.kind == "conv":
        y = F.conv3d(ncdhw(x), w.to(x.dtype), b.to(x.dtype), stride=layer.stride,
                     padding=(layer.ks - 1) // 2)
    elif layer.kind == "conv_trans":
        y = F.conv_transpose3d(ncdhw(x), w.to(x.dtype), b.to(x.dtype), stride=2)
    elif layer.kind == "max_pool":
        y = F.max_pool3d(ncdhw(x), 2, 2)
    elif layer.kind == "norm":
        y = _instance_norm(ncdhw(x), w, b)
    else:  # bnorm: the training forward takes batch statistics itself
        raise ValueError(f"no channels-last plain form of {layer.kind}")
    return dhwc(y).contiguous()


# ---------------------------------------------------------------------------
# inference forward through the kernels, with deferred instance norm
# ---------------------------------------------------------------------------
#
# The counterpart of the JAX package's packed forward with norm fusion
# (unet3d.py _run_level_packed(fuse=True), forward_packed).  A norm layer
# touches no volume data: it folds the statistics of its input (from the
# producing conv's epilogue, or from one K2 read) into a pending
# per-channel affine (a, b) and activation, which the next kernel applies
# on load.  Every consumer that cannot (plain layers, heads, C >= 128
# levels) materializes the pending affine first, with the same formula as
# the JAX package, so the values equal the plain forward's.  Levels the
# kernels do not take run the plain layers on (D, H, W, C) views.

_PRO_ACTS = (None, "relu", "leaky_relu")  # activations the kernels apply on load


class _Act:
    """A (D, H, W, C) activation, possibly with a pending norm: the true
    value is ``act(x*pa + pb)`` when ``pa`` is set.  ``st`` holds the
    (2, C) sum / sum of squares of ``x`` from a conv epilogue.  ``st``
    and ``pa`` are never both set."""

    __slots__ = ("x", "pa", "pb", "pact", "st")

    def __init__(self, x, pa=None, pb=None, pact=None, st=None):
        self.x, self.pa, self.pb, self.pact, self.st = x, pa, pb, pact, st

    @property
    def c(self) -> int:
        return self.x.shape[-1]

    def prologue(self):
        return None if self.pa is None else (self.pa, self.pb, self.pact)


def _materialize(t: _Act) -> _Act:
    """Apply a pending affine + act in the compute dtype (the JAX package's
    ``_pk_materialize``)."""
    if t.pa is None:
        return t
    y = t.x * t.pa.to(t.x.dtype) + t.pb.to(t.x.dtype)
    return _Act(activation(y, t.pact).contiguous())


def norm_affine_from_stats(st, scale, bias, n_vox: int, eps: float = 1e-5):
    """Fold (2, C) sum / sum of squares into the instance-norm affine:
    y = a*x + b.  Variance is E[x^2] - mean^2, clamped at 0 (the JAX
    package's ``norm_affine_from_stats``)."""
    mean = st[0] / n_vox
    var = (st[1] / n_vox - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    a = inv * scale.float()
    return a, bias.float() - mean * a


class _Kernels:
    """The kernels a fused forward calls, one per ``_route`` name (``norm``:
    the K2 read of a norm's statistics): the wrappers (the kernel on a
    card, the twin on the CPU), or, for ``plain=True``, the twins
    themselves on any device — the reference a card run is held to."""

    def __init__(self, plain: bool):
        if plain:
            self.s1 = lambda x, w, b, prologue=None, want_stats=False: K.conv3_plain(
                [x], [prologue], w, b, 1, want_stats)
            self.entry = lambda x, w, b, want_stats=False: K.conv3_plain(
                [x], [None], w, b, 1, want_stats)
            self.dual = lambda xa, xb, w, b, prologue_a=None, prologue_b=None: K.conv3_plain(
                [xa, xb], [prologue_a, prologue_b], w, b, 1)
            self.s2 = lambda x, w, b, prologue=None, want_stats=False: K.conv3_plain(
                [x], [prologue], w, b, 2, want_stats)
            self.trans = K.conv_trans2x_plain
            self.norm = channel_sum_sq_plain
        else:
            self.s1, self.entry, self.dual = K.conv3x3x3_s1, K.conv3x3x3_entry, K.conv3x3x3_dual
            self.s2, self.trans, self.norm = K.conv3x3x3_s2, K.conv_trans2x, channel_sum_sq


def _run_level_fused(kn: _Kernels, params, mod_name, layers, x):
    """One level of the fused forward.  ``x``: an _Act, or a (skip, up)
    pair of _Acts at a decoder entry."""

    def next_is_norm(i):
        return i + 1 < len(layers) and layers[i + 1].kind == "norm"

    for i, layer in enumerate(layers):
        w = params.get(f"{mod_name}.{i}.w")
        b = params.get(f"{mod_name}.{i}.b")
        if isinstance(x, tuple):
            a, up = x
            if a.x.shape == up.x.shape and _route(layer, a.c, a.x.shape[:3], pair=True):
                # each half's pending norm rides its own prologue; the stats
                # of the sum come from one K2 read, as in the JAX package
                a = a if a.pact in _PRO_ACTS else _materialize(a)
                up = up if up.pact in _PRO_ACTS else _materialize(up)
                y = kn.dual(a.x, up.x, w, b, prologue_a=a.prologue(), prologue_b=up.prologue())
                y = activation(y, layer.act)
                x = _Act(y, st=kn.norm(y) if next_is_norm(i) else None)
                continue
            x = _Act(torch.cat([_materialize(a).x, _materialize(up).x], dim=-1))
        if x.pact not in _PRO_ACTS:
            x = _materialize(x)  # elu: no in-kernel prologue
        stats = next_is_norm(i) and not layer.act
        route = _route(layer, x.c, x.x.shape[:3])
        if route == "entry":  # K1's entry form takes no prologue
            out = kn.entry(_materialize(x).x, w, b, want_stats=stats)
        elif route in ("s1", "s2"):
            out = getattr(kn, route)(x.x, w, b, prologue=x.prologue(), want_stats=stats)
        if route in ("entry", "s1", "s2"):
            x = _Act(out[0], st=out[1]) if stats else _Act(out)
        elif route == "trans":
            x = _Act(kn.trans(x.x, w, b, prologue=x.prologue()))
        elif layer.kind == "norm" and (route or x.st is not None):
            if x.st is None:
                xm = _materialize(x).x
                x = _Act(xm, st=kn.norm(xm))
            pa, pb = norm_affine_from_stats(x.st, w, b, math.prod(x.x.shape[:3]))
            x = _Act(x.x, pa=pa, pb=pb)
        else:
            x = _Act(_plain_layer(layer, _materialize(x).x, w, b))
        if layer.act:
            if x.pa is not None and x.pact is None and layer.act in ("relu", "leaky_relu"):
                x = _Act(x.x, pa=x.pa, pb=x.pb, pact=layer.act)
            else:
                x = _Act(activation(_materialize(x).x, layer.act))
    return x


def fused_supported(spec: UNetSpec) -> bool:
    """False for specs the fused forward does not take (bnorm layers)."""
    groups = (*spec.encoders, *spec.decoders, *spec.heads, *spec.tails)
    return not any(layer.kind == "bnorm" for g in groups for layer in g)


def forward_fused(spec: UNetSpec, params: dict, x: torch.Tensor, *,
                  compute_dtype=torch.bfloat16, level0_only: bool = False,
                  plain: bool = False):
    """Inference forward through the kernels with deferred instance norm.
    ``x``: (1, D, H, W, in_count).  Returns the per-level logits like
    ``forward`` (``None`` for the heads of levels above 0 when
    ``level0_only``: the evaluate path reads only level 0, and JAX's jit
    drops the others for it).  ``plain=True`` runs the kernels' twins in
    their place, on any device.  Specs with bnorm run ``forward``."""
    if not fused_supported(spec) or x.shape[0] != 1:
        return forward(spec, params, x, compute_dtype=compute_dtype)
    kn = _Kernels(plain)

    def run(name, layers, t):
        return _run_level_fused(kn, params, name, layers, t)

    def head(level, layers, t):
        if level and level0_only:
            return None
        return _materialize(run(f"output{level}", layers, t)).x.float().unsqueeze(0)

    return _walk(spec, run, _Act(x[0].to(compute_dtype).contiguous()), head)


# ---------------------------------------------------------------------------
# training forward through the kernels' autograd Functions
# ---------------------------------------------------------------------------
#
# The counterpart of the JAX package's packed forward in training
# (forward_packed(train=True), that is _run_level_packed(fuse=False)): no
# deferred norm and no prologue.  The layers ``_route`` gives a kernel go
# through the custom-VJP Functions (forward and backward kernels), a norm
# with its activation (``instance_norm_act_train``); the C >= 128 levels,
# the ks1 heads and the other layers run plain PyTorch under autograd, as
# the JAX package leaves them to XLA (_conv_cv).  The program's tracer
# counts each training norm: ``norm_act.fused`` where the norm's Function
# takes its activation (a leaky ReLU or none), ``norm_act.plain`` where it
# does not.


class _TrainOps:
    """The layers a training forward calls, one per ``_route`` name (a
    norm with its activation): the kernels' autograd Functions, or, for
    ``plain=True``, their twins under plain autograd (the reference a card
    run is held to)."""

    def __init__(self, plain: bool):
        if plain:
            self.s1 = lambda x, w, b: K.conv3_plain([x], [None], w, b, 1)
            self.entry = self.s1
            self.dual = lambda xa, xb, w, b: K.conv3_plain([xa, xb], [None, None], w, b, 1)
            self.s2 = lambda x, w, b: K.conv3_plain([x], [None], w, b, 2)
            self.trans = K.conv_trans2x_plain
            self.norm = lambda x, w, b, act: activation_train(instance_norm_train_plain(x, w, b),
                                                              act)
        else:
            self.s1, self.entry = K.ConvS1Fn.apply, K.ConvEntryFn.apply
            self.dual, self.s2 = K.ConvDualFn.apply, K.ConvS2Fn.apply
            self.trans, self.norm = K.ConvTrans2xFn.apply, instance_norm_act_train


def _ks1_conv(x, w, b):
    """ks1 conv on channels-last ``x`` as one matmul, in x's dtype."""
    y = x.reshape(-1, x.shape[-1]) @ w.reshape(w.shape[0], -1).to(x.dtype).T
    return (y + b.to(x.dtype)).reshape(*x.shape[:-1], w.shape[0])


def _run_level_train(ops: _TrainOps, params, mod_name, layers, x):
    """One level of the training forward.  ``x``: a (D, H, W, C) tensor,
    or a (skip, up) pair at a decoder entry."""
    for i, layer in enumerate(layers):
        w = params.get(f"{mod_name}.{i}.w")
        b = params.get(f"{mod_name}.{i}.b")
        if isinstance(x, tuple):
            a, up = x
            if a.shape == up.shape and _route(layer, a.shape[-1], a.shape[:3], pair=True):
                x = activation_train(ops.dual(a, up, w, b), layer.act)
                continue
            x = torch.cat([a, up], dim=-1)
        route = _route(layer, x.shape[-1], x.shape[:3])
        if layer.kind == "norm":
            count("norm_act.fused" if route == "norm" and layer.act in NORM_ACTS
                  else "norm_act.plain")
        if route == "norm":
            x = ops.norm(x, w, b, layer.act)
            continue
        if route:
            x = getattr(ops, route)(x, w, b)
        elif layer.kind == "conv" and layer.ks == 1:
            x = _ks1_conv(x, w, b)
        elif layer.kind == "bnorm":
            # batch statistics, as the JAX package trains (its running
            # statistics are not updated by the train step either)
            xf = x.float()
            mean = xf.mean(dim=(0, 1, 2))
            var = (xf - mean).square().mean(dim=(0, 1, 2))
            x = _batch_norm(ncdhw(x), w, b, mean, var).permute(0, 2, 3, 4, 1)[0].contiguous()
        else:
            x = _plain_layer(layer, x, w, b)
        x = activation_train(x, layer.act)
    return x


def forward_train(spec: UNetSpec, params: dict, x: torch.Tensor, *,
                  compute_dtype=torch.bfloat16, plain: bool = False, remat: bool = False):
    """The training forward of one item.  ``x``: (1, D, H, W, in_count).
    Returns the per-level logits in f32: level 0 as ``ChannelLeading``
    planes (C, 1, D, H, W) when its head is one ks1 conv (the loss's
    layout, written by the head's matmul directly), the other levels
    (1, D_l, H_l, W_l, out_count).  Differentiable in ``params``;
    ``plain=True`` runs the kernels' twins under plain autograd.
    ``remat=True`` checkpoints each level (``_level``); the level-0 ks1
    head stays outside, as the JAX package keeps its packed head."""
    if x.shape[0] != 1:
        raise ValueError(f"forward_train takes one item, got a batch of {x.shape[0]}")
    ops = _TrainOps(plain)

    def run(name, layers, x):
        return _level(lambda v: _run_level_train(ops, params, name, layers, v), x, remat)

    def head(level, layers, t):
        if level == 0 and len(layers) == 1 and layers[0].kind == "conv" and layers[0].ks == 1 \
                and layers[0].act is None:
            w, b = params["output0.0.w"], params["output0.0.b"]
            planes = w.reshape(w.shape[0], -1).to(t.dtype) @ t.reshape(-1, t.shape[-1]).T
            planes = planes + b.to(t.dtype)[:, None]
            return ChannelLeading(planes.float().reshape(w.shape[0], 1, *t.shape[:3]))
        return run(f"output{level}", layers, t).float().unsqueeze(0)

    return _walk(spec, run, x[0].to(compute_dtype).contiguous(), head)


# ---------------------------------------------------------------------------
# the model (metadata + parameters), the UNet3d analog (unet.hpp:13-69)
# ---------------------------------------------------------------------------


class UNet3d(nn.Module):
    """Metadata plus parameters.  Submodules ``<module>.<layer>`` carry
    ``weight``/``bias`` in the torch layout, registered in ``.nz`` order,
    so ``state_dict()`` keys read ``encode0.0.weight`` and
    ``parameters()`` enumerates ``tensor0..tensorN``."""

    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = spec
        for mod_name, layers in spec.module_names():
            seq = nn.Module()
            for i, layer in enumerate(layers):
                if layer.has_params:
                    m = nn.Module()
                    m.weight = nn.Parameter(torch.zeros(torch_param_shape(layer, "w")),
                                            requires_grad=False)
                    m.bias = nn.Parameter(torch.zeros(torch_param_shape(layer, "b")),
                                          requires_grad=False)
                    seq.add_module(str(i), m)
            self.add_module(mod_name, seq)
        self.state = init_state(spec)
        self.voxel_size = np.array([1.0, 1.0, 1.0], np.float32)
        self.dim: tuple[int, int, int] = (192, 224, 192)  # (x, y, z), unet.hpp:37-38
        self.fov_strategy = "align_top"
        self.preproc = ""
        self.orientation = ""
        self.postproc = "softmax+create_mask+argmax"
        self.single_component_label: list[int] = []
        self.testing_errors: list[float] = []
        self.training_errors: list[float] = []

    @property
    def in_count(self) -> int:
        return self.spec.in_count

    @property
    def out_count(self) -> int:
        return self.spec.out_count

    @property
    def architecture(self) -> str:
        return self.spec.architecture

    @property
    def dim_dhw(self) -> tuple[int, int, int]:
        """(D, H, W) = (z, y, x) compute layout."""
        return (self.dim[2], self.dim[1], self.dim[0])

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def params(self) -> dict[str, torch.Tensor]:
        """``{"encode0.0.w": weight, ...}`` in .nz order."""
        out = {}
        for name, _, which in param_order(self.spec):
            mod, i, _ = name.split(".")
            m = getattr(self, mod).get_submodule(i)
            out[name] = m.weight if which == "w" else m.bias
        return out

    def load_params(self, params: dict) -> None:
        """Copy ``{"encode0.0.w": array}`` (torch layout) into the model."""
        with torch.no_grad():
            for name, p in self.params().items():
                p.copy_(torch.as_tensor(np.array(params[name], np.float32)))

    @classmethod
    def create(cls, in_count: int, out_count: int, architecture: str, seed: int = 0,
               device=None) -> "UNet3d":
        """A model with ``init_params`` weights on ``device`` (default: the
        card)."""
        dev = resolve_device(device)
        model = cls(parse_architecture(in_count, out_count, architecture))
        model.load_params(init_params(model.spec, seed))
        return model.to(dev)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32):
        """All levels' logits through the plain forward."""
        return forward(self.spec, self.params(), x, state=self.state,
                       compute_dtype=compute_dtype)

    def prepare_for_inference(self) -> None:
        """Reset BatchNorm running stats to identity (unet.cpp:7-22)."""
        self.state = init_state(self.spec)

    def copy_from(self, other: "UNet3d") -> None:
        """Size-checked parameter copy (unet.cpp:195-222)."""
        theirs = other.params()
        with torch.no_grad():
            for k, p in self.params().items():
                if k in theirs and theirs[k].shape == p.shape:
                    p.copy_(theirs[k])
        self.voxel_size = np.array(other.voxel_size, np.float32)
        self.dim = tuple(other.dim)
        self.fov_strategy = other.fov_strategy
        self.postproc = other.postproc
        self.preproc = other.preproc

    def get_info(self) -> str:
        out = [
            f"in: {self.in_count} out: {self.out_count}",
            f"dim: {self.dim} reso: {tuple(float(v) for v in self.voxel_size)}",
            f"structure: {self.architecture}",
        ]
        if self.preproc:
            out.append(f"preproc: {self.preproc}")
        if self.postproc:
            out.append(f"postproc: {self.postproc}")
        return "\n".join(out) + "\n"
