"""Convolution kernels of the U-Net, each with its plain PyTorch twin.

Forward: K1 (3x3x3 stride 1, with its 2C->C dual-input and 1->C entry
forms), K3 (3x3x3 stride 2) and K4 (ks2/stride-2 transposed conv).
Backward (``csrc/conv_bwd.cu``): the weight gradients K5 (stride 1), K6
(stride 2) and K9 (transposed), and the input gradients K7 (stride 2) and
K8 (transposed); the stride-1 input gradient is K1 on the output
gradient with flipped, transposed weights.  One ``torch.autograd.Function``
per forward kernel (``ConvS1Fn``, ``ConvEntryFn``, ``ConvDualFn``,
``ConvS2Fn``, ``ConvTrans2xFn``) ties the two together for training.

Layouts at every function here: activations channels-last ``(D, H, W,
C)``, contiguous; weights in the torch layout of the ``.nz`` file
(conv ``(Co, Ci, 3, 3, 3)``, conv_trans ``(Ci, Co, 2, 2, 2)``); bias
``(Co,)``.  A ``prologue`` is ``(a, b, act)`` with ``a``, ``b`` f32
``(Ci,)`` and ``act`` in ``(None, "relu", "leaky_relu")``: the input is
read as ``act(a*x + b)``, computed in f32 and rounded to the input dtype
(the deferred instance norm of the previous layer).  ``want_stats``
also returns the f32 ``(2, Co)`` per-channel sum and sum of squares of
the f32 result before its cast (the next norm's statistics).

Each wrapper runs its twin when the tensor lies on the CPU and launches
its CUDA kernel when it lies on a card; there it raises on what the
kernel does not take.  The route goes by dtype: bf16 K1 (all four uses),
K3, K5, K6 and K7 run on the tensor cores (``csrc/conv_tc.cu``, operands
laid out by ``ops/tc_layout.py``) for the channel counts of
``KERNEL_CHANNELS``, ``tc_layout.DW_CI``/``DW_CO``, ``TC_S2`` and
``TC_S2DX``; f32 keeps the FMA kernels (``csrc/conv.cu``,
``csrc/conv_bwd.cu``), since f32 on the tensor cores would be TF32.
``<wrapper>.launches`` counts the kernel launches, and
``<wrapper>.tc_launches`` those of them on the tensor-core route.

The twins compute in f32 from the inputs and weights rounded to the
compute dtype, as the kernels do.  The kernels' stats and the weight
gradients sum over the volume in another order than the twins (partial
sums per block in a fixed order, then one ordered sum over the blocks, no
atomics), so they agree with the twins to f32 rounding of a long sum and
are bitwise the same from run to run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda, tc_layout

# C of the levels the kernels serve; bf16 K1 has a tensor-core instance
# for each (C -> C per input, and the entry's 1 -> C)
KERNEL_CHANNELS = (16, 32, 64)
TC_S2DX = ((16, 32), (32, 64), (64, 128))  # bf16 K7: (dx channels, g channels)
TC_S2 = tc_layout.S2_PAIRS  # bf16 K3 and K6: (Ci, Co)
# kinds of csrc/conv_tc.cu unet_conv3_tc_rows
_KIND_K1, _KIND_DUAL, _KIND_ENTRY, _KIND_K3 = 0, 1, 2, 3


def apply_prologue(x: torch.Tensor, prologue) -> torch.Tensor:
    """act(a*x + b) in f32, rounded to x's dtype (the kernels' load)."""
    if prologue is None:
        return x
    a, b, act = prologue
    v = x.float() * a.float() + b.float()
    return activation(v, act).to(x.dtype)


def activation(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "leaky_relu":
        return F.leaky_relu(x, 0.01)
    if act == "elu":
        return F.elu(x)
    raise ValueError(act)


class _LeakyReLU(torch.autograd.Function):
    """Leaky ReLU (slope 0.01) whose gradient at 0 is 1, as
    ``jax.nn.leaky_relu``'s (``where(x >= 0, x, 0.01 x)``); that of
    ``F.leaky_relu`` is 0.01 there, and exact zeros are common in bf16.
    Saves its output, which the next layer keeps anyway: y >= 0 exactly
    where x >= 0."""

    @staticmethod
    def forward(ctx, x):
        y = F.leaky_relu(x, 0.01)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y >= 0, g, g * 0.01)


def activation_train(x: torch.Tensor, act: str | None) -> torch.Tensor:
    """``activation`` with the JAX package's gradients (leaky ReLU: 1 at 0)."""
    return _LeakyReLU.apply(x) if act == "leaky_relu" else activation(x, act)


def ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(3, 0, 1, 2).unsqueeze(0)


def dhwc(y: torch.Tensor) -> torch.Tensor:
    return y[0].permute(1, 2, 3, 0)


def _stats(y32: torch.Tensor) -> torch.Tensor:
    flat = y32.reshape(-1, y32.shape[-1])
    return torch.stack([flat.sum(0), (flat * flat).sum(0)])


def conv3_plain(xs, prologues, w, b, stride: int, want_stats: bool = False):
    """Twin of K1/K3: the conv of the channel concatenation of ``xs``
    (each after its prologue), pad 1, in f32."""
    dt = xs[0].dtype
    x = torch.cat([apply_prologue(x, p) for x, p in zip(xs, prologues)], dim=-1)
    y = dhwc(F.conv3d(ncdhw(x.float()), w.to(dt).float(), b.float(),
                       stride=stride, padding=1))
    out = y.to(dt).contiguous()
    return (out, _stats(y)) if want_stats else out


def conv_trans2x_plain(x, w, b, prologue=None):
    """Twin of K4: ConvTranspose3d(ks2, stride2) in f32."""
    dt = x.dtype
    y = F.conv_transpose3d(ncdhw(apply_prologue(x, prologue).float()),
                           w.to(dt).float(), b.float(), stride=2)
    return dhwc(y).to(dt).contiguous()


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) -> (Ci, Co, 3, 3, 3) flipped in space: the weight
    of the stride-1 conv's input gradient as a conv of g."""
    return w.flip(2, 3, 4).transpose(0, 1)


def conv_dw_plain(a, b, ks: int, stride: int, pad: int) -> torch.Tensor:
    """Twin of the dW kernel: (ks^3, CA, CB) f32 with ``out[tap][i][j] =
    sum_o a[stride*o + tap - pad][i] * b[o][j]`` over the voxels o of
    ``b``, taps outside ``a`` reading zero: one matmul per tap."""
    od, oh, ow, cb = b.shape
    ca = a.shape[-1]
    ap = F.pad(a.float(), (0, 0, pad, pad, pad, pad, pad, pad))
    bf = b.float().reshape(-1, cb)

    def span(k, n):
        return slice(k, k + stride * (n - 1) + 1, stride)

    taps = [ap[span(dz, od), span(dy, oh), span(dx, ow)].reshape(-1, ca).T @ bf
            for dz in range(ks) for dy in range(ks) for dx in range(ks)]
    return torch.stack(taps)


def conv3_s2_dx_plain(g, w):
    """Twin of K7: the transposed conv that is the stride-2 conv's adjoint."""
    dt = g.dtype
    dx = F.conv_transpose3d(ncdhw(g.float()), w.to(dt).float(), stride=2, padding=1,
                            output_padding=1)
    return dhwc(dx).to(dt).contiguous()


def conv_trans2x_dx_plain(g, w):
    """Twin of K8: the ks2/stride-2 conv of g with the transposed conv's weight."""
    dt = g.dtype
    return dhwc(F.conv3d(ncdhw(g.float()), w.to(dt).float(), stride=2)).to(dt).contiguous()


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _check_act(x: torch.Tensor, c: int, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, expected cuda or cpu")
    if x.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not in (float32, bfloat16)")
    if x.dim() != 4 or x.shape[-1] != c:
        raise ValueError(f"{name}: expected (D, H, W, {c}), got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be contiguous and 16-byte aligned")


def _prologue_args(pro, c: int, device):
    if pro is None:
        return None, None, 0
    a, b, act = pro
    if act not in _cuda.ACT_CODES:
        raise ValueError(f"prologue activation {act!r} has no in-kernel form")
    a = a.to(device=device, dtype=torch.float32).contiguous()
    b = b.to(device=device, dtype=torch.float32).contiguous()
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"prologue vectors must be ({c},)")
    return a, b, _cuda.ACT_CODES[act]


def _launch_conv3(xs, prologues, w, b, stride: int, want_stats: bool, name: str):
    xa = xs[0]
    d, h, wd, ci = xa.shape
    co = w.shape[0]
    for x in xs:
        _check_act(x, ci, name)
    if len(xs) == 2 and (xs[1].shape != xa.shape or xs[1].dtype != xa.dtype):
        raise ValueError(f"{name}: the two inputs differ in shape or dtype")
    if tuple(w.shape) != (co, ci * len(xs), 3, 3, 3) or co % 16:
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit Ci={ci}")
    if ci != 1 and ci % 16:
        raise ValueError(f"{name}: Ci={ci} must be 1 or a multiple of 16")
    if stride == 2 and (d % 2 or h % 2 or wd % 2):
        raise ValueError(f"{name}: stride 2 needs even D, H, W, got {(d, h, wd)}")
    dt = xa.dtype
    tc = dt == torch.bfloat16
    if tc and stride == 2 and (len(xs) != 1 or (ci, co) not in TC_S2):
        raise ValueError(f"{name}: bf16 stride-2 conv has no tensor-core kernel for Ci={ci}, "
                         f"Co={co} (takes {TC_S2})")
    if tc and stride == 1 and ci == 1 and co not in KERNEL_CHANNELS:
        raise ValueError(f"{name}: bf16 entry conv has no tensor-core kernel for Co={co}")
    if tc and stride == 1 and ci != 1 and (ci != co or ci not in KERNEL_CHANNELS):
        raise ValueError(f"{name}: bf16 conv has no tensor-core kernel for Ci={ci}, Co={co} "
                         f"(takes Ci = Co in {KERNEL_CHANNELS} per input)")
    bias = b.detach().to(dtype=torch.float32).contiguous()
    y = torch.empty((d // stride, h // stride, wd // stride, co), dtype=dt, device=xa.device)
    kind = (_KIND_K3 if stride == 2 else _KIND_ENTRY if ci == 1
            else _KIND_DUAL if len(xs) == 2 else _KIND_K1)
    part = stats = None
    pa, pb, act = _prologue_args(prologues[0], ci, xa.device)
    if len(xs) == 2:
        xb = xs[1]
        qa, qb, act_b = _prologue_args(prologues[1], ci, xa.device)
    else:
        xb, qa, qb, act_b = None, None, None, 0
    p = _cuda.ptr
    wdt = w.detach().to(dtype=dt)
    with torch.cuda.device(xa.device):
        lib, stream = _cuda.lib(), _cuda.stream_ptr(xa)
        if want_stats:
            # one row of partial sums per block of the launch, added in
            # order into stats by the entry's second launch
            rows = (lib.unet_conv3_tc_rows(kind, ci, co, d, h, wd) if tc
                    else lib.unet_conv3_rows(d, h, wd, stride))
            if rows < 1:
                raise ValueError(f"{name}: no stats partials for Ci={ci}, Co={co}")
            part = torch.empty((rows, 2, co), dtype=torch.float32, device=xa.device)
            stats = torch.empty((2, co), dtype=torch.float32, device=xa.device)
        if tc and kind == _KIND_K3:
            wk = tc_layout.pack_weights(wdt, "k3")
            rc = lib.unet_conv3_s2_tc(p(xa), p(pa), p(pb), act, ci, p(wk), p(bias), p(y),
                                      p(part), p(stats), d, h, wd, co, stream)
        elif tc and kind == _KIND_ENTRY:
            wk = tc_layout.pack_weights(wdt, "entry")
            rc = lib.unet_conv3_entry_tc(p(xa), p(wk), p(bias), p(y), p(part), p(stats), d, h,
                                         wd, co, stream)
        elif tc:
            wk = tc_layout.pack_weights(wdt, "k1_dual" if len(xs) == 2 else "k1")
            rc = lib.unet_conv3_tc(
                p(xa), p(pa), p(pb), act, p(xb), p(qa), p(qb), act_b, ci, p(wk), p(bias),
                p(y), p(part), p(stats), d, h, wd, co, stream)
        else:
            # (Co, Ci, kz, ky, kx) -> (kz, ky, kx, Ci, Co): the FMA kernel's tap-major layout
            wk = wdt.permute(2, 3, 4, 1, 0).contiguous()
            rc = lib.unet_conv3(
                p(xa), p(pa), p(pb), act, p(xb), p(qa), p(qb), act_b, ci, p(wk), p(bias),
                p(y), p(part), p(stats), d, h, wd, co, stride, stream)
    _cuda.check(rc, name)
    return (y, stats) if want_stats else y


def _count(wrapper, x: torch.Tensor) -> None:
    """One launch of ``wrapper``'s kernel on ``x``: bf16 is the tensor-core route."""
    wrapper.launches += 1
    if x.dtype == torch.bfloat16:
        wrapper.tc_launches += 1


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def conv3x3x3_s1(x, w, b, *, prologue=None, want_stats=False):
    """K1, C->C: 3x3x3 stride-1 pad-1 conv + bias.  Replaces
    unet_studio_tpu/ops/pallas_conv.py ``_fwd_kernel`` (``conv_s1_packed``)."""
    if x.device.type == "cpu":
        return conv3_plain([x], [prologue], w, b, 1, want_stats)
    out = _launch_conv3([x], [prologue], w, b, 1, want_stats, "conv3x3x3_s1")
    _count(conv3x3x3_s1, x)
    return out


def conv3x3x3_entry(x, w, b, *, want_stats=False):
    """K1, 1->C entry conv on the raw (D, H, W, 1) input.  Replaces
    unet_studio_tpu/ops/packed.py ``conv_entry``, which runs K1's Pallas
    kernel on a lane-padded view of the input."""
    if x.device.type == "cpu":
        return conv3_plain([x], [None], w, b, 1, want_stats)
    out = _launch_conv3([x], [None], w, b, 1, want_stats, "conv3x3x3_entry")
    _count(conv3x3x3_entry, x)
    return out


def conv3x3x3_dual(xa, xb, w, b, *, prologue_a=None, prologue_b=None):
    """K1, 2C->C decoder entry: the conv of ``cat([xa, xb], -1)`` without
    the concatenation, each half read through its own prologue.  Replaces
    the two summed ``conv_s1_packed`` calls of unet_studio_tpu/models/
    unet3d.py ``_run_level_packed`` (the second with a zero bias).  The
    kernel sums both halves in one f32 accumulator."""
    if xa.device.type == "cpu":
        return conv3_plain([xa, xb], [prologue_a, prologue_b], w, b, 1)
    out = _launch_conv3([xa, xb], [prologue_a, prologue_b], w, b, 1, False,
                        "conv3x3x3_dual")
    _count(conv3x3x3_dual, xa)
    return out


def conv3x3x3_s2(x, w, b, *, prologue=None, want_stats=False):
    """K3, C->2C: 3x3x3 stride-2 pad-1 conv + bias on even D, H, W.
    Replaces unet_studio_tpu/ops/packed.py ``_s2_fwd_kernel``
    (``conv_s2_down``).  bf16 runs on the tensor cores for (Ci, Co) in
    ``TC_S2``."""
    if x.device.type == "cpu":
        return conv3_plain([x], [prologue], w, b, 2, want_stats)
    out = _launch_conv3([x], [prologue], w, b, 2, want_stats, "conv3x3x3_s2")
    _count(conv3x3x3_s2, x)
    return out


def conv_trans2x(x, w, b, *, prologue=None):
    """K4: ConvTranspose3d(ks2, stride2) 2C->C + bias.  Replaces
    unet_studio_tpu/ops/packed.py ``_trans_kernel`` (``conv_trans2x_up``)."""
    if x.device.type == "cpu":
        return conv_trans2x_plain(x, w, b, prologue)
    d, h, wd, ci = x.shape
    co = w.shape[1]
    _check_act(x, ci, "conv_trans2x")
    if tuple(w.shape) != (ci, co, 2, 2, 2) or ci % 16 or co % 16:
        raise ValueError(f"conv_trans2x: weight {tuple(w.shape)} for Ci={ci} "
                         "(Ci and Co must be multiples of 16)")
    dt = x.dtype
    # (Ci, Co, kz, ky, kx) -> (kz, ky, kx, Ci, Co): parity-major
    wk = w.detach().to(dtype=dt).permute(2, 3, 4, 0, 1).contiguous()
    bias = b.detach().to(dtype=torch.float32).contiguous()
    y = torch.empty((2 * d, 2 * h, 2 * wd, co), dtype=dt, device=x.device)
    pa, pb, act = _prologue_args(prologue, ci, x.device)
    p = _cuda.ptr
    with torch.cuda.device(x.device):
        rc = _cuda.lib().unet_trans2x(
            p(x), p(pa), p(pb), act, ci, p(wk), p(bias), p(y), d, h, wd, co,
            _cuda.DTYPE_CODES[dt], _cuda.stream_ptr(x),
        )
    _cuda.check(rc, "conv_trans2x")
    conv_trans2x.launches += 1
    return y


# ---------------------------------------------------------------------------
# backward wrappers
# ---------------------------------------------------------------------------


def conv3x3x3_dx(g, w):
    """K1 as the input gradient of the 3x3x3 stride-1 conv with weight
    ``w`` (Co, Ci, 3, 3, 3): the conv of ``g`` (D, H, W, Co) with the
    weight flipped and transposed, zero bias, in g's dtype.  Replaces
    the ``conv_s1_packed`` call of unet_studio_tpu/ops/pallas_conv.py
    ``_conv_s1_p_bwd`` (K1's Pallas kernel there too)."""
    wt = flip_transpose(w)
    zero = torch.zeros(wt.shape[0], dtype=torch.float32, device=g.device)
    if g.device.type == "cpu":
        return conv3_plain([g], [None], wt, zero, 1)
    out = _launch_conv3([g], [None], wt, zero, 1, False, "conv3x3x3_dx")
    _count(conv3x3x3_dx, g)
    return out


def _launch_dw(a, b, ks: int, stride: int, pad: int, name: str):
    """(ks^3, CA, CB) f32 from the dW kernel (see ``conv_dw_plain``)."""
    ca, cb = a.shape[-1], b.shape[-1]
    _check_act(a, ca, name)
    _check_act(b, cb, name)
    if a.dtype != b.dtype:
        raise ValueError(f"{name}: the two inputs differ in dtype")
    if cb % 16 or (ca % 16 and not (ca == 1 and ks == 3 and stride == 1)):
        raise ValueError(f"{name}: channels ({ca}, {cb}) must be multiples of 16 "
                         "(or 1 for the stride-1 conv's input)")
    if tuple(a.shape[:3]) != tuple(stride * s for s in b.shape[:3]):
        raise ValueError(f"{name}: volumes {tuple(a.shape)} and {tuple(b.shape)} do not "
                         f"match stride {stride}")
    taps = ks ** 3
    grid_y = (ca // min(ca, 16)) * (cb // 16)
    # about four blocks of partial sums per SM, at most one per row of b
    n_sm = torch.cuda.get_device_properties(a.device).multi_processor_count
    nblk = max(1, min(b.shape[0] * b.shape[1], 4 * n_sm // grid_y))
    part = torch.empty((nblk, taps, ca, cb), dtype=torch.float32, device=a.device)
    out = torch.empty((taps, ca, cb), dtype=torch.float32, device=a.device)
    p = _cuda.ptr
    with torch.cuda.device(a.device):
        rc = _cuda.lib().unet_conv_dw(
            p(a), *a.shape[:3], ca, p(b), *b.shape[:3], cb, ks, stride, pad, p(part), nblk,
            p(out), _cuda.DTYPE_CODES[a.dtype], _cuda.stream_ptr(a),
        )
    _cuda.check(rc, name)
    return out


def _launch_dw_tc(x, g, stride: int, name: str):
    """(27, Ci, Co) f32 from the tensor-core dW kernel: bf16 K5 (stride 1,
    x and g of one size) or K6 (stride 2, x twice g's size)."""
    ci, co = x.shape[-1], g.shape[-1]
    _check_act(x, ci, name)
    _check_act(g, co, name)
    if g.dtype != torch.bfloat16 or tuple(x.shape[:3]) != tuple(stride * n for n in g.shape[:3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype} and g {tuple(g.shape)} "
                         f"{g.dtype} must be bf16 volumes of stride {stride}")
    if stride == 1 and (ci not in tc_layout.DW_CI or co not in tc_layout.DW_CO):
        raise ValueError(f"{name}: bf16 dW has no tensor-core kernel for Ci={ci}, Co={co} "
                         f"(takes Ci in {tc_layout.DW_CI}, Co in {tc_layout.DW_CO})")
    if stride == 2 and (ci, co) not in TC_S2:
        raise ValueError(f"{name}: bf16 stride-2 dW has no tensor-core kernel for Ci={ci}, "
                         f"Co={co} (takes {TC_S2})")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    nblk = tc_layout.dw_blocks(g.shape[:3], ci, co, n_sm, stride)
    part = torch.empty(tc_layout.dw_partial_shape(nblk, ci, co), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((27, ci, co), dtype=torch.float32, device=x.device)
    p = _cuda.ptr
    with torch.cuda.device(x.device):
        entry = _cuda.lib().unet_conv_dw_tc if stride == 1 else _cuda.lib().unet_conv_dw_s2_tc
        rc = entry(p(x), p(g), *g.shape[:3], ci, co, p(part), nblk, p(out),
                   _cuda.stream_ptr(x))
    _cuda.check(rc, name)
    return out


def conv3x3x3_dw(x, g):
    """K5: the f32 (Co, Ci, 3, 3, 3) weight gradient of the 3x3x3
    stride-1 pad-1 conv with input ``x`` (D, H, W, Ci), Ci = 1 for the
    entry conv, and output gradient ``g`` (D, H, W, Co).  Replaces
    unet_studio_tpu/ops/pallas_conv.py ``_dw_kernel`` (in ``conv_s1_p``'s
    and ``conv_entry_p``'s VJPs).  bf16 runs on the tensor cores."""
    if x.device.type == "cpu":
        out = conv_dw_plain(x, g, 3, 1, 1)
    else:
        if x.dtype == torch.bfloat16:
            out = _launch_dw_tc(x, g, 1, "conv3x3x3_dw")
        else:
            out = _launch_dw(x, g, 3, 1, 1, "conv3x3x3_dw")
        _count(conv3x3x3_dw, x)
    return out.reshape(3, 3, 3, x.shape[-1], g.shape[-1]).permute(4, 3, 0, 1, 2).contiguous()


def conv3x3x3_s2_dw(x, g):
    """K6: the f32 (Co, Ci, 3, 3, 3) weight gradient of the 3x3x3
    stride-2 pad-1 conv with input ``x`` (D, H, W, Ci) and output gradient
    ``g`` (D/2, H/2, W/2, Co).  Replaces unet_studio_tpu/ops/packed.py
    ``_s2_dw_kernel`` (in ``conv_s2_p``'s VJP).  bf16 runs on the tensor
    cores for (Ci, Co) in ``TC_S2``."""
    if x.device.type == "cpu":
        out = conv_dw_plain(x, g, 3, 2, 1)
    else:
        if x.dtype == torch.bfloat16:
            out = _launch_dw_tc(x, g, 2, "conv3x3x3_s2_dw")
        else:
            out = _launch_dw(x, g, 3, 2, 1, "conv3x3x3_s2_dw")
        _count(conv3x3x3_s2_dw, x)
    return out.reshape(3, 3, 3, x.shape[-1], g.shape[-1]).permute(4, 3, 0, 1, 2).contiguous()


def conv_trans2x_dw(x, g):
    """K9: the f32 (Ci, Co, 2, 2, 2) weight gradient of the ks2/stride-2
    transposed conv with input ``x`` (D, H, W, Ci) and output gradient
    ``g`` (2D, 2H, 2W, Co): the dW kernel with the roles of x and g
    swapped.  Replaces unet_studio_tpu/ops/packed.py ``_trans_dw_kernel``
    (in ``conv_trans2x_p``'s VJP)."""
    if x.device.type == "cpu":
        out = conv_dw_plain(g, x, 2, 2, 0)
    else:
        out = _launch_dw(g, x, 2, 2, 0, "conv_trans2x_dw")
        conv_trans2x_dw.launches += 1
    return out.reshape(2, 2, 2, g.shape[-1], x.shape[-1]).permute(4, 3, 0, 1, 2).contiguous()


def conv3x3x3_s2_dx(g, w):
    """K7: the (2*OD, 2*OH, 2*OW, Ci) input gradient, in g's dtype, of
    the 3x3x3 stride-2 pad-1 conv with weight ``w`` (Co, Ci, 3, 3, 3),
    from ``g`` (OD, OH, OW, Co).  Replaces unet_studio_tpu/ops/packed.py
    ``_s2_dx_kernel`` (in ``conv_s2_p``'s VJP)."""
    if g.device.type == "cpu":
        return conv3_s2_dx_plain(g, w)
    od, oh, ow, co = g.shape
    ci = w.shape[1]
    _check_act(g, co, "conv3x3x3_s2_dx")
    if tuple(w.shape) != (co, ci, 3, 3, 3) or co % 16 or ci % 16:
        raise ValueError(f"conv3x3x3_s2_dx: weight {tuple(w.shape)} for Co={co} "
                         "(Ci and Co must be multiples of 16)")
    dt = g.dtype
    if dt == torch.bfloat16 and (ci, co) not in TC_S2DX:
        raise ValueError(f"conv3x3x3_s2_dx: bf16 has no tensor-core kernel for Ci={ci}, "
                         f"Co={co} (takes {TC_S2DX})")
    wdt = w.detach().to(dtype=dt)
    dx = torch.empty((2 * od, 2 * oh, 2 * ow, ci), dtype=dt, device=g.device)
    p = _cuda.ptr
    with torch.cuda.device(g.device):
        if dt == torch.bfloat16:
            wk = tc_layout.pack_weights(wdt, "s2dx")
            rc = _cuda.lib().unet_conv3_s2_dx_tc(p(g), co, p(wk), p(dx), od, oh, ow, ci,
                                                 _cuda.stream_ptr(g))
        else:
            # (Co, Ci, kz, ky, kx) -> (kz, ky, kx, Co, Ci)
            wk = wdt.permute(2, 3, 4, 0, 1).contiguous()
            rc = _cuda.lib().unet_conv3_s2_dx(p(g), co, p(wk), p(dx), 2 * od, 2 * oh, 2 * ow,
                                              ci, _cuda.stream_ptr(g))
    _cuda.check(rc, "conv3x3x3_s2_dx")
    _count(conv3x3x3_s2_dx, g)
    return dx


def conv_trans2x_dx(g, w):
    """K8: the (D, H, W, Ci) input gradient, in g's dtype, of the
    ks2/stride-2 transposed conv with weight ``w`` (Ci, Co, 2, 2, 2),
    from ``g`` (2D, 2H, 2W, Co).  Replaces unet_studio_tpu/ops/packed.py
    ``_trans_dx_kernel`` (in ``conv_trans2x_p``'s VJP)."""
    if g.device.type == "cpu":
        return conv_trans2x_dx_plain(g, w)
    d2, h2, w2, co = g.shape
    ci = w.shape[0]
    _check_act(g, co, "conv_trans2x_dx")
    if d2 % 2 or h2 % 2 or w2 % 2:
        raise ValueError(f"conv_trans2x_dx: g {tuple(g.shape)} needs even D, H, W")
    if tuple(w.shape) != (ci, co, 2, 2, 2) or co % 16 or ci % 16:
        raise ValueError(f"conv_trans2x_dx: weight {tuple(w.shape)} for Co={co} "
                         "(Ci and Co must be multiples of 16)")
    dt = g.dtype
    # (Ci, Co, kz, ky, kx) -> (kz, ky, kx, Co, Ci): parity-major
    wk = w.detach().to(dtype=dt).permute(2, 3, 4, 1, 0).contiguous()
    dx = torch.empty((d2 // 2, h2 // 2, w2 // 2, ci), dtype=dt, device=g.device)
    p = _cuda.ptr
    with torch.cuda.device(g.device):
        rc = _cuda.lib().unet_trans2x_dx(p(g), co, p(wk), p(dx), d2 // 2, h2 // 2, w2 // 2, ci,
                                         _cuda.DTYPE_CODES[dt], _cuda.stream_ptr(g))
    _cuda.check(rc, "conv_trans2x_dx")
    conv_trans2x_dx.launches += 1
    return dx


WRAPPERS = (conv3x3x3_s1, conv3x3x3_entry, conv3x3x3_dual, conv3x3x3_s2, conv_trans2x,
            conv3x3x3_dx, conv3x3x3_dw, conv3x3x3_s2_dw, conv3x3x3_s2_dx, conv_trans2x_dx,
            conv_trans2x_dw)
TC_WRAPPERS = (conv3x3x3_s1, conv3x3x3_entry, conv3x3x3_dual, conv3x3x3_s2, conv3x3x3_dx,
               conv3x3x3_dw, conv3x3x3_s2_dw, conv3x3x3_s2_dx)
for _fn in WRAPPERS:
    _fn.launches = 0
    _fn.tc_launches = 0


# ---------------------------------------------------------------------------
# autograd Functions: the training path's convs (the counterparts of the JAX
# package's custom-VJP primitives conv_s1_p, conv_entry_p, conv_s2_p and
# conv_trans2x_p).  Each casts the incoming gradient to the activation
# dtype, as those VJPs do; dW and db come back in f32.  They save the input
# in the compute dtype and the f32 weight they were given, no copies.
# ---------------------------------------------------------------------------


def _bias_grad(g: torch.Tensor) -> torch.Tensor:
    return g.sum(dim=(0, 1, 2), dtype=torch.float32)


class ConvS1Fn(torch.autograd.Function):
    """K1 C->C; backward: K1 on g (dx), K5 (dW), sum of g (db)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv3x3x3_s1(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = conv3x3x3_dx(g, w) if ctx.needs_input_grad[0] else None
        return dx, conv3x3x3_dw(x, g), _bias_grad(g)


class ConvEntryFn(torch.autograd.Function):
    """K1 1->C on the network input; backward: K5 (dW) and db only.  The
    input needs no gradient, so no K1 runs for it."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x)
        return conv3x3x3_entry(x, w, b)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        return None, conv3x3x3_dw(x, g), _bias_grad(g)


class ConvDualFn(torch.autograd.Function):
    """K1 2C->C on (skip, up); backward: two C->C K1 launches on g, one
    per half of the weight, so each half's dx lands contiguous in its own
    buffer where the next backward kernels read it (one C->2C launch would
    need a strided split copied out); two K5 launches for the two C x C
    halves of dW; db = sum of g once (JAX's second conv has a zero bias)."""

    @staticmethod
    def forward(ctx, xa, xb, w, b):
        ctx.save_for_backward(xa, xb, w)
        return conv3x3x3_dual(xa, xb, w, b)

    @staticmethod
    def backward(ctx, g):
        xa, xb, w = ctx.saved_tensors
        g = g.to(xa.dtype).contiguous()
        c = xa.shape[-1]
        dxa = conv3x3x3_dx(g, w[:, :c]) if ctx.needs_input_grad[0] else None
        dxb = conv3x3x3_dx(g, w[:, c:]) if ctx.needs_input_grad[1] else None
        dw = torch.cat([conv3x3x3_dw(xa, g), conv3x3x3_dw(xb, g)], dim=1)
        return dxa, dxb, dw, _bias_grad(g)


class ConvS2Fn(torch.autograd.Function):
    """K3 C->2C; backward: K7 (dx), K6 (dW), sum of g (db)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv3x3x3_s2(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = conv3x3x3_s2_dx(g, w) if ctx.needs_input_grad[0] else None
        return dx, conv3x3x3_s2_dw(x, g), _bias_grad(g)


class ConvTrans2xFn(torch.autograd.Function):
    """K4 2C->C; backward: K8 (dx), K9 (dW), sum of g (db)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv_trans2x(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = conv_trans2x_dx(g, w) if ctx.needs_input_grad[0] else None
        return dx, conv_trans2x_dw(x, g), _bias_grad(g)
