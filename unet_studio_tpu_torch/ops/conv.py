"""Convolution kernels of the inference forward: K1 (3x3x3 stride 1, with
its 2C->C dual-input and 1->C entry forms), K3 (3x3x3 stride 2) and K4
(ks2/stride-2 transposed conv), each with its plain PyTorch twin.

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
its CUDA kernel (``csrc/conv.cu``) when it lies on a card; there it
raises on what the kernel does not take.  ``<wrapper>.launches`` counts
the kernel launches.

The twins compute in f32 from the inputs and weights rounded to the
compute dtype, as the kernels do.  With ``atomicAdd`` in the kernels'
stats epilogue the order of that sum changes from run to run, so the
stats agree with the twin's to f32 rounding of a long sum, not bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

KERNEL_CHANNELS = (16, 32, 64)  # C of the levels the kernels serve


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
    # (Co, Ci, kz, ky, kx) -> (kz, ky, kx, Ci, Co): the kernel's tap-major layout
    wk = w.detach().to(dtype=dt).permute(2, 3, 4, 1, 0).contiguous()
    bias = b.detach().to(dtype=torch.float32).contiguous()
    y = torch.empty((d // stride, h // stride, wd // stride, co), dtype=dt, device=xa.device)
    stats = torch.zeros((2, co), dtype=torch.float32, device=xa.device) if want_stats else None
    pa, pb, act = _prologue_args(prologues[0], ci, xa.device)
    if len(xs) == 2:
        xb = xs[1]
        qa, qb, act_b = _prologue_args(prologues[1], ci, xa.device)
    else:
        xb, qa, qb, act_b = None, None, None, 0
    p = _cuda.ptr
    with torch.cuda.device(xa.device):
        rc = _cuda.lib().unet_conv3(
            p(xa), p(pa), p(pb), act, p(xb), p(qa), p(qb), act_b, ci, p(wk), p(bias),
            p(y), p(stats), d, h, wd, co, stride, _cuda.DTYPE_CODES[dt],
            _cuda.stream_ptr(xa),
        )
    _cuda.check(rc, name)
    return (y, stats) if want_stats else y


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def conv3x3x3_s1(x, w, b, *, prologue=None, want_stats=False):
    """K1, C->C: 3x3x3 stride-1 pad-1 conv + bias.  Replaces
    unet_studio_tpu/ops/pallas_conv.py ``_fwd_kernel`` (``conv_s1_packed``)."""
    if x.device.type == "cpu":
        return conv3_plain([x], [prologue], w, b, 1, want_stats)
    out = _launch_conv3([x], [prologue], w, b, 1, want_stats, "conv3x3x3_s1")
    conv3x3x3_s1.launches += 1
    return out


def conv3x3x3_entry(x, w, b, *, want_stats=False):
    """K1, 1->C entry conv on the raw (D, H, W, 1) input.  Replaces
    unet_studio_tpu/ops/packed.py ``conv_entry``, which runs K1's Pallas
    kernel on a lane-padded view of the input."""
    if x.device.type == "cpu":
        return conv3_plain([x], [None], w, b, 1, want_stats)
    out = _launch_conv3([x], [None], w, b, 1, want_stats, "conv3x3x3_entry")
    conv3x3x3_entry.launches += 1
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
    conv3x3x3_dual.launches += 1
    return out


def conv3x3x3_s2(x, w, b, *, prologue=None, want_stats=False):
    """K3, C->2C: 3x3x3 stride-2 pad-1 conv + bias on even D, H, W.
    Replaces unet_studio_tpu/ops/packed.py ``_s2_fwd_kernel``
    (``conv_s2_down``)."""
    if x.device.type == "cpu":
        return conv3_plain([x], [prologue], w, b, 2, want_stats)
    out = _launch_conv3([x], [prologue], w, b, 2, want_stats, "conv3x3x3_s2")
    conv3x3x3_s2.launches += 1
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


WRAPPERS = (conv3x3x3_s1, conv3x3x3_entry, conv3x3x3_dual, conv3x3x3_s2, conv_trans2x)
for _fn in WRAPPERS:
    _fn.launches = 0
