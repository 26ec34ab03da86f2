"""The port's CUDA kernels (K1-K12, all of K2's modes) against their plain
PyTorch twins on the card, at small shapes with odd sizes; bf16 K1, K3,
K4, K5, K6, K7, K8 and K9 run on the tensor-core route (``test_tc_*`` add
whole-tile shapes); K2's modes, the weight gradients, the convs' stats and
K8's dx are bitwise repeatable, K2 on two streams at once too, and need no
zeroed output; the warp takes uint8, int and float labels alike; QC's
device counts equal a host recount, and the atlas resample's bits the
CPU's.  These tests need an NVIDIA GPU and skip without one; run them
there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest pins JAX to the CPU, and the
machine with the card has no JAX).  ``chip_smoke.py`` repeats these
checks at the flagship shapes.
"""

import numpy as np
import pytest
import torch

from unet_studio_tpu_torch.ops import conv as K
from unet_studio_tpu_torch.ops.norm import InstanceNormTrain, instance_norm_train_plain
from unet_studio_tpu_torch.ops import reduce as R
from unet_studio_tpu_torch.ops import resample as RS
from unet_studio_tpu_torch.ops import warp as W
from unet_studio_tpu_torch.ops.reduce import (
    channel_sum_sq,
    channel_sum_sq_plain,
    norm_bwd_sums,
    norm_bwd_sums_plain,
)

pytestmark = pytest.mark.cuda

# f32 with TF32 off: only the order of the f32 sums differs
F32_TOL = 1e-5
# bf16: both sides take the same bf16-rounded inputs and accumulate in
# f32, but the rounding of the f32 result to bf16 can land one ulp apart
BF16_TOL = 1e-2
# f32 weight gradients and K2 sums (any input dtype): f32 sums over the
# volume in another order than the twin's
SUM_TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).to(dev, dtype)


def _pro(rng, c, dev, act):
    return (_t(rng, c, dev, scale=0.5) + 1.0, _t(rng, c, dev, scale=0.5), act)


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,dims,act", [(16, (6, 10, 14), "leaky_relu"),
                                        (32, (5, 6, 9), "relu"),
                                        (64, (4, 4, 6), None)])
def test_s1_and_dual(dev, dtype, c, dims, act):
    rng = np.random.default_rng(c)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    x = _t(rng, (*dims, c), dev, dtype)
    x2 = _t(rng, (*dims, c), dev, dtype)
    w = _t(rng, (c, c, 3, 3, 3), dev, scale=0.1)
    w2 = _t(rng, (c, 2 * c, 3, 3, 3), dev, scale=0.1)
    b = _t(rng, c, dev)
    pro, pro2 = _pro(rng, c, dev, act), _pro(rng, c, dev, "leaky_relu")
    for p in (None, pro):
        y, st = K.conv3x3x3_s1(x, w, b, prologue=p, want_stats=True)
        yr, sr = K.conv3_plain([x], [p], w, b, 1, want_stats=True)
        assert _rel(y, yr) < tol and _rel(st, sr) < 1e-4
    y = K.conv3x3x3_dual(x, x2, w2, b, prologue_a=pro, prologue_b=pro2)
    assert _rel(y, K.conv3_plain([x, x2], [pro, pro2], w2, b, 1)) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entry(dev, dtype):
    rng = np.random.default_rng(1)
    x = _t(rng, (7, 9, 11, 1), dev, dtype)
    w, b = _t(rng, (16, 1, 3, 3, 3), dev, scale=0.3), _t(rng, 16, dev)
    y, st = K.conv3x3x3_entry(x, w, b, want_stats=True)
    yr, sr = K.conv3_plain([x], [None], w, b, 1, want_stats=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(y, yr) < tol and _rel(st, sr) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,dims", [(16, (6, 10, 14)), (64, (4, 6, 8))])
def test_s2(dev, dtype, c, dims):
    rng = np.random.default_rng(c + 2)
    x = _t(rng, (*dims, c), dev, dtype)
    w, b = _t(rng, (2 * c, c, 3, 3, 3), dev, scale=0.1), _t(rng, 2 * c, dev)
    pro = _pro(rng, c, dev, "leaky_relu")
    y, st = K.conv3x3x3_s2(x, w, b, prologue=pro, want_stats=True)
    yr, sr = K.conv3_plain([x], [pro], w, b, 2, want_stats=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert y.shape == (dims[0] // 2, dims[1] // 2, dims[2] // 2, 2 * c)
    assert _rel(y, yr) < tol and _rel(st, sr) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("co,dims", [(16, (3, 5, 7)), (32, (2, 3, 4))])
def test_trans(dev, dtype, co, dims):
    rng = np.random.default_rng(co + 3)
    x = _t(rng, (*dims, 2 * co), dev, dtype)
    w, b = _t(rng, (2 * co, co, 2, 2, 2), dev, scale=0.2), _t(rng, co, dev)
    pro = _pro(rng, 2 * co, dev, "leaky_relu")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for p in (None, pro):
        assert _rel(K.conv_trans2x(x, w, b, prologue=p), K.conv_trans2x_plain(x, w, b, p)) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 64, 128])
def test_sum_sq(dev, dtype, c):
    rng = np.random.default_rng(c)
    x = _t(rng, (5, 7, 9, c), dev, dtype) + 0.5
    assert _rel(channel_sum_sq(x), channel_sum_sq_plain(x)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["s1_16", "s1_32", "s1_64", "entry", "s2_16", "s2_64", "trans"])
def test_weight_gradients(dev, dtype, case):
    """K5 (stride 1, the entry's Ci=1 included), K6 and K9 against the
    per-tap matmul twin."""
    rng = np.random.default_rng(len(case))
    dims = (6, 10, 14)
    half = (3, 5, 7)
    if case.startswith("s1"):
        c = int(case[3:])
        x, g = _t(rng, (*dims, c), dev, dtype), _t(rng, (*dims, c), dev, dtype)
        got, ref = K.conv3x3x3_dw(x, g), K.conv_dw_plain(x, g, 3, 1, 1)
        ref = ref.reshape(3, 3, 3, c, c).permute(4, 3, 0, 1, 2)
    elif case == "entry":
        x, g = _t(rng, (*dims, 1), dev, dtype), _t(rng, (*dims, 16), dev, dtype)
        got = K.conv3x3x3_dw(x, g)
        ref = K.conv_dw_plain(x, g, 3, 1, 1).reshape(3, 3, 3, 1, 16).permute(4, 3, 0, 1, 2)
    elif case.startswith("s2"):
        c = int(case[3:])
        x, g = _t(rng, (*dims, c), dev, dtype), _t(rng, (*half, 2 * c), dev, dtype)
        got = K.conv3x3x3_s2_dw(x, g)
        ref = K.conv_dw_plain(x, g, 3, 2, 1).reshape(3, 3, 3, c, 2 * c).permute(4, 3, 0, 1, 2)
    else:
        x, g = _t(rng, (*half, 32), dev, dtype), _t(rng, (*dims, 16), dev, dtype)
        got = K.conv_trans2x_dw(x, g)
        ref = K.conv_dw_plain(g, x, 2, 2, 0).reshape(2, 2, 2, 16, 32).permute(4, 3, 0, 1, 2)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < SUM_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,c", [("s1", 16), ("s1", 64), ("s2", 16), ("s2", 64),
                                    ("trans", 16), ("trans", 32)])
def test_input_gradients(dev, dtype, kind, c):
    """K1 on g (stride 1), K7 (stride 2, C -> 2C) and K8 (transposed,
    2C -> C) against their twins."""
    rng = np.random.default_rng(c + 9)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if kind == "s1":
        g, w = _t(rng, (5, 6, 9, c), dev, dtype), _t(rng, (c, c, 3, 3, 3), dev, scale=0.1)
        got = K.conv3x3x3_dx(g, w)
        ref = K.conv3_plain([g], [None], K.flip_transpose(w), torch.zeros(c, device=dev), 1)
    elif kind == "s2":
        g, w = _t(rng, (3, 5, 7, 2 * c), dev, dtype), _t(rng, (2 * c, c, 3, 3, 3), dev, scale=0.1)
        got, ref = K.conv3x3x3_s2_dx(g, w), K.conv3_s2_dx_plain(g, w)
        assert got.shape == (6, 10, 14, c)
    else:
        g, w = _t(rng, (6, 10, 14, c), dev, dtype), _t(rng, (2 * c, c, 2, 2, 2), dev, scale=0.2)
        got, ref = K.conv_trans2x_dx(g, w), K.conv_trans2x_dx_plain(g, w)
        assert got.shape == (3, 5, 7, 2 * c)
    assert got.dtype == dtype and _rel(got, ref) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 64, 128])
def test_norm_bwd_sums(dev, dtype, c):
    """g correlated with x and of nonzero mean, so neither sum cancels."""
    rng = np.random.default_rng(c + 1)
    x = _t(rng, (5, 7, 9, c), dev, dtype) + 0.5
    g = (0.5 * x.float() + _t(rng, (5, 7, 9, c), dev) + 0.25).to(dtype)
    st = channel_sum_sq_plain(x)
    n = x.numel() // c
    mean = st[0] / n
    inv = torch.rsqrt((st[1] / n - mean * mean).clamp_min(0) + 1e-5)
    assert _rel(norm_bwd_sums(g, x, mean, inv), norm_bwd_sums_plain(g, x, mean, inv)) < SUM_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["s1", "entry", "dual", "s2", "trans", "norm"])
def test_functions_on_the_card(dev, dtype, kind):
    """Each autograd Function (its forward and backward kernels) against
    autograd through its forward twin.  f32: 1e-4 (the norm's backward
    formula against autograd's chain rule, both in f32).  bf16: the
    conv Functions 1e-2; the norm 4e-2, since its backward runs its
    elementwise steps in bf16, as the JAX VJP does, where the twin's
    autograd runs the statistics' branch in f32."""
    rng = np.random.default_rng(3)
    c, dims = 16, (6, 10, 14)
    tol = F32_TOL * 10 if dtype == torch.float32 else BF16_TOL
    if kind == "norm" and dtype == torch.bfloat16:
        tol = 4e-2

    def r(shape, scale=1.0, dt=torch.float32):
        return _t(rng, shape, dev, dt, scale)

    if kind == "s1":
        args = [r((*dims, c), dt=dtype), r((c, c, 3, 3, 3), 0.1), r(c)]
        fn, plain = K.ConvS1Fn.apply, lambda x, w, b: K.conv3_plain([x], [None], w, b, 1)
    elif kind == "entry":
        args = [r((*dims, 1), dt=dtype), r((c, 1, 3, 3, 3), 0.3), r(c)]
        fn, plain = K.ConvEntryFn.apply, lambda x, w, b: K.conv3_plain([x], [None], w, b, 1)
    elif kind == "dual":
        args = [r((*dims, c), dt=dtype), r((*dims, c), dt=dtype), r((c, 2 * c, 3, 3, 3), 0.1), r(c)]
        fn = K.ConvDualFn.apply
        plain = lambda xa, xb, w, b: K.conv3_plain([xa, xb], [None, None], w, b, 1)  # noqa: E731
    elif kind == "s2":
        args = [r((*dims, c), dt=dtype), r((2 * c, c, 3, 3, 3), 0.1), r(2 * c)]
        fn, plain = K.ConvS2Fn.apply, lambda x, w, b: K.conv3_plain([x], [None], w, b, 2)
    elif kind == "trans":
        args = [r((3, 5, 7, 2 * c), dt=dtype), r((2 * c, c, 2, 2, 2), 0.2), r(c)]
        fn, plain = K.ConvTrans2xFn.apply, K.conv_trans2x_plain
    else:
        args = [r((*dims, c), 2.0, dtype) + 0.5, r(c) + 1.0, r(c)]
        fn, plain = InstanceNormTrain.apply, instance_norm_train_plain
    mine = [a.clone().requires_grad_(kind != "entry" or i > 0) for i, a in enumerate(args)]
    ref = [a.clone().requires_grad_(kind != "entry" or i > 0) for i, a in enumerate(args)]
    y = fn(*mine)
    yr = plain(*ref)
    gy = r(tuple(y.shape), dt=y.dtype)
    y.backward(gy)
    yr.backward(gy)
    assert _rel(y, yr) < tol
    for a, b in zip(mine, ref):
        if a.requires_grad:
            assert a.grad.dtype == b.grad.dtype
            assert _rel(a.grad, b.grad) < tol


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("dims", [(5, 10, 14), (4, 16, 32)])
def test_tc_s1(dev, c, act, dims):
    """bf16 K1 C->C on the tensor-core route, ragged and whole tiles, with
    and without the prologue and the stats."""
    rng = np.random.default_rng(c + len(act or ""))
    x = _t(rng, (*dims, c), dev, torch.bfloat16)
    w, b = _t(rng, (c, c, 3, 3, 3), dev, scale=0.1), _t(rng, c, dev)
    pro = None if act is None else _pro(rng, c, dev, act)
    n0 = K.conv3x3x3_s1.tc_launches
    y, st = K.conv3x3x3_s1(x, w, b, prologue=pro, want_stats=True)
    yr, sr = K.conv3_plain([x], [pro], w, b, 1, want_stats=True)
    assert _rel(y, yr) < BF16_TOL and _rel(st, sr) < 1e-4
    y = K.conv3x3x3_s1(x, w, b, prologue=pro)
    assert _rel(y, yr) < BF16_TOL
    assert K.conv3x3x3_s1.tc_launches == n0 + 2


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("dims", [(3, 5, 7), (2, 8, 16)])
def test_tc_dual_and_dx(dev, c, dims):
    """bf16 K1 2C->C (a prologue on one input, none on the other) and K1
    as dx on g with flipped, transposed weights, on the tensor cores."""
    rng = np.random.default_rng(c + 5)
    xa, xb = (_t(rng, (*dims, c), dev, torch.bfloat16) for _ in range(2))
    w, b = _t(rng, (c, 2 * c, 3, 3, 3), dev, scale=0.1), _t(rng, c, dev)
    pro = _pro(rng, c, dev, "leaky_relu")
    n_dual, n_dx = K.conv3x3x3_dual.tc_launches, K.conv3x3x3_dx.tc_launches
    y = K.conv3x3x3_dual(xa, xb, w, b, prologue_a=pro)
    assert _rel(y, K.conv3_plain([xa, xb], [pro, None], w, b, 1)) < BF16_TOL
    ws = w[:, :c]
    dx = K.conv3x3x3_dx(xa, ws)
    ref = K.conv3_plain([xa], [None], K.flip_transpose(ws), torch.zeros(c, device=dev), 1)
    assert _rel(dx, ref) < BF16_TOL
    assert (K.conv3x3x3_dual.tc_launches, K.conv3x3x3_dx.tc_launches) == (n_dual + 1, n_dx + 1)


@pytest.mark.parametrize("co", [16, 32, 64])
@pytest.mark.parametrize("dims", [(7, 9, 11), (4, 16, 32)])
def test_tc_entry(dev, co, dims):
    rng = np.random.default_rng(co)
    x = _t(rng, (*dims, 1), dev, torch.bfloat16)
    w, b = _t(rng, (co, 1, 3, 3, 3), dev, scale=0.3), _t(rng, co, dev)
    n0 = K.conv3x3x3_entry.tc_launches
    y, st = K.conv3x3x3_entry(x, w, b, want_stats=True)
    yr, sr = K.conv3_plain([x], [None], w, b, 1, want_stats=True)
    assert _rel(y, yr) < BF16_TOL and _rel(st, sr) < 1e-4
    assert K.conv3x3x3_entry.tc_launches == n0 + 1


@pytest.mark.parametrize("ci,co", [(16, 32), (32, 64), (64, 128)])
@pytest.mark.parametrize("half", [(3, 5, 7), (1, 4, 16), (2, 6, 17)])
def test_tc_s2_dx(dev, ci, co, half):
    """bf16 K7 on the tensor cores: odd and whole-tile g grids; the odd dx
    voxels at the high end read g past its end as 0."""
    rng = np.random.default_rng(ci + sum(half))
    g, w = _t(rng, (*half, co), dev, torch.bfloat16), _t(rng, (co, ci, 3, 3, 3), dev, scale=0.1)
    n0 = K.conv3x3x3_s2_dx.tc_launches
    got, ref = K.conv3x3x3_s2_dx(g, w), K.conv3_s2_dx_plain(g, w)
    assert got.shape == (2 * half[0], 2 * half[1], 2 * half[2], ci)
    assert _rel(got, ref) < BF16_TOL
    # the last odd plane along each axis (dx = 2 OD - 1) alone
    assert _rel(got[-1], ref[-1]) < BF16_TOL and _rel(got[:, :, -1], ref[:, :, -1]) < BF16_TOL
    assert K.conv3x3x3_s2_dx.tc_launches == n0 + 1


def test_tc_rejects(dev):
    """bf16 tensors the tensor-core route has no kernel for raise; f32 of
    the same shapes keeps the FMA route."""
    bf = torch.bfloat16
    x = torch.zeros((4, 4, 4, 16), device=dev, dtype=bf)
    with pytest.raises(ValueError):
        K.conv3x3x3_s1(x, torch.zeros(32, 16, 3, 3, 3, device=dev), torch.zeros(32, device=dev))
    with pytest.raises(ValueError):
        K.conv3x3x3_s1(torch.zeros((4, 4, 4, 128), device=dev, dtype=bf),
                       torch.zeros(128, 128, 3, 3, 3, device=dev), torch.zeros(128, device=dev))
    with pytest.raises(ValueError):
        K.conv3x3x3_entry(x[..., :1].contiguous(), torch.zeros(48, 1, 3, 3, 3, device=dev),
                          torch.zeros(48, device=dev))
    with pytest.raises(ValueError):
        K.conv3x3x3_s2_dx(torch.zeros((2, 2, 2, 16), device=dev, dtype=bf),
                          torch.zeros(16, 16, 3, 3, 3, device=dev))
    # K3 and K6 off TC_S2 (no FMA fallback in bf16)
    n3, n6 = K.conv3x3x3_s2.launches, K.conv3x3x3_s2_dw.launches
    for ci, co in ((16, 16), (32, 32), (16, 64), (64, 64), (128, 256)):
        xs = torch.zeros((4, 4, 4, ci), device=dev, dtype=bf)
        with pytest.raises(ValueError):
            K.conv3x3x3_s2(xs, torch.zeros(co, ci, 3, 3, 3, device=dev),
                           torch.zeros(co, device=dev))
        with pytest.raises(ValueError):
            K.conv3x3x3_s2_dw(xs, torch.zeros((2, 2, 2, co), device=dev, dtype=bf))
    assert (K.conv3x3x3_s2.launches, K.conv3x3x3_s2_dw.launches) == (n3, n6)
    # K4 and K9 off TC_TRANS (no FMA fallback in bf16)
    n4, n9 = K.conv_trans2x.launches, K.conv_trans2x_dw.launches
    for ci, co in ((16, 16), (32, 32), (128, 64), (64, 16)):
        xt = torch.zeros((2, 2, 2, ci), device=dev, dtype=bf)
        with pytest.raises(ValueError):
            K.conv_trans2x(xt, torch.zeros(ci, co, 2, 2, 2, device=dev), torch.zeros(co, device=dev))
        with pytest.raises(ValueError):
            K.conv_trans2x_dw(xt, torch.zeros((4, 4, 4, co), device=dev, dtype=bf))
    assert (K.conv_trans2x.launches, K.conv_trans2x_dw.launches) == (n4, n9)
    n0 = K.conv3x3x3_s1.tc_launches
    K.conv3x3x3_s1(x.float(), torch.zeros(32, 16, 3, 3, 3, device=dev), torch.zeros(32, device=dev))
    assert K.conv3x3x3_s1.tc_launches == n0
    t4 = K.conv_trans2x.tc_launches
    K.conv_trans2x(torch.zeros((2, 2, 2, 32), device=dev), torch.zeros(32, 16, 2, 2, 2, device=dev),
                   torch.zeros(16, device=dev))
    assert K.conv_trans2x.tc_launches == t4
    # K8 off TC_TRANS (no FMA fallback in bf16); f32 keeps the FMA kernel
    n8, t8 = K.conv_trans2x_dx.launches, K.conv_trans2x_dx.tc_launches
    for ci, co in ((16, 16), (32, 32), (128, 64), (64, 16)):
        with pytest.raises(ValueError):
            K.conv_trans2x_dx(torch.zeros((4, 4, 4, co), device=dev, dtype=bf),
                              torch.zeros(ci, co, 2, 2, 2, device=dev))
    assert (K.conv_trans2x_dx.launches, K.conv_trans2x_dx.tc_launches) == (n8, t8)
    K.conv_trans2x_dx(torch.zeros((4, 4, 4, 16), device=dev), torch.zeros(32, 16, 2, 2, 2, device=dev))
    assert (K.conv_trans2x_dx.launches, K.conv_trans2x_dx.tc_launches) == (n8 + 1, t8)


def test_backward_rejects(dev):
    x = torch.zeros((4, 4, 4, 16), device=dev)
    with pytest.raises(ValueError):
        K.conv3x3x3_dw(x, torch.zeros((4, 4, 4, 16), device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        K.conv3x3x3_s2_dw(x, torch.zeros((3, 2, 2, 32), device=dev))
    with pytest.raises(ValueError):
        K.conv_trans2x_dx(torch.zeros((3, 4, 4, 16), device=dev), torch.zeros(32, 16, 2, 2, 2, device=dev))
    with pytest.raises(ValueError):
        norm_bwd_sums(x, x[:2], torch.zeros(16, device=dev), torch.ones(16, device=dev))


def test_rejects(dev):
    x = torch.zeros((4, 4, 4, 16), device=dev)
    with pytest.raises(ValueError):
        K.conv3x3x3_s1(x.half(), torch.zeros(16, 16, 3, 3, 3, device=dev), torch.zeros(16, device=dev))
    with pytest.raises(ValueError):
        K.conv3x3x3_s2(x[:3], torch.zeros(32, 16, 3, 3, 3, device=dev), torch.zeros(32, device=dev))
    with pytest.raises(ValueError):
        channel_sum_sq(torch.zeros((4, 12), device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 128])
def test_sum_and_sqdiff(dev, dtype, c):
    rng = np.random.default_rng(c)
    x = _t(rng, (5, 7, 9, c), dev, dtype) + 0.5
    assert _rel(R.channel_sum(x), R.channel_sum_plain(x)) < SUM_TOL
    mean = R.channel_sum_plain(x) / (5 * 7 * 9)
    assert _rel(R.channel_sqdiff(x, mean), R.channel_sqdiff_plain(x, mean)) < SUM_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 9, 11), (192, 224, 192), (3,)])
def test_volume_max(dev, dtype, shape):
    """Exact, from a zero accumulator: an all-negative volume gives 0; the
    odd sizes run the scalar tail."""
    rng = np.random.default_rng(len(shape))
    x = _t(rng, shape, dev, dtype)
    assert float(R.volume_max(x)) == float(R.volume_max_plain(x))
    assert float(R.volume_max(-x.abs() - 1)) == 0.0


def _warp_field(shape, dev, worst: bool):
    """Coordinates of a moderate affine with a smooth wiggle, or of the
    worst default-options draw, where the window clamps taps."""
    grid = RS.meshgrid_xyz(shape)
    if worst:
        m = RS.affine_matrix(rotation=(0.2, 0.2, 0.2), scaling=(1.5625,) * 3, shape_dhw=shape)
        coords = RS.apply_affine(grid + 2.0 * torch.sin(grid * 0.3), m)
    else:
        m = RS.affine_matrix(translation=(1.2, -0.7, 0.4), rotation=(0.1, -0.15, 0.2),
                             scaling=(1.1, 0.9, 1.05), shape_dhw=shape)
        coords = RS.apply_affine(grid + 0.7 * torch.sin(grid * 0.4), m)
    return coords.to(dev)


@pytest.mark.parametrize("window,shape,worst", [
    (w, shape, worst) for w in (True, False)
    for shape, worst in (((12, 14, 16), False), ((12, 20, 16), False), ((24, 32, 28), True),
                         ((48, 56, 48), False))
] + [(False, (9, 13, 11), False), (False, (7, 5, 19), True)])
def test_warp(dev, window, shape, worst):
    """Labels exactly and the image to f32 rounding of its peak, in both
    modes and both semantics (odd sizes without the window; the stamp grid
    48x56x48), the label as uint8 (the train path's type), int and float
    alike."""
    rng = np.random.default_rng(sum(shape))
    img = torch.tensor(rng.random(shape, np.float32) * 2.5).to(dev)
    lab = torch.tensor((rng.random(shape) * 6).astype(np.float32) // 1).to(dev)
    coords = _warp_field(shape, dev, worst)
    ki, kl = W.warp_image_label(img, lab.to(torch.uint8), coords, window)
    ti, tl = W.warp_image_label_plain(img, lab, coords, window)
    assert torch.equal(kl, tl)
    assert float((ki - ti).abs().max()) <= 1e-6 * float(ti.abs().max())
    for other in (lab, lab.long()):
        oi, ol = W.warp_image_label(img, other, coords, window)
        assert torch.equal(oi, ki) and torch.equal(ol, kl)
    kv, tv = W.warp_linear(img, coords, window), W.warp_linear_plain(img, coords, window)
    assert float((kv - tv).abs().max()) <= 1e-6 * float(tv.abs().max())


def test_warp_rejects(dev):
    """Labels of 256 or more (float, int, or rounding up to 256) and
    negative labels raise; so do odd sizes with the window and other
    dtypes."""
    img = torch.zeros((8, 8, 8), device=dev)
    coords = torch.zeros((8, 8, 8, 3), device=dev)
    for bad in (img + 256, (img + 300).long(), img + 255.5):
        with pytest.raises(ValueError, match="labels must be below 256"):
            W.warp_image_label(img, bad, coords, True)
    with pytest.raises(ValueError, match="labels must not be negative"):
        W.warp_image_label(img, img - 1, coords, True)
    with pytest.raises(ValueError):
        W.warp_linear(img[:7].contiguous(), coords, True)
    with pytest.raises(ValueError):
        W.warp_linear(img, coords[:, :, :7].contiguous(), True)
    with pytest.raises(ValueError):
        W.warp_linear(img.double(), coords, False)


@pytest.mark.parametrize("ci,co", [(1, 16), (16, 16), (32, 32), (64, 64), (1, 32), (16, 64)])
@pytest.mark.parametrize("dims", [(5, 10, 14), (3, 5, 7), (2, 6, 17), (4, 16, 32), (6, 20, 40)])
def test_tc_dw(dev, ci, co, dims):
    """bf16 K5 on the tensor cores against the per-tap matmul twin, ragged
    and whole tiles, and tiles whose halo lies inside the volume (6, 20,
    40); two launches give the same bits; tc_launches counts."""
    rng = np.random.default_rng(ci + co + sum(dims))
    x = _t(rng, (*dims, ci), dev, torch.bfloat16)
    g = _t(rng, (*dims, co), dev, torch.bfloat16)
    n0, t0 = K.conv3x3x3_dw.launches, K.conv3x3x3_dw.tc_launches
    got = K.conv3x3x3_dw(x, g)
    ref = K.conv_dw_plain(x, g, 3, 1, 1).reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2)
    assert got.dtype == torch.float32 and got.shape == (co, ci, 3, 3, 3)
    assert _rel(got, ref) < SUM_TOL
    assert torch.equal(got, K.conv3x3x3_dw(x, g))
    assert (K.conv3x3x3_dw.launches, K.conv3x3x3_dw.tc_launches) == (n0 + 2, t0 + 2)


def test_tc_dw_rejects(dev):
    """bf16 channel counts without a tensor-core dW instance raise (no FMA
    fallback); f32 keeps the FMA kernel and is not counted as tc."""
    bf = torch.bfloat16
    x = torch.zeros((4, 4, 4, 48), device=dev, dtype=bf)
    with pytest.raises(ValueError):
        K.conv3x3x3_dw(x, torch.zeros((4, 4, 4, 16), device=dev, dtype=bf))
    with pytest.raises(ValueError):
        K.conv3x3x3_dw(x[..., :16].contiguous(), torch.zeros((4, 4, 4, 128), device=dev, dtype=bf))
    t0 = K.conv3x3x3_dw.tc_launches
    K.conv3x3x3_dw(torch.zeros((4, 4, 4, 16), device=dev), torch.zeros((4, 4, 4, 16), device=dev))
    assert K.conv3x3x3_dw.tc_launches == t0


def _poisoned(fn, rows: int, c: int):
    """Call ``fn`` right after freeing a NaN-filled block of the size of its
    output, which the caching allocator hands out again, with the partial
    scratch NaN-filled too: the kernel must write every value itself."""
    for buf in R._scratch.values():
        buf.fill_(float("nan"))
    junk = torch.full((rows * c,), float("nan"), device="cuda")
    del junk
    return fn()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,dims", [(16, (5, 7, 9)), (64, (6, 10, 14)), (128, (3, 5, 7)),
                                    (16, (96, 112, 96))])
def test_k2_modes_repeatable(dev, dtype, c, dims):
    """K2 sum, sum_sq, sqdiff and norm_bwd against their twins, bitwise the
    same over two runs, into an output that was not zeroed."""
    rng = np.random.default_rng(c + len(dims))
    x = _t(rng, (*dims, c), dev, dtype) + 0.5
    g = (0.5 * x.float() + _t(rng, (*dims, c), dev) + 0.25).to(dtype)
    n = x.numel() // c
    st = channel_sum_sq_plain(x)
    mean = st[0] / n
    inv = torch.rsqrt((st[1] / n - mean * mean).clamp_min(0) + 1e-5)
    cases = (
        (1, lambda: R.channel_sum(x), lambda: R.channel_sum_plain(x)),
        (2, lambda: R.channel_sum_sq(x), lambda: R.channel_sum_sq_plain(x)),
        (1, lambda: R.channel_sqdiff(x, mean), lambda: R.channel_sqdiff_plain(x, mean)),
        (2, lambda: R.norm_bwd_sums(g, x, mean, inv),
         lambda: R.norm_bwd_sums_plain(g, x, mean, inv)),
    )
    for rows, fn, plain in cases:
        first = _poisoned(fn, rows, c)
        assert bool(torch.isfinite(first).all())
        assert _rel(first, plain()) < SUM_TOL
        assert torch.equal(first, _poisoned(fn, rows, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 9, 11), (192, 224, 192), (5,)])
def test_volume_max_repeatable(dev, dtype, shape):
    """K2 max exact, into an output that was not zeroed; an all-negative
    volume gives 0."""
    rng = np.random.default_rng(len(shape) + 7)
    x = _t(rng, shape, dev, dtype)
    assert float(_poisoned(lambda: R.volume_max(x), 1, 1)) == float(R.volume_max_plain(x))
    assert float(_poisoned(lambda: R.volume_max(-x.abs() - 1), 1, 1)) == 0.0


@pytest.mark.parametrize("ci,co", [(16, 32), (32, 64), (64, 128)])
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("dims", [(6, 10, 14), (4, 8, 32), (2, 18, 66)])
def test_tc_s2(dev, ci, co, act, dims):
    """bf16 K3 on the tensor cores (Co = 128 in two channel slices):
    ragged and whole tiles, with and without the prologue and the stats;
    tc_launches counts."""
    rng = np.random.default_rng(ci + len(act or "") + sum(dims))
    x = _t(rng, (*dims, ci), dev, torch.bfloat16)
    w, b = _t(rng, (co, ci, 3, 3, 3), dev, scale=0.1), _t(rng, co, dev)
    pro = None if act is None else _pro(rng, ci, dev, act)
    n0, t0 = K.conv3x3x3_s2.launches, K.conv3x3x3_s2.tc_launches
    y, st = K.conv3x3x3_s2(x, w, b, prologue=pro, want_stats=True)
    yr, sr = K.conv3_plain([x], [pro], w, b, 2, want_stats=True)
    assert y.shape == (dims[0] // 2, dims[1] // 2, dims[2] // 2, co)
    assert _rel(y, yr) < BF16_TOL and _rel(st, sr) < 1e-4
    assert _rel(K.conv3x3x3_s2(x, w, b, prologue=pro), yr) < BF16_TOL
    assert (K.conv3x3x3_s2.launches, K.conv3x3x3_s2.tc_launches) == (n0 + 2, t0 + 2)


@pytest.mark.parametrize("ci,co", [(16, 32), (32, 64), (64, 128)])
@pytest.mark.parametrize("half", [(3, 5, 7), (2, 6, 17), (1, 4, 16), (3, 10, 20)])
def test_tc_s2_dw(dev, ci, co, half):
    """bf16 K6 on the tensor cores against the per-tap matmul twin, ragged
    and whole tiles and tiles whose halo lies inside the volume (3, 10,
    20); two launches give the same bits; tc_launches counts."""
    rng = np.random.default_rng(ci + co + sum(half))
    x = _t(rng, (2 * half[0], 2 * half[1], 2 * half[2], ci), dev, torch.bfloat16)
    g = _t(rng, (*half, co), dev, torch.bfloat16)
    n0, t0 = K.conv3x3x3_s2_dw.launches, K.conv3x3x3_s2_dw.tc_launches
    got = K.conv3x3x3_s2_dw(x, g)
    ref = K.conv_dw_plain(x, g, 3, 2, 1).reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2)
    assert got.dtype == torch.float32 and got.shape == (co, ci, 3, 3, 3)
    assert _rel(got, ref) < SUM_TOL
    assert torch.equal(got, K.conv3x3x3_s2_dw(x, g))
    assert (K.conv3x3x3_s2_dw.launches, K.conv3x3x3_s2_dw.tc_launches) == (n0 + 2, t0 + 2)


@pytest.mark.parametrize("ci,co", [(32, 16), (64, 32)])
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("dims", [(3, 5, 7), (2, 3, 17), (2, 4, 32), (1, 3, 34)])
def test_tc_trans(dev, ci, co, act, dims):
    """bf16 K4 on the tensor cores: ragged and whole k-rows (W = 7, 17, 32,
    34), with and without each prologue act; tc_launches counts."""
    rng = np.random.default_rng(ci + len(act or "") + sum(dims))
    x = _t(rng, (*dims, ci), dev, torch.bfloat16)
    w, b = _t(rng, (ci, co, 2, 2, 2), dev, scale=0.2), _t(rng, co, dev)
    pro = None if act is None else _pro(rng, ci, dev, act)
    n0, t0 = K.conv_trans2x.launches, K.conv_trans2x.tc_launches
    y = K.conv_trans2x(x, w, b, prologue=pro)
    assert y.shape == (2 * dims[0], 2 * dims[1], 2 * dims[2], co)
    assert _rel(y, K.conv_trans2x_plain(x, w, b, pro)) < BF16_TOL
    assert (K.conv_trans2x.launches, K.conv_trans2x.tc_launches) == (n0 + 1, t0 + 1)


@pytest.mark.parametrize("ci,co", [(32, 16), (64, 32)])
@pytest.mark.parametrize("dims", [(3, 5, 7), (2, 3, 17), (2, 4, 32), (1, 3, 34), (2, 2, 20)])
def test_tc_trans_dx(dev, ci, co, dims):
    """bf16 K8 on the tensor cores against its twin: ragged and whole dx
    k-rows (W = 7, 17, 32, 34, 20); two launches give the same bits;
    tc_launches counts."""
    rng = np.random.default_rng(ci + 2 * co + sum(dims))
    g = _t(rng, (2 * dims[0], 2 * dims[1], 2 * dims[2], co), dev, torch.bfloat16)
    w = _t(rng, (ci, co, 2, 2, 2), dev, scale=0.2)
    n0, t0 = K.conv_trans2x_dx.launches, K.conv_trans2x_dx.tc_launches
    dx = K.conv_trans2x_dx(g, w)
    assert dx.dtype == torch.bfloat16 and dx.shape == (*dims, ci)
    assert _rel(dx, K.conv_trans2x_dx_plain(g, w)) < BF16_TOL
    assert torch.equal(dx, K.conv_trans2x_dx(g, w))
    assert (K.conv_trans2x_dx.launches, K.conv_trans2x_dx.tc_launches) == (n0 + 2, t0 + 2)


@pytest.mark.parametrize("ci,co", [(32, 16), (64, 32)])
def test_tc_trans_dx_in_the_function(dev, ci, co):
    """ConvTrans2xFn's backward in bf16 launches K8 on the tensor cores
    only (tc_launches == launches), and its dx equals K8's."""
    rng = np.random.default_rng(ci)
    x = _t(rng, (3, 4, 9, ci), dev, torch.bfloat16).requires_grad_()
    w, b = _t(rng, (ci, co, 2, 2, 2), dev, scale=0.2), _t(rng, co, dev)
    gy = _t(rng, (6, 8, 18, co), dev, torch.bfloat16)
    n0, t0 = K.conv_trans2x_dx.launches, K.conv_trans2x_dx.tc_launches
    K.ConvTrans2xFn.apply(x, w, b).backward(gy)
    assert K.conv_trans2x_dx.launches - n0 == K.conv_trans2x_dx.tc_launches - t0 == 1
    assert torch.equal(x.grad, K.conv_trans2x_dx(gy, w))


@pytest.mark.parametrize("ci,co", [(32, 16), (64, 32)])
@pytest.mark.parametrize("dims", [(3, 5, 7), (2, 3, 17), (2, 4, 32), (5, 6, 34)])
def test_tc_trans_dw(dev, ci, co, dims):
    """bf16 K9 on the tensor cores against the per-tap matmul twin (x and
    g swapped), ragged k-rows and a ragged last tile; two launches give
    the same bits; tc_launches counts."""
    rng = np.random.default_rng(ci + co + sum(dims))
    x = _t(rng, (*dims, ci), dev, torch.bfloat16)
    g = _t(rng, (2 * dims[0], 2 * dims[1], 2 * dims[2], co), dev, torch.bfloat16)
    n0, t0 = K.conv_trans2x_dw.launches, K.conv_trans2x_dw.tc_launches
    got = K.conv_trans2x_dw(x, g)
    ref = K.conv_dw_plain(g, x, 2, 2, 0).reshape(2, 2, 2, co, ci).permute(4, 3, 0, 1, 2)
    assert got.dtype == torch.float32 and got.shape == (ci, co, 2, 2, 2)
    assert _rel(got, ref) < SUM_TOL
    assert torch.equal(got, K.conv_trans2x_dw(x, g))
    assert (K.conv_trans2x_dw.launches, K.conv_trans2x_dw.tc_launches) == (n0 + 2, t0 + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,c", [("s1", 16), ("s1", 32), ("s1", 64), ("entry", 16),
                                    ("entry", 64), ("s2", 16), ("s2", 64)])
def test_conv_stats_repeatable(dev, dtype, kind, c):
    """(y, stats) of K1 s1, K1 entry and K3 are the same bits over two
    calls (the stats fold in a fixed order, no atomics), the second into
    freed NaN-filled memory, and agree with the twin's stats."""
    rng = np.random.default_rng(c + len(kind))
    dims = (6, 20, 36) if kind != "s2" else (8, 20, 36)
    ci = 1 if kind == "entry" else c
    co = 2 * c if kind == "s2" else c
    x = _t(rng, (*dims, ci), dev, dtype) + 0.25
    w, b = _t(rng, (co, ci, 3, 3, 3), dev, scale=0.1), _t(rng, co, dev)
    pro = None if kind == "entry" else _pro(rng, ci, dev, "leaky_relu")
    if kind == "s1":
        fn = lambda: K.conv3x3x3_s1(x, w, b, prologue=pro, want_stats=True)  # noqa: E731
    elif kind == "entry":
        fn = lambda: K.conv3x3x3_entry(x, w, b, want_stats=True)  # noqa: E731
    else:
        fn = lambda: K.conv3x3x3_s2(x, w, b, prologue=pro, want_stats=True)  # noqa: E731
    y1, s1 = fn()
    junk = torch.full((1 << 20,), float("nan"), device=dev)
    del junk
    y2, s2 = fn()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    _, sr = K.conv3_plain([x], [pro], w, b, 2 if kind == "s2" else 1, want_stats=True)
    assert _rel(s1, sr) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_two_streams(dev, dtype):
    """K2 launched on two streams at once (every mode, many launches each,
    no sync between them) gives, on each stream, the bits of the same
    calls on one stream: each stream has its own ticket and partials."""
    rng = np.random.default_rng(11)
    xs = [_t(rng, (24, 56, 48, 16), dev, dtype) + 0.5 for _ in range(2)]
    gs = [(0.5 * x.float() + _t(rng, tuple(x.shape), dev) + 0.25).to(dtype) for x in xs]
    stats = [channel_sum_sq_plain(x) for x in xs]
    n = xs[0].numel() // 16
    means = [st[0] / n for st in stats]
    invs = [torch.rsqrt((st[1] / n - m * m).clamp_min(0) + 1e-5) for st, m in zip(stats, means)]

    def calls(i):
        x, g, m, iv = xs[i], gs[i], means[i], invs[i]
        return [R.channel_sum_sq(x), R.channel_sum(x), R.channel_sqdiff(x, m),
                R.norm_bwd_sums(g, x, m, iv), R.volume_max(x)]

    want = [calls(i) for i in range(2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    got = [[], []]
    for _ in range(8):  # interleaved, so the two streams' launches overlap
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(calls(i))
    torch.cuda.synchronize()
    for i in range(2):
        for rep in got[i]:
            assert all(torch.equal(a, b) for a, b in zip(rep, want[i]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qc_counts_vs_host_recount(dev, dtype):
    """QC's device counts (the flagship forward at 64^3 through K1-K4,
    argmax, one integer bincount) equal a numpy recount from the same
    logits; cuDNN (the C >= 128 levels) runs its deterministic algorithms,
    so the two forwards give the same bits."""
    from unet_studio_tpu_torch.engine.qc import host_counts, qc_counts
    from unet_studio_tpu_torch.models.dsl import default_architecture
    from unet_studio_tpu_torch.models.unet3d import UNet3d, forward_fused

    model = UNet3d.create(1, 3, default_architecture(3), seed=0, device=dev)
    rng = np.random.default_rng(5)
    img = torch.tensor(rng.random((64, 64, 64), np.float32), device=dev)
    lab = torch.tensor(rng.integers(-1, 4, (64, 64, 64)).astype(np.float32), device=dev)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts = qc_counts(model, img, lab, 0, dtype).cpu().numpy()
        with torch.no_grad():
            logits = forward_fused(model.spec, model.params(), img[None, ..., None],
                                   compute_dtype=dtype, level0_only=True)[0][0]
    finally:
        torch.backends.cudnn.deterministic = was
    voxels, wrong = host_counts(logits.cpu().numpy(), lab.cpu().numpy(), 3)
    np.testing.assert_array_equal(counts[0, :3], voxels)
    np.testing.assert_array_equal(counts[1, :3], wrong)
    assert counts[0].sum() == 64 ** 3 and counts[1, 3] == 0 and wrong.sum() > 0


def test_atlas_resample_card_vs_cpu(dev, tmp_path):
    """The atlas's majority resample (an atlas on a shifted 1.1 mm grid)
    and the corrected atlas built from it: the card's bits equal the
    CPU's."""
    from unet_studio_tpu_torch.engine.atlas import AtlasParcellation
    from unet_studio_tpu_torch.io.nifti import write_nifti

    rng = np.random.default_rng(9)
    z, y, x = np.mgrid[0:40, 0:40, 0:40]
    r = np.sqrt((z - 20) ** 2 + (y - 20) ** 2 + (x - 20) ** 2)
    tissue = np.where(r < 16, 1 + (x > 20) + (z > 24), 0).astype(np.int16)
    tissue[r < 5] = 5  # CSF, dropped on load
    write_nifti(str(tmp_path / "t.nii.gz"), tissue, is_mni=True)
    atlas = rng.integers(0, 7, (6, 6, 6)).repeat(6, 0).repeat(6, 1).repeat(6, 2)
    aff = np.diag([1.1, 1.1, 1.1, 1.0])
    aff[:3, 3] = [0.7, -0.4, 0.3]
    write_nifti(str(tmp_path / "a.nii.gz"), atlas.astype(np.int16), (1.1, 1.1, 1.1), aff,
                is_mni=True)
    out = []
    for where in (dev, "cpu"):
        parc = AtlasParcellation(cache_dir=str(tmp_path / str(where)), device=where)
        assert parc.load_template(str(tmp_path / "t.nii.gz"))
        assert parc.load_atlas(str(tmp_path / "a.nii.gz")), parc.error_msg
        out.append(parc)
    np.testing.assert_array_equal(out[0].atlas, out[1].atlas)
    assert out[0].atlas_region_count == 6
