"""The port's CUDA kernels (K1-K4) against their plain PyTorch twins on
the card, at small shapes with odd sizes.  These tests need an NVIDIA
GPU and skip without one; run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest pins JAX to the CPU, and the
machine with the card has no JAX).  ``chip_smoke.py`` repeats these
checks at the flagship shapes.
"""

import numpy as np
import pytest
import torch

from unet_studio_tpu_torch.ops import conv as K
from unet_studio_tpu_torch.ops.reduce import channel_sum_sq, channel_sum_sq_plain

pytestmark = pytest.mark.cuda

# f32 with TF32 off: only the order of the f32 sums differs
F32_TOL = 1e-5
# bf16: both sides take the same bf16-rounded inputs and accumulate in
# f32, but the rounding of the f32 result to bf16 can land one ulp apart
BF16_TOL = 1e-2


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
    a, b = a.float(), b.float()
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


def test_rejects(dev):
    x = torch.zeros((4, 4, 4, 16), device=dev)
    with pytest.raises(ValueError):
        K.conv3x3x3_s1(x.half(), torch.zeros(16, 16, 3, 3, 3, device=dev), torch.zeros(16, device=dev))
    with pytest.raises(ValueError):
        K.conv3x3x3_s2(x[:3], torch.zeros(32, 16, 3, 3, 3, device=dev), torch.zeros(32, device=dev))
    with pytest.raises(ValueError):
        channel_sum_sq(torch.zeros((4, 12), device=dev))
