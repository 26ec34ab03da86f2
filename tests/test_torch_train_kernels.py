"""The training path's backward twins on the CPU.

1. Each autograd Function of the port (its backward runs the kernels'
   twins on the CPU) against ``jax.vjp`` of the JAX package's custom-VJP
   primitive, whose Pallas kernels run in interpret mode: ``conv_s1_p``,
   ``conv_entry_p``, ``conv_s2_p``, ``conv_trans2x_p`` and
   ``instance_norm_packed`` (with ``norm_bwd_sums``), at the shapes of
   tests/test_torch_kernels.py.  The JAX functions take the lane-packed
   ``(D, H*nb, 128)`` view and DHWIO weights, so the test converts.
   Tolerance: max-abs error over the reference's max-abs < 1e-4 (f32).
2. Each Function against plain autograd through its forward twin, and
   the training leaky ReLU's gradient at 0.

Interpret-mode Pallas is unrolled into large XLA programs whose compile
dominates its run time; each reference runs under ``jax.jit`` compiled at
XLA's lowest backend optimisation level and without the CPU fusion
emitters, which cuts that compile to a fraction and computes the same
f32 arithmetic.  Inputs come from a seeded numpy generator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_studio_tpu.ops import packed as P
from unet_studio_tpu.ops import pallas_conv as PC
from unet_studio_tpu_torch.ops import conv as K
from unet_studio_tpu_torch.ops.norm import InstanceNormTrain, instance_norm_train_plain
from unet_studio_tpu_torch.ops.reduce import norm_bwd_sums

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _rel(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _conv_w(w):
    """DHWIO -> (Co, Ci, 3, 3, 3)."""
    return np.ascontiguousarray(np.asarray(w).transpose(4, 3, 0, 1, 2))


def _port_grads(fn, inputs, g):
    y = fn(*inputs)
    y.backward(_t(g))
    return y, [None if t.grad is None else t.grad for t in inputs]


def test_conv_s1_vjp():
    dims, c = (4, 8, 64), 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((*dims, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, c, c)) * 0.1).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    g = rng.standard_normal((*dims, c)).astype(np.float32)

    def ref(x3, w, b, g3):
        _, vjp = jax.vjp(lambda x3, w, b: PC.conv_s1_p(x3, w, b, (*dims, c)), x3, w, b)
        return vjp(g3)

    dx3, dw, db = _jit(ref, P.pack(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b),
                       P.pack(jnp.asarray(g)))
    _, (dx, dwt, dbt) = _port_grads(K.ConvS1Fn.apply, [_t(x, True), _t(_conv_w(w), True),
                                                       _t(b, True)], g)
    assert _rel(dx, P.unpack(dx3, (*dims, c))) < 1e-4
    assert _rel(dwt, _conv_w(dw)) < 1e-4
    assert _rel(dbt, db) < 1e-4


def test_conv_entry_vjp():
    """The entry conv's input needs no gradient: dW and db only."""
    dims, co = (4, 8, 64), 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((*dims, 1)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 1, co)) * 0.3).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    g = rng.standard_normal((*dims, co)).astype(np.float32)

    def ref(x5, w, b, g3):
        _, vjp = jax.vjp(lambda w, b: P.conv_entry_p(x5, w, b, (*dims, 1)), w, b)
        return vjp(g3)

    dw, db = _jit(ref, jnp.asarray(x)[None], jnp.asarray(w), jnp.asarray(b),
                  P.pack(jnp.asarray(g)))
    xt = _t(x)
    _, (dx, dwt, dbt) = _port_grads(K.ConvEntryFn.apply, [xt, _t(_conv_w(w), True),
                                                          _t(b, True)], g)
    assert dx is None
    assert _rel(dwt, _conv_w(dw)) < 1e-4
    assert _rel(dbt, db) < 1e-4


@pytest.mark.parametrize("dims,c", [((4, 8, 64), 16), ((4, 4, 16), 64)])
def test_conv_s2_vjp(dims, c):
    """C -> 2C, 64 -> 128 included (on the flagship path)."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((*dims, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, c, 2 * c)) * 0.1).astype(np.float32)
    b = rng.standard_normal(2 * c).astype(np.float32)
    odims = (dims[0] // 2, dims[1] // 2, dims[2] // 2, 2 * c)
    g = rng.standard_normal(odims).astype(np.float32)

    def ref(x3, w, b, g3):
        _, vjp = jax.vjp(lambda x3, w, b: P.conv_s2_p(x3, w, b, (*dims, c)), x3, w, b)
        return vjp(g3)

    dx3, dw, db = _jit(ref, P.pack(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b),
                       P.pack(jnp.asarray(g)))
    _, (dx, dwt, dbt) = _port_grads(K.ConvS2Fn.apply, [_t(x, True), _t(_conv_w(w), True),
                                                       _t(b, True)], g)
    assert _rel(dx, P.unpack(dx3, (*dims, c))) < 1e-4
    assert _rel(dwt, _conv_w(dw)) < 1e-4
    assert _rel(dbt, db) < 1e-4


def test_conv_trans2x_vjp():
    dims, ci, co = (2, 4, 32), 32, 16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((*dims, ci)).astype(np.float32)
    w = (rng.standard_normal((ci, 2, 2, 2, co)) * 0.2).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    odims = (2 * dims[0], 2 * dims[1], 2 * dims[2], co)
    g = rng.standard_normal(odims).astype(np.float32)

    def ref(x3, w, b, g3):
        _, vjp = jax.vjp(lambda x3, w, b: P.conv_trans2x_p(x3, w, b, (*dims, ci)), x3, w, b)
        return vjp(g3)

    dx3, dw, db = _jit(ref, P.pack(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b),
                       P.pack(jnp.asarray(g)))
    wt = np.ascontiguousarray(w.transpose(0, 4, 1, 2, 3))  # (Ci, Co, 2, 2, 2)
    _, (dx, dwt, dbt) = _port_grads(K.ConvTrans2xFn.apply, [_t(x, True), _t(wt, True),
                                                            _t(b, True)], g)
    assert _rel(dx, P.unpack(dx3, (*dims, ci))) < 1e-4
    assert _rel(dwt, np.asarray(dw).transpose(0, 4, 1, 2, 3)) < 1e-4
    assert _rel(dbt, db) < 1e-4


def test_instance_norm_vjp_and_norm_bwd_sums():
    dims, c = (4, 8, 64), 16
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((*dims, c)) * 2 + 0.5).astype(np.float32)
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    g = (rng.standard_normal((*dims, c)) + 0.3 * x).astype(np.float32)
    mean = x.reshape(-1, c).mean(0)
    inv = (1.0 / np.sqrt(x.reshape(-1, c).var(0) + 1e-5)).astype(np.float32)

    def ref(x3, s, b, g3, mean_l, inv_l):
        _, vjp = jax.vjp(lambda x3, s, b: P.instance_norm_packed(x3, s, b, c), x3, s, b)
        return vjp(g3), P.norm_bwd_sums(g3, x3, mean_l, inv_l)

    (dx3, ds, db), (sg, sgx) = _jit(
        ref, P.pack(jnp.asarray(x)), jnp.asarray(scale), jnp.asarray(bias),
        P.pack(jnp.asarray(g)), jnp.asarray(np.tile(mean, 128 // c)),
        jnp.asarray(np.tile(inv, 128 // c)))
    _, (dx, dst, dbt) = _port_grads(InstanceNormTrain.apply, [_t(x, True), _t(scale, True),
                                                              _t(bias, True)], g)
    assert _rel(dx, P.unpack(dx3, (*dims, c))) < 1e-4
    assert _rel(dst, ds) < 1e-4
    assert _rel(dbt, db) < 1e-4
    sums = norm_bwd_sums(_t(g), _t(x), _t(mean), _t(inv))
    assert _rel(sums[0], np.asarray(sg).reshape(-1, c).sum(0)) < 1e-4
    assert _rel(sums[1], np.asarray(sgx).reshape(-1, c).sum(0)) < 1e-4


def _plain_vs_fn(fn, plain, arrays, g, grad_mask):
    got = [_t(a, m) for a, m in zip(arrays, grad_mask)]
    ref = [_t(a, m) for a, m in zip(arrays, grad_mask)]
    y = fn(*got)
    y.backward(_t(g))
    yr = plain(*ref)
    yr.backward(_t(g))
    assert _rel(y, yr.detach().numpy()) < 1e-5
    for a, r in zip(got, ref):
        if a.requires_grad:
            assert _rel(a.grad, r.grad.numpy()) < 1e-5


@pytest.mark.parametrize("kind", ["s1", "entry", "dual", "s2", "trans", "norm"])
def test_function_matches_plain_autograd(kind):
    """Each Function's backward (the twins of K1 dx, K5-K9 and K2
    norm_bwd) against autograd through the plain forward twin, on odd
    sizes: the same gradients to f32 rounding (1e-5)."""
    rng = np.random.default_rng(7)
    dims, c = (3, 5, 6), 16

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    if kind == "s1":
        args, mask = [r(*dims, c), r(c, c, 3, 3, 3, s=0.1), r(c)], [True] * 3
        fn, plain, g = K.ConvS1Fn.apply, lambda x, w, b: K.conv3_plain([x], [None], w, b, 1), r(*dims, c)
    elif kind == "entry":
        args, mask = [r(*dims, 1), r(c, 1, 3, 3, 3, s=0.3), r(c)], [False, True, True]
        fn, plain, g = K.ConvEntryFn.apply, lambda x, w, b: K.conv3_plain([x], [None], w, b, 1), r(*dims, c)
    elif kind == "dual":
        args, mask = [r(*dims, c), r(*dims, c), r(c, 2 * c, 3, 3, 3, s=0.1), r(c)], [True] * 4
        fn, g = K.ConvDualFn.apply, r(*dims, c)
        plain = lambda xa, xb, w, b: K.conv3_plain([xa, xb], [None, None], w, b, 1)  # noqa: E731
    elif kind == "s2":
        args, mask = [r(4, 6, 2, c), r(2 * c, c, 3, 3, 3, s=0.1), r(2 * c)], [True] * 3
        fn, plain, g = K.ConvS2Fn.apply, lambda x, w, b: K.conv3_plain([x], [None], w, b, 2), r(2, 3, 1, 2 * c)
    elif kind == "trans":
        args, mask = [r(*dims, 2 * c), r(2 * c, c, 2, 2, 2, s=0.2), r(c)], [True] * 3
        fn, plain, g = K.ConvTrans2xFn.apply, K.conv_trans2x_plain, r(6, 10, 12, c)
    else:
        args, mask = [r(*dims, c, s=2.0) + 0.5, r(c) + 1.0, r(c)], [True] * 3
        fn, plain, g = InstanceNormTrain.apply, instance_norm_train_plain, r(*dims, c)
    _plain_vs_fn(fn, plain, args, g, mask)


def test_leaky_relu_gradient_at_zero_is_one():
    x = torch.tensor([-2.0, 0.0, 3.0], dtype=torch.bfloat16, requires_grad=True)
    y = K.activation_train(x, "leaky_relu")
    y.backward(torch.ones_like(y))
    assert torch.equal(y.detach(), K.activation(x.detach(), "leaky_relu"))
    expected = torch.tensor([0.01, 1.0, 1.0], dtype=torch.bfloat16)
    assert torch.equal(x.grad, expected)
