"""The port's loss and optimizer against the JAX package's, on the CPU.

* ``calc_losses`` (with and without class collapse, 5-D logits and
  channel-leading planes) and ``deep_supervision_loss``: values and the
  gradients with respect to the logits, from seeded numpy inputs with
  out-of-range (ignored) targets.  Tolerance: 1e-5 of the largest value
  (f32; the two sum in other orders).
* Three ``sgd_step``s with clipping active and both weight-decay groups,
  and ``poly_lr``: parameters and momentum to f32 rounding (1e-6 of the
  largest value); the JAX state converted by ``from_jax_opt_state``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_studio_tpu.engine import optimizer as JO
from unet_studio_tpu.ops import losses as JL
from unet_studio_tpu_torch.engine import optimizer as TO
from unet_studio_tpu_torch.models.dsl import parse_architecture
from unet_studio_tpu_torch.models.serialize import from_jax_opt_state
from unet_studio_tpu_torch.ops import losses as TL

# The JAX references run under one jit compiled at XLA's lowest backend
# optimisation level without the CPU fusion emitters: eager, each of their
# many small ops compiles apart.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _case(seed, n=2, c=4, dhw=(6, 5, 8)):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, *dhw, c)) * 2).astype(np.float32)
    target = rng.integers(0, c + 2, (n, *dhw)).astype(np.int32)  # >= c: ignored
    return logits, target


@pytest.mark.parametrize("collapse", [0, 2])
@pytest.mark.parametrize("planes", [False, True])
def test_calc_losses(collapse, planes):
    logits, target = _case(1 + collapse)
    c = logits.shape[-1]

    def jax_total(lg):
        ce, dice, mse = JL.calc_losses(lg, jnp.asarray(target), c, collapse)
        return ce + 2 * dice + 3 * mse, (ce, dice, mse)

    (_, ref), ref_g = _jit(jax.value_and_grad(jax_total, has_aux=True), jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    arg = TL.ChannelLeading(lg.movedim(-1, 0)) if planes else lg
    got = TL.calc_losses(arg, torch.from_numpy(target), c, collapse)
    (got[0] + 2 * got[1] + 3 * got[2]).backward()
    for g, r in zip(got, ref):
        assert abs(float(g.detach()) - float(r)) <= 1e-5 * max(abs(float(r)), 1.0)
    assert _rel(lg.grad, ref_g) < 1e-5


@pytest.mark.parametrize("collapse,costs", [(0, (True, True, True)), (1, (False, True, False)),
                                            (0, (False, False, False))])
def test_deep_supervision_loss(collapse, costs):
    rng = np.random.default_rng(4)
    c, dhw = 3, (8, 8, 16)
    shapes = [(1, dhw[0] >> k, dhw[1] >> k, dhw[2] >> k, c) for k in range(3)]
    outs = [(rng.standard_normal(s) * 2).astype(np.float32) for s in shapes]
    target = rng.integers(0, c + 1, (1, *dhw)).astype(np.int32)

    def jax_loss(outs):
        return JL.deep_supervision_loss(outs, jnp.asarray(target), c, collapse, *costs)

    (ref, ref0), ref_g = _jit(jax.value_and_grad(jax_loss, has_aux=True),
                              [jnp.asarray(o) for o in outs])
    ts = [torch.from_numpy(o).requires_grad_() for o in outs]
    # level 0 as channel-leading planes, as the training forward gives it
    args = [TL.ChannelLeading(ts[0].movedim(-1, 0))] + ts[1:]
    loss, lvl0 = TL.deep_supervision_loss(args, torch.from_numpy(target), c, collapse, *costs)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    for g, r in zip(lvl0, ref0):
        assert abs(float(g.detach()) - float(r)) <= 1e-5 * max(abs(float(r)), 1.0)
    for t, r in zip(ts, ref_g):
        assert _rel(t.grad, r) < 1e-5


ARCH = "conv16,ks3,stride1+norm,leaky_relu\nconv16,ks3,stride2\nconv16+conv3,ks1,stride1"


def _by_name(spec, jax_dict):
    """A JAX parameter-shaped dict -> the port's tensors keyed like
    ``UNet3d.params()``."""
    from unet_studio_tpu_torch.models.serialize import from_jax_params
    from unet_studio_tpu_torch.models.unet3d import param_order

    names = [n for n, _, _ in param_order(spec)]
    return dict(zip(names, from_jax_params(spec, jax_dict).values()))


def test_sgd_steps_and_state_conversion():
    """Three steps on a dict of weights, biases and norm scales: the
    gradient norm exceeds 12 on the first step (clipping on), then not."""
    from unet_studio_tpu.models import unet3d as J

    spec = parse_architecture(1, 3, ARCH)
    jparams = J.UNet3d.create(1, 3, ARCH, seed=1).params
    jopt = JO.init_opt_state(jparams)
    tparams = _by_name(spec, jparams)
    topt = TO.init_opt_state(tparams)
    rng = np.random.default_rng(5)
    for step, scale in enumerate((30.0, 0.5, 0.1)):
        jg = {k: jnp.asarray((rng.standard_normal(v.shape) * scale).astype(np.float32))
              for k, v in jparams.items()}
        lr = JO.poly_lr(0.01, step, 10)
        assert TO.poly_lr(0.01, step, 10) == pytest.approx(float(lr), rel=1e-6)
        jparams, jopt = JO.sgd_step(jparams, jg, jopt, lr)
        topt = TO.sgd_step(tparams, _by_name(spec, jg), topt, TO.poly_lr(0.01, step, 10))
        ref = _by_name(spec, jparams)
        conv = from_jax_opt_state(spec, jopt)
        assert topt["step"] == conv["step"] == step + 1
        for n in ref:
            assert _rel(tparams[n], ref[n]) < 1e-6, (step, n)
            assert _rel(topt["momentum"][n], conv["momentum"][n]) < 1e-6, (step, n)
    assert sum(TO.decay_mask(tparams).values()) == 4  # the four conv weights


def test_clip_by_global_norm():
    rng = np.random.default_rng(6)
    g = {f"a{i}.w": rng.standard_normal((4, 3)).astype(np.float32) * 10 for i in range(3)}
    ref = JO.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 12.0)
    got = TO.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 12.0)
    for k in g:
        assert _rel(got[k], ref[k]) < 1e-6
    total = float(torch.sqrt(sum((v * v).sum() for v in got.values())))
    assert total == pytest.approx(12.0, rel=1e-5)
