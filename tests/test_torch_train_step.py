"""The port's whole train step against the JAX package's, on the CPU.

The JAX composition is the train step without augmentation: ``jax.grad``
of ``forward(train=True, compute_dtype=float32)`` (its XLA route, the
exact oracle on the CPU) plus ``deep_supervision_loss`` per item, the
gradients summed over the items and divided by the batch size, then
``sgd_step``.  The port runs ``build_train_step`` on the CPU (the
kernels' twins under the autograd Functions).  Both start from the same
seeded weights (``init_params`` draws alike in both packages) and take
the same numpy batch of 2 items for two steps; after each step the test
holds the loss, the level-0 metrics, every gradient, the parameters and
the momentum buffers to the JAX values.  Cases: the flagship
``default_architecture(3)`` at 32^3, and SMALL_ARCH at 8^3 with one item
whose loss collapses its first class (``need_shift``), plus
``valid_step`` against JAX's ``valid_fn``.

The norm scales and biases are drawn at random (the same numbers in both
packages): with the zero init biases, the deepest level's instance norm
over one voxel (32^3 / 32) gives exactly zero, and the sign of its f32
rounding would pick the leaky ReLU's slope.

Tolerances (f32): loss and metrics 1e-5 relative.  SMALL_ARCH holds the
gradients and the momentum over the whole network, to 1e-5 in the L2
norm relative to the JAX gradient's and, per tensor, to 1e-5 of the
network's largest gradient, and the parameters to 1e-5 of each tensor's
largest value.  The flagship at 32^3, its smallest grid, runs instance
norms over 64, 8 and 1 voxels at levels 3-5, which make its f32
gradients ill-conditioned: they carry cancellation noise far above f32
rounding in both packages, and the second step's gradients, taken at
parameters that already differ by that noise, differ more.  Its
gradients and momentum are held in the same two norms to 5e-2, its
parameters to 3e-3 of each tensor's largest value.  A wrong layout,
flip or routing of any layer shows as an error of order 1.  The instance norms at C in {16, 32, 64} take
E[x^2] - mean^2 in the port and two passes in the JAX XLA route.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_studio_tpu.engine import optimizer as JO
from unet_studio_tpu.models import unet3d as J
from unet_studio_tpu.ops.losses import calc_losses, deep_supervision_loss
from unet_studio_tpu_torch.engine.optimizer import init_opt_state
from unet_studio_tpu_torch.engine import train as TT
from unet_studio_tpu_torch.models.dsl import default_architecture
from unet_studio_tpu_torch.models.serialize import from_jax_opt_state, from_jax_params
from unet_studio_tpu_torch.models.unet3d import UNet3d, param_order
from torch_one_thread import one_thread  # noqa: F401  (autouse)

# XLA's lowest backend optimisation level without the CPU fusion emitters:
# the flagship's gradient compiles in a quarter of the default's time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}

SMALL_ARCH = "\n".join(
    [
        "conv8,ks3,stride1+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
        "conv16,ks3,stride1+norm,leaky_relu+conv4,ks1,stride1+conv_trans8,ks2,stride2",
        "conv8,ks3,stride1+norm,leaky_relu+conv4,ks1,stride1",
    ]
)
CASES = {
    # name: (architecture, out_count, (D, H, W), need_shift, lr,
    #        (gradient tolerance, parameter tolerance))
    "flagship": (default_architecture(3), 3, (32, 32, 32), None, 0.01, (5e-2, 3e-3)),
    "small_shift": (SMALL_ARCH, 4, (8, 8, 8), (True, False), 0.05, (1e-5, 1e-5)),
}


def _by_name(spec, jax_dict):
    names = [n for n, _, _ in param_order(spec)]
    return dict(zip(names, from_jax_params(spec, jax_dict).values()))


def _own_max_err(got: dict, ref: dict, tol: float) -> None:
    for k, r in ref.items():
        err = float((got[k].detach() - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        assert err < tol, (k, err)


def _grads_close(got: dict, ref: dict, tol: float) -> None:
    """Over the whole network: the biases of convs that feed an instance
    norm have a zero gradient in exact arithmetic, so theirs is noise."""
    largest = max(float(v.abs().max()) for v in ref.values())
    diff2 = sum(float(((got[k] - r) ** 2).sum()) for k, r in ref.items())
    ref2 = sum(float((r ** 2).sum()) for r in ref.values())
    assert (diff2 / ref2) ** 0.5 < tol
    for k, r in ref.items():
        err = float((got[k] - r).abs().max()) / largest
        assert err < tol, (k, err)


def _random_norm_affines(spec, jax_params, model) -> None:
    rng = np.random.default_rng(99)
    port = model.params()
    for name, layer, which in param_order(spec):
        if layer.kind == "norm":
            v = (rng.standard_normal(layer.in_c) * 0.2 + (which == "w")).astype(np.float32)
            jax_params[name] = jnp.asarray(v)
            with torch.no_grad():
                port[name].copy_(torch.from_numpy(v))


def _jax_item_grad(spec, n_classes, collapse):
    def item_loss(params, img, lab):
        outs, _ = J.forward(spec, params, img[None], train=True, compute_dtype=jnp.float32)
        loss, lvl0 = deep_supervision_loss(outs, lab[None], n_classes, collapse)
        return loss, jnp.stack(lvl0)

    return jax.value_and_grad(item_loss, has_aux=True)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jax(name, monkeypatch):
    arch, n_classes, dhw, need_shift, lr, (g_tol, p_tol) = CASES[name]
    any_shift = need_shift is not None
    jm = J.UNet3d.create(1, n_classes, arch, seed=3)
    rng = np.random.default_rng(12)
    images = rng.random((2, *dhw, 1), np.float32)
    labels = rng.integers(0, n_classes + 1, (2, *dhw)).astype(np.int32)  # n_classes: ignored
    collapse = [1 if any_shift and s else 0 for s in (need_shift or (False, False))]

    model = UNet3d.create(1, n_classes, arch, seed=3, device="cpu")
    _random_norm_affines(jm.spec, jm.params, model)
    param = TT.TrainParam(batch_size=2, compute_dtype="float32")
    step, valid = TT.build_train_step(model, param, any_shift=any_shift, collapse_k=1,
                                      device="cpu")
    seen = []
    sgd = TT.sgd_step

    def recording_sgd(params, grads, opt_state, lr_, config):
        seen.append({k: g.clone() for k, g in grads.items()})
        return sgd(params, grads, opt_state, lr_, config)

    monkeypatch.setattr(TT, "sgd_step", recording_sgd)

    # one compiled JAX gradient per collapse value in the batch
    fns = {}
    for c in set(collapse):
        fn = _jax_item_grad(jm.spec, n_classes, c)
        fns[c] = jax.jit(fn).lower(jm.params, jnp.asarray(images[0]),
                                   jnp.asarray(labels[0])).compile(FAST_COMPILE)
    jparams, jopt = jm.params, JO.init_opt_state(jm.params)

    def update(params, g0, g1, opt_state):
        grads = jax.tree.map(lambda a, b: (a + b) / 2, g0, g1)
        return grads, *JO.sgd_step(params, grads, opt_state, jnp.float32(lr))

    opt = init_opt_state(model.params())
    jupdate = None
    for _ in range(2):
        gs, loss, metrics = [], 0.0, np.zeros(4)
        for i in range(2):
            (l_i, lvl0), g = fns[collapse[i]](jparams, jnp.asarray(images[i]),
                                              jnp.asarray(labels[i]))
            gs.append(g)
            loss += float(l_i)
            metrics += np.concatenate([np.asarray(lvl0), [1.0]])
        if jupdate is None:
            jupdate = jax.jit(update).lower(jparams, *gs, jopt).compile(FAST_COMPILE)
        grads, jparams, jopt = jupdate(jparams, *gs, jopt)

        opt, got_metrics, got_loss = step(opt, images, labels, need_shift, lr)
        assert float(got_loss) == pytest.approx(loss, rel=1e-5)
        np.testing.assert_allclose(got_metrics.numpy(), metrics, rtol=1e-5)
        _grads_close(seen[-1], _by_name(jm.spec, grads), g_tol)
        _own_max_err(model.params(), _by_name(jm.spec, jparams), p_tol)
        conv = from_jax_opt_state(jm.spec, jopt)
        assert opt["step"] == conv["step"]
        _grads_close(opt["momentum"], conv["momentum"], g_tol)

    if name == "small_shift":
        def valid_fn(params, img, lab):
            outs, _ = J.forward(jm.spec, params, img, train=False, compute_dtype=jnp.float32)
            return jnp.stack(calc_losses(outs[0], lab, n_classes))

        ref = jax.jit(valid_fn).lower(jparams, jnp.asarray(images), jnp.asarray(labels)).compile(
            FAST_COMPILE)(jparams, jnp.asarray(images), jnp.asarray(labels))
        got = valid(images, labels)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
