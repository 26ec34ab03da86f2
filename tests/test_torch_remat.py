"""``TrainParam.remat`` on the CPU: each level of the training forward
(and the loss) checkpointed with non-reentrant ``torch.utils.checkpoint``,
as the JAX package checkpoints each level under ``remat``.  The
no-remat path is already held to the JAX package (tests/test_torch_train_step.py),
so remat is held to it: ``forward_train``'s gradients bitwise, through
the kernels' autograd Functions (their CPU twins) and through the plain
twins, in f32 and bf16; one ``TrainStep`` with synthesis within 1e-6 of
each parameter's largest value; the z-sharded step's plain forward on one
rank.  A 3-level network at 16^3 whose levels hit the entry, K1, K3, K4,
the dual conv, the norms, a level-1 head and a transposed-conv tail.
The two-rank z-sharded and data-parallel steps with remat are in
tests/test_torch_parallel.py; the card's kernels in
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

from unet_studio_tpu_torch.engine.optimizer import init_opt_state
from unet_studio_tpu_torch.engine.train import TrainParam, TrainStep
from unet_studio_tpu_torch.models.unet3d import UNet3d, forward_train
from unet_studio_tpu_torch.ops.augment import AugOptions
from unet_studio_tpu_torch.ops.losses import deep_supervision_loss
from unet_studio_tpu_torch.parallel.mesh import make_mesh
from unet_studio_tpu_torch.parallel.spatial import make_spatial_train_step
from torch_one_thread import one_thread  # noqa: F401  (autouse)

ARCH = "\n".join([
    "conv16,ks3,stride1+norm,leaky_relu+conv16,ks3,stride1+norm,leaky_relu",
    "conv32,ks3,stride2+norm,leaky_relu+conv32,ks3,stride1+norm,leaky_relu",
    "conv64,ks3,stride2+norm,leaky_relu+conv64,ks3,stride1+norm,leaky_relu"
    "+conv_trans32,ks2,stride2",
    "conv32,ks3,stride1+norm,leaky_relu+conv32,ks3,stride1+norm,leaky_relu"
    "+conv3,ks1,stride1+conv_trans16,ks2,stride2",
    "conv16,ks3,stride1+norm,leaky_relu+conv16,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1",
])
N = 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    model = UNet3d.create(1, 3, ARCH, seed=0, device="cpu")
    model.dim = (N, N, N)
    # random norm scales and biases: with the zero init biases a deep
    # norm's exact zeros would hide a wrong recomputation of its input
    for k, v in model.params().items():
        if k.endswith(".b") or v.dim() == 1:
            with torch.no_grad():
                v.copy_(torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)) * 0.3
                        + (1.0 if k.endswith(".w") else 0.0))
    x = torch.from_numpy(rng.random((1, N, N, N, 1), np.float32))
    lab = torch.from_numpy(rng.integers(0, 3, (1, N, N, N)))
    return model, x, lab


def _grads(model, x, lab, *, plain, remat, dtype, saved=None):
    """(loss, gradients); ``saved`` (a dict) receives, per storage the
    forward keeps for the backward outside a checkpoint, the most bytes
    that any tensor saved on it spans: a tensor that two Functions save
    (a leaky ReLU's output and the next conv's input) counts once."""
    leaves = {k: v.detach().requires_grad_() for k, v in model.params().items()}

    def pack(t):
        if saved is not None:
            key = t.untyped_storage().data_ptr()
            saved[key] = max(saved.get(key, 0), t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        outs = forward_train(model.spec, leaves, x, compute_dtype=dtype, plain=plain,
                             remat=remat)
    loss, _ = deep_supervision_loss(outs, lab, 3)
    g = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
    return loss.detach(), dict(zip(leaves, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plain", [False, True], ids=["functions", "twins"])
def test_forward_train_remat_gradients_equal(data, plain, dtype):
    model, x, lab = data
    kept, kept_r = {}, {}
    loss, ref = _grads(model, x, lab, plain=plain, remat=False, dtype=dtype, saved=kept)
    loss_r, got = _grads(model, x, lab, plain=plain, remat=True, dtype=dtype, saved=kept_r)
    # checkpointed: what the level-0 head keeps outside the levels is a
    # fraction of what the forward keeps without remat (16^3, f32: 1.0 of 4.4 MB)
    assert 0 < sum(kept_r.values()) < sum(kept.values()) / 4
    assert torch.equal(loss_r, loss)
    for k, g in ref.items():
        assert torch.equal(got[k], g), k
    assert max(float(g.abs().max()) for g in ref.values()) > 0


def _params_close(got: dict, ref: dict, tol: float):
    for k, r in ref.items():
        err = float((got[k] - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        assert err < tol, (k, err)


def test_train_step_remat_updates_as_without(data):
    model, _, _ = data
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.random((2, N, N, N, 1), np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (2, N, N, N)).astype(np.uint8))
    assert TrainParam(remat=True).remat and not TrainParam().remat
    start = {k: v.detach().clone() for k, v in model.params().items()}
    out = {}
    for remat in (False, True):
        m = UNet3d.create(1, 3, ARCH, seed=0, device="cpu")
        m.load_params({k: v.numpy() for k, v in start.items()})
        step = TrainStep(m, TrainParam(batch_size=2, compute_dtype="float32", remat=remat,
                                       options=AugOptions()), device="cpu")
        _, metrics, loss = step(init_opt_state(m.params()), images, labels, None, 0.01,
                                seeds=[(7, 0), (7, 1)])
        out[remat] = ({k: v.detach().clone() for k, v in m.params().items()}, metrics, loss)
    _params_close(out[True][0], out[False][0], 1e-6)
    assert torch.equal(out[True][1], out[False][1]) and torch.equal(out[True][2], out[False][2])
    assert any(not torch.equal(out[False][0][k], v) for k, v in start.items())


def test_spatial_train_step_remat_on_one_rank(data):
    model, x, lab = data
    out = {}
    for remat in (False, True):
        params = {k: v.detach().clone() for k, v in model.params().items()}
        step = make_spatial_train_step(model, make_mesh(1, 1, device="cpu"), remat=remat)
        params, _, lvl0 = step(params, init_opt_state(params), x, lab, 1e-3)
        out[remat] = (params, lvl0)
    assert torch.equal(out[True][1], out[False][1])
    _params_close(out[True][0], out[False][0], 1e-6)
