"""The port's ``parallel/`` and the data axis of training on two gloo
ranks on the CPU, against the JAX package and the one-process port.

One ``torch.multiprocessing`` spawn of two ranks runs every multi-rank
case (``tests/torch_parallel_worker.py``, which imports no JAX) and
returns its results here, where the JAX references and the one-process
port are computed.  The spawn has its own time limit, so a hang fails
these tests instead of the suite's run.  The 3-level network of
``tests/test_parallel.py`` at 16^3, f32, with random norm scales and
biases (the same numbers in both packages: with zero biases a deep
norm's exact zeros would let f32 rounding pick the leaky ReLU's slope).

* mesh shapes, the too-large mesh's message and ``shard_batch``'s rows
  against ``unet_studio_tpu.parallel.mesh`` on the 8-device CPU mesh;
* ``make_spatial_infer`` on a (1, 2) mesh against the JAX one on a (1, 2)
  mesh and the port's unsharded ``forward``: rtol 2e-4, atol 1e-5, as
  ``tests/test_parallel.py``;
* ``make_spatial_train_step`` on two ranks against the JAX one and the
  port's one-rank step: parameters atol 2e-5, level-0 losses atol 1e-5,
  as ``tests/test_parallel.py``; the two ranks' parameters bitwise equal;
  and in f64 throughout (weights, input, the norms' and the loss's
  statistics), the update within 1e-10 of one rank's;
* the data-parallel ``TrainStep`` (batch 2, one item per rank) against
  one process on the same items, given or synthesized from their global
  seed_ids (default augmentation): parameters, metrics and loss to 1e-5
  relative, the momentum (the first step's gradient) to 1e-5 over the
  network, the ranks' parameters bitwise equal;
* ``TrainEngine``'s epoch 99 on two ranks against one process (each rank
  reads and synthesizes its row; rank 0 alone writes the autosave), and
  its refusal of a batch of 3 with the JAX package's message.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_worker as W
from unet_studio_tpu.engine.optimizer import init_opt_state as jax_init_opt_state
from unet_studio_tpu.models.unet3d import UNet3d as JaxUNet3d
from unet_studio_tpu.parallel import mesh as JM
from unet_studio_tpu.parallel.spatial import (
    make_spatial_infer as jax_spatial_infer,
    make_spatial_train_step as jax_spatial_train_step,
    spatial_sharding as jax_spatial_sharding,
)
from unet_studio_tpu_torch.data.bids import get_bids_pairs
from unet_studio_tpu_torch.engine.optimizer import init_opt_state
from unet_studio_tpu_torch.io.nifti import write_nifti
from unet_studio_tpu_torch.models.serialize import from_jax_params
from unet_studio_tpu_torch.models.unet3d import forward, param_order
from unet_studio_tpu_torch.parallel.mesh import make_mesh
from unet_studio_tpu_torch.parallel.spatial import make_spatial_train_step
from unet_studio_tpu_torch.utils.device import init_multihost

SPAWN_TIMEOUT_S = 180
# XLA's lowest backend optimisation level (tests/test_torch_train_step.py)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}


def _by_name(spec, jax_params) -> dict:
    names = [n for n, _, _ in param_order(spec)]
    return {n: v.numpy() for n, v in zip(names, from_jax_params(spec, jax_params).values())}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    jm = JaxUNet3d.create(1, 3, W.ARCH, seed=0)
    rng = np.random.default_rng(99)
    jparams = {k: np.asarray(v) for k, v in jm.params.items()}
    for name, layer, which in param_order(jm.spec):
        if layer.kind == "norm":
            jparams[name] = (rng.standard_normal(layer.in_c) * 0.2
                             + (which == "w")).astype(np.float32)
    bids = tmp_path_factory.mktemp("bids")
    n = 16
    z, y, x = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    lab = (r < n / 3).astype(np.float32)
    lab[r < n / 6] = 2.0
    write_nifti(str(bids / "tpl-A_T1w.nii.gz"),
                np.clip(1.0 - r / (n / 2), 0, 1).astype(np.float32) * (lab > 0), is_mni=True)
    write_nifti(str(bids / "tpl-A_dseg.nii.gz"), lab.astype(np.int16), is_mni=True)
    data = np.random.default_rng(0)
    return {
        "jax_params": jparams,
        "params": _by_name(jm.spec, jparams),
        "rows": data.standard_normal((4, 3, 3)).astype(np.float32),
        "x": data.standard_normal((1, 16, 8, 8, 1)).astype(np.float32),
        "img": np.clip(data.random((1, 16, 16, 16, 1), np.float32), 0, 1),
        "lab": data.integers(0, 3, (1, 16, 16, 16)).astype(np.float32),
        "images": data.random((2, 16, 16, 16, 1), np.float32),
        "labels": data.integers(0, 3, (2, 16, 16, 16)),
        "seeds": [(5, 0), (5, 1)],
        "bids": str(bids),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results, from one spawn with its own time limit."""
    out = str(tmp_path_factory.mktemp("ranks"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rank_inputs = {k: v for k, v in inputs.items() if k != "jax_params"}
    ctx = mp.start_processes(W.run, args=(2, port, out, rank_inputs), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the two ranks did not finish within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]


def _one_process_model(inputs):
    return W.model_with(inputs["params"])


def _rel_close(got: dict, ref: dict, tol: float) -> None:
    for k, r in ref.items():
        err = float((got[k] - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        assert err < tol, (k, err)


def _grads_close(got: dict, ref: dict, tol: float) -> None:
    """Over the whole network: the biases of convs that feed an instance
    norm have a zero gradient in exact arithmetic, so theirs is noise."""
    largest = max(float(v.abs().max()) for v in ref.values())
    diff2 = sum(float(((got[k] - r) ** 2).sum()) for k, r in ref.items())
    ref2 = sum(float((r ** 2).sum()) for r in ref.values())
    assert (diff2 / ref2) ** 0.5 < tol
    for k, r in ref.items():
        assert float((got[k] - r).abs().max()) / largest < tol, k


def _bitwise_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_mesh_matches_jax(ranks):
    for r, res in enumerate(ranks):
        m = res["mesh"]
        assert m["rank"] == r
        assert m["shape"] == dict(JM.make_mesh(n_data=2).shape) == {"data": 2, "space": 1}
        assert m["shape_1x2"] == dict(JM.make_mesh(n_data=1, n_space=2).shape)
        assert m["too_large"] == "need 4 devices, have 2"
    with pytest.raises(ValueError, match=r"^need 16 devices, have 8$"):
        JM.make_mesh(n_data=4, n_space=4)
    with pytest.raises(ValueError, match=r"^need 2 devices, have 1$"):
        make_mesh(2)  # no process group: this process alone


def test_shard_batch_matches_jax(ranks, inputs):
    x = inputs["rows"]
    xs = JM.shard_batch(JM.make_mesh(n_data=2), x)
    shards = sorted(xs.addressable_shards, key=lambda s: s.device.id)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["rows"], np.asarray(shards[r].data))
    np.testing.assert_array_equal(np.concatenate([res["rows"] for res in ranks]), x)


def test_spatial_infer_matches_jax_and_unsharded(ranks, inputs):
    x = inputs["x"]
    got = torch.cat([res["infer"] for res in ranks], dim=1).numpy()
    model = _one_process_model(inputs)
    unsharded = forward(model.spec, model.params(), torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, unsharded, rtol=2e-4, atol=1e-5)
    mesh = JM.make_mesh(n_data=1, n_space=2)
    jm = JaxUNet3d.create(1, 3, W.ARCH, seed=0)
    infer = jax_spatial_infer(jm, mesh, compute_dtype=jnp.float32)
    params = jax.device_put({k: jnp.asarray(v) for k, v in inputs["jax_params"].items()},
                            NamedSharding(mesh, P()))
    xs = jax.device_put(jnp.asarray(x), jax_spatial_sharding(mesh))
    ref = np.asarray(infer.lower(params, xs).compile(FAST_COMPILE)(params, xs))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


def test_spatial_train_step_matches_jax_and_one_rank(ranks, inputs):
    img, lab = inputs["img"], inputs["lab"]
    _bitwise_equal(ranks[0]["spatial_step"]["params"], ranks[1]["spatial_step"]["params"])
    got = ranks[0]["spatial_step"]
    # the port on one rank (no process group)
    model = _one_process_model(inputs)
    step = make_spatial_train_step(model, make_mesh(1, 1, device="cpu"))
    params, _, lvl0 = step(model.params(), init_opt_state(model.params()),
                           torch.from_numpy(img), torch.from_numpy(lab), 1e-3)
    np.testing.assert_allclose(got["lvl0"].numpy(), lvl0.numpy(), atol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=2e-5, err_msg=k)
    # the update itself, over the whole network: the two ranks' summed
    # gradients against one rank's, apart from the order of f32 sums
    before = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    diff2 = sum(float(((got["params"][k] - v) ** 2).sum()) for k, v in params.items())
    step2 = sum(float(((v - before[k]) ** 2).sum()) for k, v in params.items())
    assert (diff2 / step2) ** 0.5 < 1e-4
    # the JAX package's step on a (1, 2) mesh
    jm = JaxUNet3d.create(1, 3, W.ARCH, seed=0)
    jparams = {k: jnp.asarray(v) for k, v in inputs["jax_params"].items()}
    jstep = jax_spatial_train_step(jm, JM.make_mesh(n_data=1, n_space=2))
    args = (jparams, jax_init_opt_state(jparams), img, lab, 1e-3)
    jp, _, jlvl0 = jstep.lower(*args).compile(FAST_COMPILE)(*args)
    np.testing.assert_allclose(got["lvl0"].numpy(), np.asarray(jlvl0), atol=1e-5)
    ref = _by_name(jm.spec, {k: np.asarray(v) for k, v in jp.items()})
    for k, v in ref.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v, atol=2e-5, err_msg=k)


def test_spatial_train_step_exact_in_f64(ranks, inputs):
    # in f64 throughout, the z-sharded step is the unsharded one up to f64
    # rounding: the halos, the norms' two-pass slab sums and the loss's
    # sums lose nothing, so the f32 gap above is rounding alone
    _bitwise_equal(ranks[0]["spatial_step_f64"], ranks[1]["spatial_step_f64"])
    ref = W.spatial_step_f64(inputs, make_mesh(1, 1, device="cpu"),
                             torch.from_numpy(inputs["img"]), torch.from_numpy(inputs["lab"]))
    before = {k: torch.from_numpy(v).double() for k, v in inputs["params"].items()}
    got = ranks[0]["spatial_step_f64"]
    diff2 = sum(float(((got[k] - v) ** 2).sum()) for k, v in ref.items())
    step2 = sum(float(((v - before[k]) ** 2).sum()) for k, v in ref.items())
    assert step2 > 0 and (diff2 / step2) ** 0.5 < 1e-10


@pytest.mark.parametrize("case", ["dp_items", "dp_synthesized"])
def test_data_parallel_step_matches_one_process(ranks, inputs, case):
    _bitwise_equal(ranks[0][case]["params"], ranks[1][case]["params"])
    ref = W.step_dp(inputs, make_mesh(1, 1, device="cpu"),
                    inputs["seeds"] if case == "dp_synthesized" else None)
    for res in ranks:
        got = res[case]
        _rel_close(got["params"], ref["params"], 1e-5)
        _grads_close(got["momentum"], ref["momentum"], 1e-5)  # the first step's gradients
        _rel_close({"metrics": got["metrics"], "loss": got["loss"]},
                   {"metrics": ref["metrics"], "loss": ref["loss"]}, 1e-5)
    assert float(ref["metrics"][3]) == 2.0  # both items recorded, once each


@pytest.mark.parametrize("case", ["spatial_step", "dp_synthesized"])
def test_remat_steps_match_on_two_ranks(ranks, case):
    # TrainParam.remat / remat=True: the backward reruns each level's
    # forward, the z-sharded one with its halo exchanges and slab sums,
    # on both ranks in the same order; the update is the one without
    for res in ranks:
        got, ref = res[case + "_remat"], res[case]
        _rel_close(got["params"], ref["params"], 1e-6)
        if "momentum" in ref:
            _grads_close(got["momentum"], ref["momentum"], 1e-6)
        for k in set(ref) - {"params", "momentum"}:
            assert torch.equal(got[k], ref[k]), k
    _bitwise_equal(ranks[0][case + "_remat"]["params"], ranks[1][case + "_remat"]["params"])


def test_engine_data_parallel_matches_one_process(ranks, inputs, tmp_path):
    _bitwise_equal(ranks[0]["engine"]["params"], ranks[1]["engine"]["params"])
    ref = W.engine_epoch(inputs, make_mesh(1, 1, device="cpu"), 2,
                         str(tmp_path / "model.nz"))
    assert ref["saved"] == [True, True]
    # rank 0 alone writes the autosave (the model and its .opt)
    assert [res["engine"]["saved"] for res in ranks] == [[True, True], [False, False]]
    for res in ranks:
        _rel_close(res["engine"]["params"], ref["params"], 1e-5)
        np.testing.assert_allclose(res["engine"]["training_errors"], ref["training_errors"],
                                   rtol=1e-5)
    assert len(get_bids_pairs(inputs["bids"])[0]) == 1


def test_engine_refuses_indivisible_batch(ranks):
    # unet_studio_tpu/engine/train.py:276-287
    for res in ranks:
        assert res["engine_batch3"] == {
            "error": "batch_size (3) must be divisible by the process count (2) for "
                     "multi-host training"}


def test_mesh_needs_a_card_or_cpu_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1)
    assert make_mesh(1, device="cpu").device == torch.device("cpu")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="RANK and WORLD_SIZE"):
        init_multihost("127.0.0.1:1", device="cpu")
