"""The ranks of tests/test_torch_parallel.py (not collected by pytest).

``run`` is the target of one ``torch.multiprocessing`` spawn of gloo
ranks on the CPU: each rank joins the group, runs every case on the
inputs the test built (numpy arrays, a BIDS directory) and saves what it
got to ``rank<r>.pt`` for the test process to hold against the JAX
package and the one-process port.  This module imports torch and the
port only, so a rank never imports JAX.
"""

import contextlib
import os

import torch
import torch.distributed as dist

from unet_studio_tpu_torch.data.bids import get_bids_pairs
from unet_studio_tpu_torch.engine.optimizer import init_opt_state
from unet_studio_tpu_torch.engine.train import TrainEngine, TrainParam, TrainStep
from unet_studio_tpu_torch.models.unet3d import UNet3d
from unet_studio_tpu_torch.ops.augment import AugOptions
from unet_studio_tpu_torch.parallel.mesh import make_mesh, shard_batch
from unet_studio_tpu_torch.parallel.spatial import (
    make_spatial_infer,
    make_spatial_train_step,
    spatial_sharding,
)
from unet_studio_tpu_torch.utils.device import init_multihost

# the 3-level network of tests/test_parallel.py
ARCH = "\n".join(
    [
        "conv8,ks3,stride1+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
        "conv16,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1+conv_trans8,ks2,stride2",
        "conv8,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1",
    ]
)
# augmentation off (tests/multihost_worker.py's options): the items still
# differ by their contrast simulation, drawn per seed_id
FAST = AugOptions(cropping=0, truncation_z=0, downsample_x=0, downsample_y=0, downsample_z=0,
                  noise=0, ambient=0, diffuse=0, specular=0, perspective=0.0,
                  lens_distortion=0.0, distortion=0, zero_background=4, rubber_stamping=0,
                  perlin_texture=0)


def model_with(params: dict) -> UNet3d:
    """The 3-level network on the CPU with ``params`` (numpy, torch
    layouts, keyed like ``UNet3d.params()``)."""
    model = UNet3d.create(1, 3, ARCH, seed=0, device="cpu")
    model.load_params(params)
    return model


def snapshot(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


@contextlib.contextmanager
def f64_statistics():
    """Every ``Tensor.float()`` gives f64 while it is open.  The port
    computes the norms' moments and the loss in f32 by design; with this,
    f64 weights and an f64 input, the whole train step runs in f64, so a
    z-sharded step and an unsharded one differ by f64 rounding alone."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = orig


def spatial_step_f64(inputs: dict, mesh, img, lab) -> dict:
    """The z-sharded train step of ``mesh`` in f64 throughout: the
    parameters after it."""
    model = model_with(inputs["params"])
    params = {k: v.detach().double() for k, v in model.params().items()}
    step = make_spatial_train_step(model, mesh, compute_dtype=torch.float64)
    with f64_statistics():
        params, _, _ = step(params, init_opt_state(params), img.double(), lab, 1e-3)
    return snapshot(params)


def step_dp(inputs: dict, mesh, seeds, remat: bool = False) -> dict:
    """One data-parallel f32 TrainStep on this rank's rows of the batch."""
    model = model_with(inputs["params"])
    step = TrainStep(model, TrainParam(batch_size=2, compute_dtype="float32",
                                       options=AugOptions(), remat=remat), mesh=mesh)
    images, labels = shard_batch(mesh, torch.from_numpy(inputs["images"]),
                                 torch.from_numpy(inputs["labels"]))
    opt, metrics, loss = step(init_opt_state(model.params()), images, labels, None, 0.01,
                              seeds=None if seeds is None else shard_batch(mesh, seeds))
    return {"params": snapshot(model.params()), "momentum": snapshot(opt["momentum"]),
            "metrics": metrics, "loss": loss}


def engine_epoch(inputs: dict, mesh, batch_size: int, model_path: str = "") -> dict:
    """TrainEngine's epoch 99 of 200 on the BIDS phantom, after which it
    autosaves to ``model_path`` (or its refusal of the batch)."""
    images, labels = get_bids_pairs(inputs["bids"])
    model = model_with(inputs["params"])
    model.dim = (16, 16, 16)
    eng = TrainEngine(model, TrainParam(image_file_name=images, label_file_name=labels,
                                        batch_size=batch_size, epoch=200,
                                        compute_dtype="float32", options=FAST),
                      model_path=model_path, mesh=mesh)
    eng.start()
    if eng.error_msg:
        return {"error": eng.error_msg}
    eng.cur_epoch = 99
    eng.run_epoch()
    eng.stop()
    return {"params": snapshot(model.params()), "training_errors": model.training_errors,
            "saved": [os.path.exists(model_path + s) for s in ("", ".opt")]}


def cases(rank: int, inputs: dict, out_dir: str) -> dict:
    out = {}
    mesh = make_mesh(device="cpu")
    out["mesh"] = {"shape": mesh.shape, "rank": mesh.rank,
                   "shape_1x2": make_mesh(1, 2, device="cpu").shape}
    try:
        make_mesh(2, 2, device="cpu")
    except ValueError as e:
        out["mesh"]["too_large"] = str(e)
    out["rows"] = shard_batch(mesh, inputs["rows"])

    # the z-sharded forward and train step on a (1, 2) mesh
    space = make_mesh(1, 2, device="cpu")
    sl = spatial_sharding(space, inputs["x"].shape[1])
    model = model_with(inputs["params"])
    infer = make_spatial_infer(model, space, compute_dtype=torch.float32)
    out["infer"] = infer(model.params(), torch.from_numpy(inputs["x"][:, sl]))
    for key, remat in (("spatial_step", False), ("spatial_step_remat", True)):
        model = model_with(inputs["params"])
        step = make_spatial_train_step(model, space, remat=remat)
        params, _, lvl0 = step(model.params(), init_opt_state(model.params()),
                               torch.from_numpy(inputs["img"][:, sl]),
                               torch.from_numpy(inputs["lab"][:, sl]), 1e-3)
        out[key] = {"params": snapshot(params), "lvl0": lvl0}
    out["spatial_step_f64"] = spatial_step_f64(inputs, space,
                                               torch.from_numpy(inputs["img"][:, sl]),
                                               torch.from_numpy(inputs["lab"][:, sl]))

    # the data axis: the step on the given items, then on items it
    # synthesizes from their global seed_ids; TrainEngine's epoch
    out["dp_items"] = step_dp(inputs, mesh, None)
    out["dp_synthesized"] = step_dp(inputs, mesh, inputs["seeds"])
    out["dp_synthesized_remat"] = step_dp(inputs, mesh, inputs["seeds"], remat=True)
    out["engine"] = engine_epoch(inputs, mesh, 2, os.path.join(out_dir, f"model{rank}.nz"))
    out["engine_batch3"] = engine_epoch(inputs, mesh, 3)
    return out


def run(rank: int, world: int, port: int, out_dir: str, inputs: dict) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    init_multihost(f"127.0.0.1:{port}", device="cpu")  # gloo, as for the CPU
    init_multihost(f"127.0.0.1:{port}", device="cpu")  # joined already: a no-op
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world
    try:
        out = cases(rank, inputs, out_dir)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
