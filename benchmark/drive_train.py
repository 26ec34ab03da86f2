"""The ``train`` generator: template training through the program's
``TrainEngine.run_epoch``, the call that ``--action train`` and the web
UI drive, one epoch (one SGD step over ``batch`` items) per call.

Set-up: the weights and the template pair from the seed (the pair
written as gzip NIfTI files under the run's temporary directory), the
engine started on them, and the check's ``steps`` epochs through
``run_epoch``:
they warm every shape up and are the steps that ``correct`` judges.
Window: whole epochs until ``--seconds`` have passed.  With ``--trace
1``, one more epoch under the profiler (stages named by the benchmark's
spans around synthesis, validation and the optimizer) and one with the
step's own ``timings`` (which synchronize the card between stages).

``correct``: after the window, with the program freed, the reference
follows the same ``steps`` steps from the same weights and
template, and the run is held to it by three numbers:

- ``loss_gap``: per step, |program's loss - reference's| / reference's,
  the worst step;
- ``grad_gap_med``: the first gradient as the optimizer gets it (the
  argument of step 1's ``sgd_step``, before the clip), per leaf the gap of
  the two norms over the reference's norm or the median leaf's,
  whichever is larger; the median leaf's gap (the worst leaf, the entry
  conv's weight, swings from seed to seed with the rounding of the
  program's bfloat16 instance-norm backward, as ``entry_grad`` shows; it
  goes to standard error);
- ``change_gap_med``: the same of the parameters' change over the steps.

Both leave out the leaves whose reference gradient is under a thousandth
of the median leaf's (a conv bias under an instance norm has none).
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np
import torch

from . import inputs
from .cost import chip_peaks, forward_cost, least_seconds
from .reference import train as ref_train
from .reference.dsl import parse_architecture
from .trace import log_setup, patched, profiled, span


def norm_gaps(prog: dict, ref: dict, keys) -> dict:
    """Per leaf, |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    rn = {k: float(ref[k].double().norm()) for k in keys}
    pn = {k: float(prog[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def _worst(gaps: dict, n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n])


def start_engine(cfg, mix, seed, dev, workdir, compute_dtype=None):
    """The set-up's program from the seed, before its first step: the
    weights copied into a ``UNet3d``, the template pair written as gzip
    NIfTI files into ``workdir`` and a started ``TrainEngine`` on them (in
    ``compute_dtype``, by default the configuration's).  Returns (spec,
    engine, model, p0, image, label, voxel size, batch), ``p0`` the weights
    on the host."""
    from unet_studio_tpu_torch.engine import train as prog_train
    from unet_studio_tpu_torch.models.dsl import parse_architecture as prog_parse
    from unet_studio_tpu_torch.models.unet3d import UNet3d

    spec, weights, image, label, vs = make_inputs(cfg, mix, seed, dev)
    img_path = os.path.join(workdir, "tpl-A_T1w.nii.gz")
    lab_path = os.path.join(workdir, "tpl-A_dseg.nii.gz")
    inputs.write_nifti(img_path, image, vs, is_mni=True)
    inputs.write_nifti(lab_path, label, vs, is_mni=True)

    model = UNet3d(prog_parse(cfg["in_count"], cfg["out_count"], cfg["architecture"])).to(dev)
    model.dim = tuple(cfg["grid_xyz"])
    model.voxel_size = np.array([cfg["voxel_mm"]] * 3, np.float32)
    with torch.no_grad():
        for k, p in model.params().items():
            p.copy_(weights[k])
    p0 = {k: v.to("cpu", copy=True) for k, v in weights.items()}
    del weights
    batch = int(cfg["batch_size"])
    param = prog_train.TrainParam(image_file_name=[img_path], label_file_name=[lab_path],
                                  batch_size=batch, epoch=int(mix["total_epochs"]),
                                  learning_rate=float(mix["learning_rate"]), seed=int(seed),
                                  compute_dtype=compute_dtype or cfg["dtype"])
    engine = prog_train.TrainEngine(model, param, device=dev, save_model_during_training=False)
    engine.start()
    if engine.aborted:
        raise RuntimeError(f"the train engine did not start: {engine.error_msg}")
    return spec, engine, model, p0, image, label, vs, batch


def run(*, cfg, mix, check, seed, seconds, trace, device, workdir, t_start):
    from unet_studio_tpu_torch.engine import train as prog_train

    dev = torch.device(device)
    stages = {"imports": time.perf_counter() - t_start}
    spec, engine, model, p0, image, label, vs, batch = start_engine(cfg, mix, seed, dev,
                                                                     workdir)
    stages["CUDA, inputs and engine"] = time.perf_counter() - t_start
    steps = int(check["steps"])

    losses, grads = [], []
    step, sgd = engine._step, prog_train.sgd_step

    def observed(*args, **kwargs):
        out = step(*args, **kwargs)
        losses.append(float(out[2]))
        return out

    def optimizer(params, g, *args, **kwargs):
        grads.append({k: v.to("cpu", copy=True) for k, v in g.items()})
        return sgd(params, g, *args, **kwargs)

    with patched(engine, "_step", observed), patched(prog_train, "sgd_step", optimizer):
        for _ in range(steps):
            engine.run_epoch()
    p_k = {k: v.detach().to("cpu", copy=True) for k, v in model.params().items()}
    obs = {"setup_s": time.perf_counter() - t_start}
    stages["checked steps"] = obs["setup_s"]
    log_setup(obs["setup_s"], stages)

    # ---------------------------------------------------------------- window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    items = 0
    while True:
        engine.run_epoch()
        items += batch
        if time.perf_counter() - t0 >= seconds:
            break
    obs["window_s"] = time.perf_counter() - t0
    obs["items"] = items
    obs["peak_bytes_window"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    grid_dhw = tuple(reversed(cfg["grid_xyz"]))
    obs["fwd_flops"] = forward_cost(spec, grid_dhw)[0]
    peaks = chip_peaks(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
    obs["peaks"] = peaks
    if trace and dev.type == "cuda":
        labelled = (patched(engine._step, "synthesize", span("synth", engine._step.synthesize)),
                    patched(engine, "_valid", span("valid", engine._valid)),
                    patched(prog_train, "sgd_step", span("optimizer", prog_train.sgd_step)))
        for p in labelled:
            p.__enter__()
        try:
            obs["trace"] = profiled(engine.run_epoch, workdir)
        finally:
            for p in reversed(labelled):
                p.__exit__(None, None, None)
        timings = {}
        with patched(engine, "_step", lambda *a, **k: step(*a, timings=timings, **k)):
            engine.run_epoch()
        obs["timings"] = timings
        obs["profiled_items"] = batch
        if peaks is not None:
            obs["least_s_item"] = least_seconds(spec, grid_dhw, peaks)
    engine.stop()
    obs["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, model, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------ the reference
    t_ref = time.perf_counter()
    ref = reference_steps(cfg, mix, steps, spec, p0, image, label, vs, seed, dev)
    print(f"reference: {time.perf_counter() - t_ref:.2f} s, steps "
          f"{', '.join(f'{t:.2f}' for t in ref['step_s'])} s", file=sys.stderr, flush=True)
    return obs, compare(losses, grads[0], p_k, p0, ref), items, 0


def make_inputs(cfg, mix, seed, dev):
    """(spec, weights, template image, template label, voxel size) from
    the seed: the weights first, then the template, from one generator."""
    spec = parse_architecture(cfg["in_count"], cfg["out_count"], cfg["architecture"])
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    weights = inputs.make_weights(spec, gen, dev)
    image, label = inputs.template_pair(tuple(mix["native_dhw"]), gen, dev)
    return spec, weights, image, label, [float(mix["native_mm"])] * 3


def reference_steps(cfg, mix, steps, spec, p0, image, label, vs, seed, dev, precision="f32",
                    items=0):
    r_img, r_lab = ref_train.template_on_model_grid(
        image, label, vs, vs, cfg["grid_xyz"], [cfg["voxel_mm"]] * 3, dev)
    return ref_train.train_steps(spec, {k: v.to(dev) for k, v in p0.items()}, r_img, r_lab,
                                 seed=int(seed), batch=int(cfg["batch_size"]),
                                 steps=steps,
                                 base_lr=float(mix["learning_rate"]),
                                 total_epochs=int(mix["total_epochs"]), precision=precision,
                                 items=items)


def compare(losses, grad1, params, p0, ref) -> dict:
    """The three numbers of a run whose steps gave ``losses``, whose
    optimizer got the gradients ``grad1`` at step 1 and which left
    ``params`` after the last, against the reference's ``ref`` from the
    same ``p0``: the worst step's relative loss gap, and the median leaf's
    gap of the first gradient's and of the change's norms.  The leaves whose reference gradient at
    step 1 is under a thousandth of the median leaf's (nought but for
    rounding: a conv bias under an instance norm) are left out.  The worst
    leaves go to standard error."""
    gnorm = {k: float(g.double().norm()) for k, g in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k, v in gnorm.items() if v >= 1e-3 * med]
    grad = norm_gaps({k: v.cpu() for k, v in grad1.items()},
                     {k: v.cpu() for k, v in ref["grad"].items()}, moved)
    change = norm_gaps({k: params[k].cpu().double() - p0[k].double() for k in moved},
                       {k: ref["params"][k].cpu().double() - p0[k].double() for k in moved},
                       moved)
    print(f"train check: {len(moved)} of {len(gnorm)} leaves compared; worst grad: "
          f"{_worst(grad)}; worst change: {_worst(change)}", file=sys.stderr, flush=True)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"])),
        "grad_gap_med": float(np.median(list(grad.values()))),
        "change_gap_med": float(np.median(list(change.values()))),
    }


def control(*, cfg, mix, check, seed, device, fault: str = "") -> dict:
    """The numbers of the control, the reference in float8 in the
    program's place, held to the reference in float32; with
    ``fault="half_batch"``, of the float32 reference that leaves half of
    each batch out and takes the mean over the rest."""
    dev = torch.device(device)
    spec, weights, image, label, vs = make_inputs(cfg, mix, seed, dev)
    p0 = {k: v.to("cpu", copy=True) for k, v in weights.items()}
    steps = int(check["steps"])
    ref = reference_steps(cfg, mix, steps, spec, p0, image, label, vs, seed, dev)
    if fault == "half_batch":
        low = reference_steps(cfg, mix, steps, spec, p0, image, label, vs, seed, dev,
                              items=int(cfg["batch_size"]) // 2)
    elif fault:
        raise ValueError(f"no fault {fault!r}")
    else:
        low = reference_steps(cfg, mix, steps, spec, p0, image, label, vs, seed, dev,
                              precision="fp8")
    return compare(low["loss"], low["grad"], low["params"], p0, ref)
