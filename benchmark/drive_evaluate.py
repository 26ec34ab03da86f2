"""The ``evaluate`` generator: segmentation of scans through the program's
``EvaluateEngine``.

Set-up: ``volumes`` int16 scans from the seed and the weights from the
mix's ``model_seed`` (``make_inputs``), the scans written
as gzip NIfTI files under the run's temporary directory; the engine
(``lookahead``, ``post_workers``) and two volumes through the timed
path to warm every shape up.  The scans are taken in a cycle.

- ``loop: "stream"``: one ``EvaluateEngine.run`` over an endless list of
  paths (a folder of scans, as ``--action evaluate`` runs it) and, with
  ``save``, ``save_case(output_type)`` of each result on the driving
  thread, as the CLI does; the list ends when the window closes.
- ``loop: "closed"``: one client; each request is ``EvaluateEngine.run``
  of one path, as the web UI calls it, timed from its send to its labels
  on the host; the next is sent when it returns.

Either way the window counts the volumes finished and the time they
took.  With ``--trace 1`` the window also times the engine's
``preprocess`` and ``infer`` and the save on the host clock, and a few
more volumes run under the profiler.

``correct``: a sample of the check's ``volumes`` of the window's results,
drawn from the seed, each held to the reference's probabilities from the
same scan and weights: ``label_gap`` is the widest distance by which the
reference's probabilities fall short of giving the program's label
(``reference.evaluate.label_margin``); with ``save``, ``file_mismatch``
counts the voxels of each sampled output file, read back, that differ
from the labels the engine returned.
"""

from __future__ import annotations

import gc
import itertools
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import inputs
from .cost import chip_peaks, forward_cost
from .reference import evaluate as ref_eval
from .reference.dsl import parse_architecture
from .reference.train import canonical_lps
from .trace import log_setup, patched, profiled, span


class Sample:
    """A reservoir of ``k`` results drawn from the seed: (index, volume,
    labels, output path)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, np.random.default_rng([seed, 1]), 0, []

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def _timed(fn, into: list):
    def wrapped(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        into.append(time.perf_counter() - t)
        return out

    return wrapped


def run(*, cfg, mix, check, seed, seconds, trace, device, workdir, t_start):
    from unet_studio_tpu_torch.engine.evaluate import EvaluateEngine
    from unet_studio_tpu_torch.models.dsl import parse_architecture as prog_parse
    from unet_studio_tpu_torch.models.unet3d import UNet3d

    dev = torch.device(device)
    stages = {"imports": time.perf_counter() - t_start}
    spec, weights, scans, vs = make_inputs(cfg, mix, seed, dev)
    paths = [os.path.join(workdir, f"sub-{i:02d}_T1w.nii.gz") for i in range(len(scans))]
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda a: inputs.write_nifti(a[0], a[1], vs), zip(paths, scans)))
    out_dir = os.path.join(workdir, "out")
    os.makedirs(out_dir)

    model = UNet3d(prog_parse(cfg["in_count"], cfg["out_count"], cfg["architecture"])).to(dev)
    model.dim = tuple(cfg["grid_xyz"])
    model.voxel_size = np.array([cfg["voxel_mm"]] * 3, np.float32)
    with torch.no_grad():
        for k, p in model.params().items():
            p.copy_(weights[k])
    p0 = {k: v.to("cpu", copy=True) for k, v in weights.items()}
    del weights
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    engine = EvaluateEngine(model, compute_dtype=dtype, lookahead=int(mix["lookahead"]),
                            post_workers=int(mix["post_workers"]), device=dev)
    stages["CUDA, inputs and engine"] = time.perf_counter() - t_start
    save = bool(mix.get("save", False))
    out_type = int(mix.get("output_type", 0))
    closed = mix["loop"] == "closed"
    times = {"read": [], "infer": [], "save": []}

    def save_case(case, path):
        t = time.perf_counter()
        engine.save_case(case, path, out_type)
        times["save"].append(time.perf_counter() - t)

    for case in engine.run(paths[:2]):  # warm-up, through the timed path
        if case.error_msg:
            raise RuntimeError(case.error_msg)
        if save:
            save_case(case, os.path.join(out_dir, "warmup.nii.gz"))
    times["save"].clear()
    obs = {"setup_s": time.perf_counter() - t_start}
    stages["warm-up"] = obs["setup_s"]
    log_setup(obs["setup_s"], stages)

    # ---------------------------------------------------------------- window
    if trace:
        engine.preprocess = _timed(engine.preprocess, times["read"])
        engine.infer = _timed(engine.infer, times["infer"])
    sample = Sample(int(check["volumes"]), seed)
    failed = 0
    done = 0
    latencies = []

    def take(case, i):
        nonlocal failed, done
        if case.error_msg:
            failed += 1
            return
        out = os.path.join(out_dir, f"{i:05d}.nii.gz") if save else None
        if save:
            save_case(case, out)
        done += 1
        sample.offer((i, i % len(paths), case.label.astype(np.int8), out))

    t0 = time.perf_counter()
    t_last = t0
    if closed:
        i = 0
        while t_last - t0 < seconds:
            t = time.perf_counter()
            (case,) = list(engine.run([paths[i % len(paths)]]))
            t_last = time.perf_counter()
            latencies.append(t_last - t)
            take(case, i)
            i += 1
        attempted = i
    else:
        stop = threading.Event()

        def feed():
            for i in itertools.count():
                if stop.is_set():
                    return
                yield paths[i % len(paths)]

        for i, case in enumerate(engine.run(feed())):
            if stop.is_set():
                continue  # the read-ahead after the window: drained, not counted
            take(case, i)
            t_last = time.perf_counter()
            if t_last - t0 >= seconds:
                stop.set()
        attempted = done + failed
    obs.update(window_s=t_last - t0, vols=done, latencies=latencies,
               read_s=times["read"], infer_s=times["infer"], save_s=times["save"],
               fwd_flops=forward_cost(spec, tuple(reversed(cfg["grid_xyz"])),
                                      heads="level0")[0],
               peaks=chip_peaks(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None)
    if trace and dev.type == "cuda":
        def few():
            for j, case in enumerate(engine.run(paths[:3])):
                if save:
                    saver(case, os.path.join(out_dir, f"traced{j}.nii.gz"), out_type)

        saver = span("save", engine.save_case)
        with patched(engine, "preprocess", span("read", engine.preprocess)), \
                patched(engine, "infer", span("infer", engine.infer)):
            obs["trace"] = profiled(few, workdir)
    obs["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------ the reference
    t_ref = time.perf_counter()
    params = {k: v.to(dev) for k, v in p0.items()}
    gaps, mismatch = [], 0
    for _, vol, labels, out in sample.kept:
        prob = reference_prob(cfg, spec, params, scans[vol], vs, dev)
        gaps.append(ref_eval.label_margin(prob, torch.from_numpy(labels.astype(np.int64))))
        del prob
        if out is not None:
            data = inputs.read_nifti(out)
            mismatch += int((canonical_lps(data, vs) != labels).sum())
    print(f"reference: {time.perf_counter() - t_ref:.2f} s for {len(gaps)} volumes",
          file=sys.stderr, flush=True)
    numbers = {"label_gap": max(gaps) if gaps else None}
    if save:
        numbers["file_mismatch"] = mismatch if gaps else None
    return obs, numbers, attempted, failed


def make_inputs(cfg, mix, seed, dev):
    """(spec, weights, scans, voxel size): the scans from the seed, the
    weights from the mix's ``model_seed``.  A user segments every scan
    with one model; and a random network's labels, whose gzip write is
    most of a scan's time here, take from 0.67 to 1.64 s a scan to write
    from one network to the next (NVIDIA H100, bf16), which would make
    the rate a matter of the seed."""
    spec = parse_architecture(cfg["in_count"], cfg["out_count"], cfg["architecture"])
    weights = inputs.make_weights(
        spec, torch.Generator(device=dev).manual_seed(int(mix["model_seed"])), dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    scans = inputs.heads(tuple(mix["native_dhw"]), int(mix["volumes"]), gen, dev)
    return spec, weights, scans, [float(mix["native_mm"])] * 3


def reference_prob(cfg, spec, params, scan, vs, dev, precision="f32"):
    return ref_eval.probabilities(spec, params, scan, vs, vs, cfg["grid_xyz"],
                                  [cfg["voxel_mm"]] * 3, dev, precision=precision)


def control(*, cfg, mix, check, seed, device, fault: str = "") -> dict:
    """``label_gap`` of the control: the labels of the reference in
    float8, held to the float32 reference's probabilities, over the first
    ``volumes`` scans of the check."""
    if fault:
        raise ValueError(f"no fault {fault!r}")
    dev = torch.device(device)
    spec, params, scans, vs = make_inputs(cfg, mix, seed, dev)
    gaps = []
    for scan in scans[:int(check["volumes"])]:
        low = ref_eval.labels_of(reference_prob(cfg, spec, params, scan, vs, dev, "fp8"))
        gaps.append(ref_eval.label_margin(reference_prob(cfg, spec, params, scan, vs, dev), low))
    return {"label_gap": max(gaps)}
