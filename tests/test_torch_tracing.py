"""The port's tracer (``utils/profiling.py``) on the CPU: off, it records
nothing and enters no profiler range; on (while a profile runs), spans
nest with parent links and ``count`` lands on the innermost span; a
worker thread's span, which the profiler does not record, is placed on
the trace's clock; and the train step's synthesis and
``EvaluateEngine.run`` open their stage spans with the item's or the
volume's ids."""

import glob
import json
import os
import threading
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from unet_studio_tpu_torch.engine.evaluate import EvaluateEngine
from unet_studio_tpu_torch.engine.train import TrainParam, build_train_step, item_rng
from unet_studio_tpu_torch.io.nifti import write_nifti
from unet_studio_tpu_torch.models import serialize as TS
from unet_studio_tpu_torch.models.unet3d import UNet3d
from unet_studio_tpu_torch.ops import augment as TA
from unet_studio_tpu_torch.ops.augment import AugOptions
from unet_studio_tpu_torch.utils import profiling as P
from torch_one_thread import one_thread  # noqa: F401  (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SYNTH_STAGES = {"synth.draw", "synth.simulate", "synth.lowpass", "synth.crop", "synth.trunc",
                "synth.noise", "synth.lighting", "synth.coords", "synth.warp",
                "synth.normalize", "synth.stamp", "synth.perlin"}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("a profiler range was entered while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    before = P.records()

    @P.span("off.decorated")
    def twice(x):
        P.count("sync")
        return 2 * x

    with P.span("off", seed_id=1) as s:
        s.tag(seq=2)
        P.count("sync")
        assert twice(3) == 6
    assert P.span("off") is P.span("off", seed_id=2)  # one shared no-op per name
    assert P.records() == before


def test_on_nesting_parents_and_counts(recwarn):
    @P.span("on.decorated")
    def inner_work():
        P.count("n", 5)

    with _cpu_profile():
        with P.span("stale"):
            pass
    with _cpu_profile():  # a new profile restarts the buffer
        with P.span("outer", seed_id=3) as outer:
            P.count("n")
            with P.span("inner") as inner:
                P.count("n", 2)
                P.count("m")
                inner.tag(seq=4)
            inner_work()
            warnings.warn(P.SYNC_WARNING)  # counted, not shown
            warnings.warn("another warning")  # shown as before
        P.count("n")  # outside every span: dropped
    recs = {r.name: r for r in P.records()}
    assert set(recs) == {"outer", "inner", "on.decorated"}
    o, i, d = recs["outer"], recs["inner"], recs["on.decorated"]
    assert outer.id == o.id and inner.id == i.id
    assert o.parent is None and i.parent == o.id and d.parent == o.id
    assert o.ids == {"seed_id": 3} and i.ids == {"seq": 4}
    assert o.counts == {"n": 1, "sync": 1} and i.counts == {"n": 2, "m": 1}
    assert d.counts == {"n": 5}
    assert o.start_ns <= i.start_ns <= i.end_ns <= d.start_ns <= d.end_ns <= o.end_ns
    assert o.thread == threading.current_thread().name
    assert [str(w.message) for w in recwarn if "warning" in str(w.message)] == ["another warning"]
    assert P.dropped() == 0


def test_worker_span_on_the_trace_clock(tmp_path):
    def worker():
        with P.span("worker"):
            time.sleep(0.01)

    with P.trace(str(tmp_path), device="cpu"):
        for i in range(4):
            with P.span("main", i=i):
                torch.ones(256).sum()
        with torch.profiler.record_function("enclosing"):
            t = threading.Thread(target=worker, name="unet-test-worker")
            t.start()
            t.join(10)
        assert not t.is_alive()
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    enc = next(e for e in events if e.get("name") == "enclosing")
    # the profiler recorded the main thread only; the worker's span is the tracer's
    assert not [e for e in events if e.get("name") == "unet.worker"
                and e.get("cat") == "user_annotation"]
    (w,) = [e for e in events if e.get("name") == "unet.worker" and e.get("cat") == "unet_span"]
    assert enc["ts"] - 500 <= w["ts"] and w["ts"] + w["dur"] <= enc["ts"] + enc["dur"] + 500
    assert w["dur"] >= 1e4
    names = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("pid") == "unet spans"}
    assert names == {"MainThread", "unet-test-worker"}


def _synth_setup(opts: AugOptions, n: int = 16):
    """A tiny network's train step with ``opts`` and an n^3 ball phantom:
    (step, image (n, n, n, 1), label (n, n, n))."""
    arch = "\n".join(["conv8,ks3,stride1+norm,leaky_relu",
                      "conv8,ks3,stride2+norm,leaky_relu+conv_trans8,ks2,stride2",
                      "conv8,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1"])
    model = UNet3d.create(1, 3, arch, seed=0, device="cpu")
    z, y, x = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    label = torch.from_numpy((r < n / 3).astype(np.float32) + (r < n / 6))
    image = torch.from_numpy(np.clip(1.0 - r / (n / 2), 0, 1).astype(np.float32))[..., None]
    step, _ = build_train_step(model, TrainParam(batch_size=1, compute_dtype="float32",
                                                 options=opts), device="cpu")
    return step, image, label


def test_synthesize_spans():
    step, image, label = _synth_setup(
        AugOptions(cropping=4, truncation_z=4, noise=4, rubber_stamping=4, perlin_texture=4))
    with _cpu_profile() as prof:
        step.synthesize(image, label, True, item_rng(0, 5), seed_id=5)
    recs = P.records()
    (synth,) = [r for r in recs if r.name == "synth"]
    assert synth.ids == {"seed_id": 5} and synth.parent is None
    children = {r.name for r in recs if r.parent == synth.id}
    assert {r.name for r in recs} == children | {"synth"}
    assert {"synth.draw", "synth.simulate", "synth.lighting", "synth.coords", "synth.warp",
            "synth.normalize", "synth.crop", "synth.trunc", "synth.noise"} <= children
    assert children <= SYNTH_STAGES
    ranges = {e.name for e in prof.events() if e.name.startswith("unet.")}
    assert ranges == {"unet." + name for name in children | {"synth"}}


def test_synthesis_constants_miss_once_per_key():
    """Under a profile, the synthesis's cached constants count
    ``const_miss`` on the stage that computed them: once per key on the
    first item (the gate in ``synth.warp``, one low-pass matrix per
    (size, ratio) in ``synth.lowpass``), never after."""
    step, image, label = _synth_setup(
        AugOptions(downsample_x=4, downsample_y=4, downsample_z=4, downsample_y_ratio=0.25))
    TA._supercell_warp_ok.cache_clear()
    TA._roundtrip_matrix_on.cache_clear()
    with _cpu_profile():
        for seed_id in range(3):
            step.synthesize(image, label, True, item_rng(0, seed_id), seed_id=seed_id)
    recs = P.records()
    by_id = {r.id: r for r in recs}

    def item(r):
        while r.name != "synth":
            r = by_id[r.parent]
        return r.ids["seed_id"]

    misses = {}
    for r in recs:
        if r.counts.get("const_miss"):
            key = (item(r), r.name)
            misses[key] = misses.get(key, 0) + r.counts["const_miss"]
    # x and z at ratio 0.5 share one matrix, y at 0.25 has its own
    assert misses == {(0, "synth.warp"): 1, (0, "synth.lowpass"): 2}


def test_evaluate_run_spans(tmp_path):
    model = TS.load_model(os.path.join(FIXTURES, "golden", "model.nz"), device="cpu")
    eng = EvaluateEngine(model, compute_dtype=torch.float32, lookahead=2, post_workers=1,
                         device="cpu")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"v{i}.nii.gz"))
        write_nifti(paths[-1], rng.random((14, 16, 18), np.float32), (1.2, 1.0, 1.1))
    with _cpu_profile():
        for j, case in enumerate(eng.run(paths)):
            assert not case.error_msg and case.seq == j
            eng.save_case(case, str(tmp_path / f"out{j}.nii.gz"))
    recs = P.records()
    by_id = {r.id: r for r in recs}

    def vol(name, thread=None):
        out = {}
        for r in recs:
            if r.name == name and r.ids:
                assert thread is None or r.thread == thread, (name, r.thread)
                out[r.ids["seq"]] = r.ids["path"]
        return out

    want = dict(enumerate(paths))
    assert vol("eval.read", "unet-eval-reader") == want
    assert vol("eval.wait", "MainThread") == want
    assert vol("eval.infer", "MainThread") == want
    assert vol("eval.save", "MainThread") == want
    assert {r.thread.startswith("unet-output") for r in recs if r.name == "eval.post"} == {True}
    assert vol("eval.post") == want
    inflate = [r for r in recs if r.name == "eval.read.inflate"]
    assert len(inflate) == 2 and {by_id[r.parent].name for r in inflate} == {"eval.read"}
    assert {r.thread for r in inflate} == {"unet-eval-reader"}
    for child, parent in (("eval.read.canonicalize", "eval.read"),
                          ("eval.read.normalize", "eval.read"), ("eval.infer.h2d", "eval.infer"),
                          ("eval.infer.forward", "eval.infer"), ("eval.infer.fetch", "eval.infer"),
                          ("eval.save.write", "eval.save")):
        rs = [r for r in recs if r.name == child]
        assert len(rs) == 2 and {by_id[r.parent].name for r in rs} == {parent}, child
    # the driving thread waited once more, for the end of the list
    assert len([r for r in recs if r.name == "eval.wait"]) == 3


def test_off_span_is_cheap():
    """Off, a span costs a flag read and a dict lookup: well under the
    cost of one record_function (a loose bound on the best of five
    batches, the suite shares its cores)."""
    reps, best = 2000, float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(reps):
            with P.span("cheap"):
                pass
        best = min(best, (time.perf_counter() - t) / reps)
    assert best < 10e-6
