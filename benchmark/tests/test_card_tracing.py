"""On the card (marker ``cuda``; skipped without one): the program's
host-sync counter against torch's sync debug mode over one item's
synthesis at ``train.default``'s grid, and the tracer on in a thread
that starts inside a profile."""

from __future__ import annotations

import threading
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.drive_train import start_engine
from benchmark.harness import ROOT, Bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_synth_syncs_match_the_sync_debug_mode(card, tmp_path):
    from unet_studio_tpu_torch.engine.train import item_rng

    b = Bench(ROOT)
    w = b.cell("train.default")
    cfg = dict(b.config(w), batch_size=1)
    engine = start_engine(cfg, b.mix(w), 2**31 + 4244, torch.device("cuda"), str(tmp_path))[1]
    try:
        images, labels, tmpl, _, seeds = engine._get_batch(0)
        args = (images[0], labels[0], bool(tmpl[0]))
        engine._step.synthesize(*args, item_rng(*seeds[0]))  # the kernels built and loaded
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            engine._step.synthesize(*args, item_rng(*seeds[0]), seed_id=seeds[0][1])
            torch.cuda.synchronize()
        counted = b.reader("synth_syncs.train")({"trace": True})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                engine._step.synthesize(*args, item_rng(*seeds[0]))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        debug = sum("synchroniz" in str(c.message) for c in caught)
        print(f"synth_syncs {counted}, sync debug mode {debug}")
        assert debug > 0 and counted == debug
    finally:
        engine.stop()


@pytest.mark.cuda
def test_tracer_on_in_a_thread_started_inside_a_profile(card):
    from unet_studio_tpu_torch.utils import profiling

    seen = []

    def worker():
        seen.append(torch.autograd.profiler._is_profiler_enabled)
        with profiling.span("worker"):
            torch.ones(8, device="cuda").sum().item()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t = threading.Thread(target=worker)
        t.start()
        t.join(60)
    assert not t.is_alive() and seen == [True]
    (w,) = [r for r in profiling.records() if r.name == "worker"]
    assert w.counts == {"sync": 1}
