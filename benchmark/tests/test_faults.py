"""``correct`` on the CPU at 32^3: true for the program as it is, false
with the timed path broken underneath (each fault a cell can have), and
false for the control (the reference in float8 in the program's place).
The harness's look for a card is skipped (``device="cpu"``)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.harness import Bench, judge
from benchmark.run import run_cell

SEED = 2**31 + 977


def _run(root, cell):
    torch.set_num_threads(2)
    result, checks = run_cell(Bench(root), cell, SEED, 0.2, False, device="cpu",
                              t_start=time.perf_counter())
    return result


@pytest.mark.parametrize("cell", ["train.tiny", "evaluate.tiny", "interactive.tiny"])
def test_sound(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"] and r["failed"] == 0 and "setup_s" in r["metrics"]


def test_step_leaves_state_unchanged(tiny, monkeypatch):
    from unet_studio_tpu_torch.engine import train

    def unchanged(params, grads, state, lr, config=None):
        return dict(state, step=state["step"] + 1)

    monkeypatch.setattr(train, "sgd_step", unchanged)
    assert not _run(tiny, "train.tiny")["correct"]


def test_half_batch_left_out(tiny, monkeypatch):
    from unet_studio_tpu_torch.engine import train

    grads = train.TrainStep.grads

    def half(self, images, labels, need_shift=None, *, seeds=None, **kw):
        n = images.shape[0] // 2
        b, self.param.batch_size = self.param.batch_size, n
        try:
            return grads(self, images[:n], labels[:n], None, seeds=seeds[:n], **kw)
        finally:
            self.param.batch_size = b

    monkeypatch.setattr(train.TrainStep, "grads", half)
    assert not _run(tiny, "train.tiny")["correct"]


@pytest.mark.parametrize("cell", ["evaluate.tiny", "interactive.tiny"])
def test_answer_altered(tiny, monkeypatch, cell):
    from unet_studio_tpu_torch.engine import evaluate

    infer = evaluate.EvaluateEngine.infer

    def altered(self, case, fetch_prob=False):
        case = infer(self, case, fetch_prob)
        case.label[case.label.shape[0] // 2] = (case.label[case.label.shape[0] // 2] + 1) % 3
        return case

    monkeypatch.setattr(evaluate.EvaluateEngine, "infer", altered)
    assert not _run(tiny, cell)["correct"]


@pytest.mark.parametrize("cell", ["train.tiny", "evaluate.tiny"])
def test_control_fails(tiny, cell):
    torch.set_num_threads(2)
    b = Bench(tiny)
    w = b.cell(cell)
    numbers = b.driver(b.mix(w)).control(cfg=b.config(w), mix=b.mix(w), check=b.check(w),
                                         seed=SEED, device="cpu")
    limits = {k: v for k, v in b.check(w)["limits"].items() if k in numbers}
    ok, _ = judge(numbers, {"limits": limits})
    assert not ok and all(np.isfinite(v) for v in numbers.values())
