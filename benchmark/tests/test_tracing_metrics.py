"""The readers of the program's spans (``synth_host_s.train``,
``synth_idle_s.train``, ``synth_syncs.train``, ``read_wait_s.eval``,
``inflate_s.eval``) on hand-built observations: None without the traced
run or without the program's tracer, the right value with them."""

from __future__ import annotations

import pytest

from benchmark.harness import ROOT, Bench
from unet_studio_tpu_torch.utils import profiling as P

NAMES = ["synth_host_s.train", "synth_idle_s.train", "synth_syncs.train", "read_wait_s.eval",
         "inflate_s.eval"]


def read(name):
    return Bench(ROOT).reader(name)


def rec(i, name, start_ms, end_ms, parent=None, thread="MainThread", ids=None, counts=None):
    return P.Record(i, name, thread, 1, int(start_ms * 1e6), int(end_ms * 1e6), parent,
                    ids or {}, counts or {})


class Empty:
    """A traced run in which the program opened no span."""

    t0, t1, _host, kernels = 0.0, 1e6, [(0.0, 5.0, "aten::add")], [(1.0, 2.0, "k", "")]


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_traced_run(name, monkeypatch):
    assert read(name)({}) is None
    monkeypatch.setattr(P, "records", lambda: [])
    assert read(name)({"trace": Empty()}) is None


@pytest.mark.parametrize("name", ["synth_host_s.train", "synth_syncs.train", "read_wait_s.eval",
                                  "inflate_s.eval"])
def test_none_from_a_program_without_the_tracer(name, monkeypatch):
    monkeypatch.delattr(P, "records")
    assert read(name)({"trace": object()}) is None


def test_synth_spans(monkeypatch):
    recs = [rec(1, "synth.draw", 0, 1, parent=0, counts={"sync": 1}),
            rec(2, "synth.warp", 1, 3, parent=0, counts={"sync": 2}),
            rec(0, "synth", 0, 4, ids={"seed_id": 0}, counts={"sync": 1}),
            rec(4, "synth.simulate", 5, 6, parent=3, counts={"sync": 4}),
            rec(3, "synth", 5, 7, ids={"seed_id": 1}),
            rec(5, "train.forward_loss", 7, 9, counts={"sync": 10})]
    monkeypatch.setattr(P, "records", lambda: recs)
    obs = {"trace": object()}
    assert read("synth_host_s.train")(obs) == pytest.approx((4 + 2) / 1e3 / 2)
    assert read("synth_syncs.train")(obs) == (1 + 2 + 1 + 4) / 2


def test_synth_idle():
    class Trace:
        t0, t1 = 0.0, 100.0
        _host = [(10.0, 30.0, "unet.synth"), (12.0, 14.0, "aten::add"),
                 (50.0, 70.0, "unet.synth"), (200.0, 210.0, "unet.synth")]
        kernels = [(0.0, 15.0, "k", ""), (12.0, 20.0, "k", ""), (60.0, 65.0, "k", ""),
                   (90.0, 95.0, "k", "")]

    # [10, 30] is busy over [10, 20], [50, 70] over [60, 65]: 10 + 15 us idle, 2 items
    assert read("synth_idle_s.train")({"trace": Trace()}) == pytest.approx(12.5e-6)
    Trace._host = [(12.0, 14.0, "aten::add")]
    assert read("synth_idle_s.train")({"trace": Trace()}) is None


def test_evaluate_spans(monkeypatch):
    reader = "unet-eval-reader"
    recs = [rec(1, "eval.read.inflate", 0, 3, parent=0, thread=reader),
            rec(0, "eval.read", 0, 4, thread=reader, ids={"seq": 0, "path": "a"}),
            rec(2, "eval.wait", 0, 1, ids={"seq": 0, "path": "a"}),
            rec(4, "eval.read.inflate", 4, 9, parent=3, thread=reader),
            rec(3, "eval.read", 4, 10, thread=reader, ids={"seq": 1, "path": "b"}),
            rec(5, "eval.wait", 5, 7, ids={"seq": 1, "path": "b"}),
            rec(6, "eval.read.inflate", 11, 12),  # a read outside the reader: not counted
            rec(7, "eval.wait", 12, 12.5)]
    monkeypatch.setattr(P, "records", lambda: recs)
    obs = {"trace": object()}
    assert read("read_wait_s.eval")(obs) == pytest.approx(3.5e-3 / 2)
    assert read("inflate_s.eval")(obs) == pytest.approx(8e-3 / 2)
