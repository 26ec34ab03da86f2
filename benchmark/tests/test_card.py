"""On the card (marker ``cuda``; skipped without one): each cell of
``BENCHMARK.json`` at its own size, a short window, ``correct`` true;
and its control, the reference in float8 in the program's place, failing
the cell's limits."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.harness import ROOT, Bench, judge
from benchmark.run import run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct(card, cell):
    result, checks = run_cell(Bench(ROOT), cell, 2**31 + 4242, 2.0, False,
                              t_start=time.perf_counter())
    assert result["correct"], checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(card, cell):
    b = Bench(ROOT)
    w = b.cell(cell)
    numbers = b.driver(b.mix(w)).control(cfg=b.config(w), mix=b.mix(w), check=b.check(w),
                                         seed=2**31 + 4243, device="cuda")
    limits = {k: v for k, v in b.check(w)["limits"].items() if k in numbers}
    ok, checks = judge(numbers, {"limits": limits})
    assert not ok, checks
