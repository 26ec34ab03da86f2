"""BENCHMARK.json and the files the harness finds by name."""

from __future__ import annotations

import json
import re
import pytest
from conftest import tiny_root

from benchmark.harness import ROOT, Bench, read_metrics

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    b = Bench(ROOT)
    w = b.cell(cell)
    cfg, mix, check = b.config(w), b.mix(w), b.check(w)
    assert cfg["architecture"] and cfg["batch_size"] >= 1
    assert mix["driver"] in ("train", "evaluate") and b.driver(mix).run
    assert check["limits"] and (check.get("steps") or check.get("volumes"))
    for trace in (False, True):
        metrics = b.metrics(w, trace)
        assert metrics
        for m in metrics:
            assert callable(b.reader(m["name"]))
    names = {m["name"] for m in b.metrics(w, False)}
    assert "setup_s" in names and len(names) >= 2
    moved = {m["moves"] for m in b.metrics(w, True)}
    assert moved <= names  # each per-layer metric moves one this cell reports


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_new_files_taken_up(tmp_path):
    """A cell, a mix and a metric added as new files and entries only."""
    root = tiny_root(tmp_path)
    (root / "benchmark" / "metrics" / "window_items.train.py").write_text(
        "def read(obs):\n    return obs.get('items')\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "window_items.train", "unit": "items", "better": "higher",
                              "source": "host_clock", "layer": "train step",
                              "moves": "train_items_per_s", "workloads": ["train.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(root)
    cell = b.cell("train.tiny")
    assert b.config(cell)["name"] == "tiny" and b.mix(cell)["driver"] == "train"
    got = read_metrics(b, cell, True, {"items": 7})
    assert got == {"window_items.train": {"value": 7.0, "unit": "items"}}
    assert read_metrics(b, b.cell("evaluate.tiny"), True, {}) == {}


def test_tiny_root_holds_only_data(tmp_path):
    root = tiny_root(tmp_path)
    added = {p.suffix for p in (root / "benchmark").rglob("*") if p.is_file()
             and "metrics" not in p.parts}
    assert added == {".json"}
