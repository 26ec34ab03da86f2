"""Fixtures of the benchmark's CPU tests: a small benchmark root, built
from data files only, whose cells run the program and the reference on
the CPU at a 32^3 grid."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness import ROOT

TINY_ARCH = "\n".join([
    "conv16,ks3,stride1+norm,leaky_relu+conv16,ks3,stride1+norm,leaky_relu",
    "conv32,ks3,stride2+norm,leaky_relu+conv32,ks3,stride1+norm,leaky_relu",
    "conv64,ks3,stride2+norm,leaky_relu+conv64,ks3,stride1+norm,leaky_relu"
    "+conv_trans32,ks2,stride2",
    "conv32,ks3,stride1+norm,leaky_relu+conv32,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1"
    "+conv_trans16,ks2,stride2",
    "conv16,ks3,stride1+norm,leaky_relu+conv16,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1",
])


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def tiny_root(tmp: Path, dtype: str = "float32") -> Path:
    """A root with its own BENCHMARK.json: the cells ``train.tiny``,
    ``evaluate.tiny`` and ``interactive.tiny`` on a 3-level network at
    32^3, the repository's metric readers, and checks of its own."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    shutil.copytree(ROOT / "benchmark" / "metrics", b / "metrics")
    write(b / "configs" / "tiny.json", {
        "name": "tiny", "architecture": TINY_ARCH, "in_count": 1, "out_count": 3,
        "grid_xyz": [32, 32, 32], "voxel_mm": 1.0, "dtype": dtype, "batch_size": 2})
    native = {"native_dhw": [30, 34, 30], "native_mm": 1.0}
    write(b / "traffic" / "tiny_train.json", {"driver": "train", **native,
                                              "learning_rate": 0.001, "total_epochs": 100})
    ev = {"driver": "evaluate", **native, "volumes": 3, "lookahead": 2, "post_workers": 1,
          "model_seed": 7}
    write(b / "traffic" / "tiny_stream.json", {**ev, "loop": "stream", "save": True,
                                               "output_type": 0})
    write(b / "traffic" / "tiny_closed.json", {**ev, "loop": "closed", "save": False})
    cells = {"train.tiny": ("tiny_train", {"steps": 2, "limits": {
                 "loss_gap": 1e-3, "grad_gap_med": 1e-3, "change_gap_med": 1e-3}}),
             "evaluate.tiny": ("tiny_stream", {"volumes": 2, "limits": {
                 "label_gap": 1e-3, "file_mismatch": 0}}),
             "interactive.tiny": ("tiny_closed", {"volumes": 2, "limits": {"label_gap": 1e-3}})}
    for name, (_, check) in cells.items():
        write(b / "checks" / f"{name}.json", check)
    kinds = {"train.tiny": "train", "evaluate.tiny": "eval", "interactive.tiny": "eval"}

    def retarget(metrics):
        out = []
        for m in metrics:
            m = dict(m)
            if "workloads" in m:
                kind = "train" if any(w.startswith("train.") for w in m["workloads"]) else "eval"
                m["workloads"] = [c for c, k in kinds.items() if k == kind
                                  and (m["name"] != "eval_p90_s" or c == "interactive.tiny")
                                  and (m["name"] != "save_s.eval" or c == "evaluate.tiny")]
            out.append(m)
        return out

    write(tmp / "BENCHMARK.json", {
        **real,
        "configs": [{"name": "tiny", "source": "a test network", "file":
                     "benchmark/configs/tiny.json", "reduced": [], "why": "CPU tests"}],
        "workloads": [{"name": c, "config": "tiny", "traffic": t, "chips": 1, "why": "CPU tests"}
                      for c, (t, _) in cells.items()],
        "end_to_end": retarget(real["end_to_end"]),
        "per_layer": retarget(real["per_layer"]),
    })
    return tmp


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
