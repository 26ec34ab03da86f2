"""Everything the benchmark finds by name, and the result line.

``BENCHMARK.json`` at the root names the cells.  For a cell:

- its configuration is the file its ``configs`` entry names
  (``configs/<name>.json``: the architecture, grid, dtype, batch);
- its traffic mix is ``traffic/<mix>.json``, a file of parameters whose
  ``driver`` names the general generator that reads it (``train`` or
  ``evaluate``, the modules ``drive_<driver>.py``);
- its check, ``checks/<cell>.json``: how much of the timed path the
  reference follows (``steps`` of a train cell, ``volumes`` of an
  evaluate cell) and the limit of each number that decides ``correct``;
- each metric, end-to-end or per-layer, is read from the run's
  observations by ``metrics/<name>.py``'s ``read(obs)``, which returns
  None where it finds nothing to read; the harness then leaves the
  metric out.

So a cell, a mix or a metric comes with new files and new entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "unet_studio_tpu")


class Bench:
    """``BENCHMARK.json`` and the files of the benchmark under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self.dir = self.root / "benchmark"

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def mix(self, cell: dict) -> dict:
        with open(self.dir / "traffic" / f"{cell['traffic']}.json") as f:
            return json.load(f)

    def check(self, cell: dict) -> dict:
        with open(self.dir / "checks" / f"{cell['name']}.json") as f:
            return json.load(f)

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The cell's metrics: its end-to-end ones, or with ``trace`` its
        per-layer ones (a metric without ``workloads`` is every cell's)."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def driver(self, mix: dict):
        return importlib.import_module(f"benchmark.drive_{mix['driver']}")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metrics(bench: Bench, cell: dict, trace: bool, obs: dict) -> dict:
    out = {}
    for m in bench.metrics(cell, trace):
        v = bench.reader(m["name"])(obs)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): each number compared beside its limit; a number
    that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits["limits"].items():
        v = numbers.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, the checks as its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)


def cache_dirs(root: Path = ROOT) -> None:
    """The program's and the toolchain's build and kernel caches at fixed
    paths inside the checkout (the kernels' nvcc build is already at
    ``build/torch_kernels``)."""
    base = Path(root) / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
