"""One run of one benchmark cell on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It sets up and warms up (``setup_s``),
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks``.  Without a card, or with fewer cards
than the cell asks for, it prints no result and exits with 2; it exits
with 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from .harness import (  # noqa: E402
    ROOT,
    Bench,
    cache_dirs,
    emit,
    forbidden_modules,
    judge,
    read_metrics,
)


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> tuple[dict, dict]:
    """Set up, measure and check one cell; (result, checks)."""
    import torch

    cell = bench.cell(name)
    cfg, mix = bench.config(cell), bench.mix(cell)
    check = bench.check(cell)
    workdir = tempfile.mkdtemp(prefix="unet-bench-")
    try:
        obs, numbers, attempted, failed = bench.driver(mix).run(
            cfg=cfg, mix=mix, check=check, seed=seed, seconds=seconds, trace=trace, device=device,
            workdir=workdir, t_start=T_START if t_start is None else t_start)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct, checks = judge(numbers, check)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name() if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": int(obs["memory_peak_bytes"])}
    if trace and "trace" in obs:
        dev["busy_s"] = obs["trace"].busy_s
        dev["window_s"] = obs["trace"].window_s
    result = {"correct": bool(correct and not failed), "attempted": attempted, "failed": failed,
              "metrics": read_metrics(bench, cell, trace, obs), "device": dev}
    if trace and "trace" in obs:
        result["breakdown"] = {"device_ops": obs["trace"].device_ops(),
                               "idle_gaps": obs["trace"].idle_gaps()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    bench = Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result, checks)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
