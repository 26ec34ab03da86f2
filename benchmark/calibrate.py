"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... --control 1,2,3

For each of ``--seeds``, one run of the cell as ``benchmark.run`` makes
it (``--seconds`` of window; the numbers compared do not depend on its
length) prints its numbers; for each of ``--control``, the control (the
reference in float8 in the program's place, or with ``--fault`` a fault
planted in it) prints its numbers.  All in one process, one JSON line
each, with ``correct``: each reading judged at the cell's own limits
(``checks/<cell>.json``, by ``harness.judge``; a control or a fault is
judged on the numbers it gives, an evaluate control having no written
file).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .harness import ROOT, Bench, cache_dirs, judge


def judge_given(numbers: dict, check: dict) -> tuple[bool, dict]:
    """``judge`` at the check's limits of the numbers given."""
    return judge(numbers, {"limits": {k: v for k, v in check["limits"].items()
                                      if k in numbers}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="", help="with --control: a fault, planted in the "
                    "reference put in the program's place, in place of the control")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    from .run import run_cell

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    for seed in filter(None, args.seeds.split(",")):
        t = time.perf_counter()
        result, checks = run_cell(bench, args.workload, int(seed), args.seconds, False,
                                  t_start=t)
        print(json.dumps({"seed": int(seed), "side": "program", "seconds": time.perf_counter() - t,
                          "numbers": {k: c["value"] for k, c in checks.items()},
                          "correct": result["correct"], "metrics": result["metrics"]}),
              flush=True)
    driver = bench.driver(bench.mix(cell))
    for seed in filter(None, args.control.split(",")):
        t = time.perf_counter()
        numbers = driver.control(cfg=bench.config(cell), mix=bench.mix(cell),
                                 check=bench.check(cell), seed=int(seed),
                                 device="cuda", fault=args.fault)
        torch.cuda.empty_cache()
        correct, _ = judge_given(numbers, bench.check(cell))
        print(json.dumps({"seed": int(seed), "side": args.fault or "control",
                          "seconds": time.perf_counter() - t,
                          "numbers": numbers, "correct": correct}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
