"""Spans from the benchmark's own files and the reading of a
``torch.profiler`` trace.

``span(name)`` wraps a call into the program in a ``record_function``
range named ``bench.<name>`` (host side; nothing is synchronized).
``profiled(fn, workdir)`` runs ``fn`` under the profiler, inside one
``bench.window`` range, exports the Chrome trace into ``workdir``, reads
it and deletes it.  The reading (``Trace``):

- the device's activity: every kernel, memcpy and memset interval within
  the window; ``busy_s`` is the length of their union, ``window_s`` the
  window's;
- each kernel's stage: the innermost ``bench.*`` range that was open on
  the launching thread when it was launched (matched by the launch's
  correlation id), or "" for one launched outside them (the autograd
  engine's thread runs the backward there);
- ``device_ops``: time by kernel name, most first; ``idle_gaps``: the
  longest gaps of the device, each named by what the host was doing at
  its middle (the innermost range or op open then on any thread, or
  "host idle").
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import sys

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str, fn):
    """``fn`` with each call inside a ``bench.<name>`` profiler range."""
    label = f"bench.{name}"

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name`` set to ``value`` inside the block, restored after."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class Trace:
    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == "bench.window"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no bench.window range")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = float(w["dur"]) / 1e6
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
        ranges: dict = {}
        for e in events:
            if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("bench."):
                ranges.setdefault(e["tid"], []).append(e)
        self.kernels = []  # (start_us, end_us, name, stage)
        for e in dev:
            s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            if t <= self.t0 or s >= self.t1:
                continue
            stage = ""
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is not None:
                ts = float(launch["ts"])
                inner = [r for r in ranges.get(launch["tid"], ())
                         if r["name"] != "bench.window"
                         and float(r["ts"]) <= ts <= float(r["ts"]) + float(r["dur"])]
                if inner:
                    stage = min(inner, key=lambda r: float(r["dur"]))["name"][len("bench."):]
            self.kernels.append((max(s, self.t0), min(t, self.t1), e.get("name", "?"), stage))
        self.kernels.sort()
        self.busy_s = sum(t - s for s, t in self._union()) / 1e6
        self._host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                             for e in events if e.get("ph") == "X"
                             and e.get("cat") in ("cpu_op", "user_annotation")
                             and e.get("name") != "bench.window"), key=lambda r: r[0])

    def _union(self):
        out = []
        for s, t, _, _ in self.kernels:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def stage_seconds(self) -> dict:
        """Device seconds of kernels by stage ("" outside every range)."""
        out: dict = {}
        for s, t, _, stage in self.kernels:
            out[stage] = out.get(stage, 0.0) + (t - s) / 1e6
        return out

    def device_ops(self, n: int = 10) -> list:
        by: dict = {}
        for s, t, name, _ in self.kernels:
            by[name] = by.get(name, 0.0) + (t - s) / 1e6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        busy = self._union()
        edges = [self.t0] + [x for s, t in busy for x in (s, t)] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        starts = [h[0] for h in self._host]
        out = []
        for length, start in sorted(gaps, reverse=True)[:n]:
            mid = start + length / 2
            hi = bisect.bisect_right(starts, mid)
            open_ = [h for h in self._host[max(0, hi - 4000):hi] if h[1] >= mid]
            what = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "host idle"
            out.append([what[:160], length / 1e6])
        return out


def log_setup(setup_s: float, stages: dict | None = None) -> None:
    """The set-up time, the kernels' nvcc build time (None: the build
    was found in the checkout) and the seconds since process start at
    which each stage of the set-up ended, on standard error."""
    from unet_studio_tpu_torch.ops import _cuda

    print(f"setup_s {setup_s:.3f}; kernel build seconds {_cuda.last_build_seconds}",
          file=sys.stderr, flush=True)
    if stages:
        print("setup stages ended at: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()),
              file=sys.stderr, flush=True)


def profiled(fn, workdir: str) -> Trace:
    """Run ``fn()`` under ``torch.profiler`` on the card and read the trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            fn()
            torch.cuda.synchronize()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
