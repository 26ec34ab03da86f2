"""Tracing and timing (the counterpart of unet_studio_tpu/utils/profiling.py).

* ``trace(log_dir)``: a context manager around ``torch.profiler``; writes
  a Chrome trace (Perfetto, chrome://tracing) into ``log_dir``.
* ``RateMeter``: steps/sec or volumes/sec with an exponential average.
* ``device_time``: seconds per call of a function, from CUDA events over
  ``iters`` back-to-back calls on the card (PyTorch returns before the
  card is done, so a host clock would time the enqueue), from
  ``perf_counter`` on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the body on ``device`` (default: the card) and the host;
    yields the profiler, and writes ``trace_<pid>_<ns>.json`` into
    ``log_dir`` when the body ends."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json"))


class RateMeter:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.rate = 0.0
        self._last: float | None = None

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = n / max(now - self._last, 1e-9)
            self.rate = inst if self.rate == 0 else (
                self.ema * self.rate + (1 - self.ema) * inst
            )
        self._last = now
        return self.rate


def device_time(fn, *args, iters: int = 50, device=None) -> float:
    """Seconds per call of ``fn(*args)`` on ``device`` (default: the
    card), after one warm-up call: CUDA events around ``iters`` calls and
    one synchronize on the card, the host clock on the CPU."""
    dev = resolve_device(device)
    fn(*args)
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t) / iters
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
