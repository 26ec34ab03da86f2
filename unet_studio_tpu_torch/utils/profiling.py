"""Tracing and timing (the counterpart of unet_studio_tpu/utils/profiling.py).

* ``span(name, **ids)`` and ``count(name, n=1)``: the program's tracer.
  It is on exactly while a ``torch.profiler`` profile runs in the
  process (``trace`` below starts one); otherwise ``span`` returns a
  shared no-op after one read of torch's process-wide profiler flag, and
  ``count`` returns.  While on, a span opens the profiler range
  ``unet.<name>`` (so the kernels launched inside it, and the device's
  idle gaps, carry the stage's name) and, when it closes, appends one
  ``Record`` to a bounded buffer: name, thread, start and end on
  ``time.perf_counter_ns()``, parent span, ``ids`` (one train item's
  spans share ``seed_id``, one volume's ``seq`` and ``path``) and the
  counts that ``count`` added while it was the innermost open span of its
  thread.  The buffer restarts when a profile starts, so ``records()``
  is the last profiled stretch.  While on, torch's sync debug mode is
  set to warn, and each of its warnings (an ``.item()``, a copy to the
  host, a blocking copy from pageable host memory, a synchronize) is
  counted as ``sync`` on the innermost open span of the thread that
  waited, and not shown.
* ``trace(log_dir)``: a context manager around ``torch.profiler``; writes
  a Chrome trace (Perfetto, chrome://tracing) into ``log_dir``, with the
  spans of every thread added on the trace's clock (``trace_offset_us``)
  as the ``unet spans`` process: the profiler itself records only the
  thread that started it.
* ``device_time``: seconds per call of a function, from CUDA events over
  ``iters`` back-to-back calls on the card (PyTorch returns before the
  card is done, so a host clock would time the enqueue), from
  ``perf_counter`` on the CPU.

The stage spans: ``synth`` (one train item, ``seed_id``) with
``synth.draw``, ``synth.simulate``, ``synth.lowpass``, ``synth.crop``,
``synth.trunc``, ``synth.noise``, ``synth.lighting``, ``synth.coords``,
``synth.warp``, ``synth.normalize``, ``synth.stamp``, ``synth.perlin``;
``train.forward_loss``, ``train.backward``, ``train.accumulate``,
``train.allreduce``, ``train.optimizer``, ``train.valid``,
``train.assemble``; ``eval.read`` (``.inflate``, ``.canonicalize``,
``.normalize``) on the reader thread, ``eval.wait`` and ``eval.infer``
(``.h2d``, ``.forward``, ``.fetch``) on the driving thread, ``eval.post``
on the output pool, ``eval.save`` (``.write``).  Besides ``sync``, one
counter: ``const_miss``, a constant of the synthesis computed anew (a key
missing from ``ops/augment.py``'s caches), on ``synth.warp`` or
``synth.lowpass``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import statistics
import threading
import time
import warnings
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

from .device import resolve_device

MAX_RECORDS = 1 << 16
SYNC_WARNING = "called a synchronizing CUDA operation"


class Record(NamedTuple):
    id: int
    name: str
    thread: str
    tid: int  # the native thread id, as the profiler's trace has it
    start_ns: int
    end_ns: int
    parent: int | None
    ids: dict
    counts: dict


class _Noop:
    """The span while tracing is off (one per name, shared)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **ids) -> None:
        pass

    def __call__(self, fn):
        return _wrap(self.name, fn)


class _Span:
    __slots__ = ("name", "ids", "counts", "id", "parent", "start", "_range")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids, self.counts = name, ids, {}

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_TRACER.ids)
        self._range = torch.profiler.record_function("unet." + self.name)
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self._range.__exit__(*exc)
        t = threading.current_thread()
        _TRACER.add(Record(self.id, self.name, t.name, t.native_id, self.start, end, self.parent,
                           self.ids, self.counts))
        return False

    def tag(self, **ids) -> None:
        """Add ids known only inside the span (what a wait received)."""
        self.ids.update(ids)

    def __call__(self, fn):
        return _wrap(self.name, fn)


class _Tracer:
    """The buffer of one profiled stretch and what a stretch switches on."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list[Record] = []
        self.dropped = 0
        self.ids = itertools.count()
        self._warnings = None
        self._sync_mode = None

    def add(self, rec: Record) -> None:
        with self.lock:
            if len(self.records) < MAX_RECORDS:
                self.records.append(rec)
            else:
                self.dropped += 1

    def begin(self) -> None:
        """A profile starts: a new stretch, and host syncs counted."""
        with self.lock:
            self.records, self.dropped = [], 0
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
        shown = warnings.showwarning

        def counted(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                count("sync")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = counted
        # only a card already in use: the debug mode would initialize CUDA
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():  # torch's note that the mode is a prototype
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode("warn")

    def end(self) -> None:
        if self._sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._sync_mode = None
        if self._warnings is not None:
            self._warnings.__exit__(None, None, None)
            self._warnings = None


_TRACER = _Tracer()
_NOOPS: dict[str, _Noop] = {}
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _wrap(name: str, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return wrapped


def span(name: str, **ids):
    """A stage of the program: ``with span("synth", seed_id=7):`` or
    ``@span("eval.post")`` (ids belong to the ``with`` form).  A no-op
    unless a profile runs."""
    if not _profiler._is_profiler_enabled:
        noop = _NOOPS.get(name)
        return noop if noop is not None else _NOOPS.setdefault(name, _Noop(name))
    return _Span(name, ids)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``name`` on the innermost open span of this thread
    (nothing unless a profile runs, or outside every span)."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n


def records() -> list[Record]:
    """The spans of the last profiled stretch, in the order they closed."""
    with _TRACER.lock:
        return list(_TRACER.records)


def dropped() -> int:
    """Spans of the last stretch left out of the full buffer."""
    return _TRACER.dropped


def _hook_profiler() -> None:
    """Run ``_TRACER.begin``/``end`` where torch marks a profile's start
    and stop (the functions that set its process-wide flag)."""
    start, stop = _profiler._run_on_profiler_start, _profiler._run_on_profiler_stop

    def on_start():
        start()
        _TRACER.begin()

    def on_stop():
        _TRACER.end()
        stop()

    _profiler._run_on_profiler_start, _profiler._run_on_profiler_stop = on_start, on_stop


_hook_profiler()


def trace_offset_us(recs: list[Record], events: list) -> float | None:
    """What to add to a span's ``perf_counter_ns() / 1e3`` to place it on
    a Chrome trace's clock: the median, over the spans that the trace also
    holds as ``unet.<name>`` ranges (those of the thread that ran the
    profile), of range start minus span start, paired in order per
    (thread, name); None without such a span."""
    theirs: dict = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and name.startswith("unet."):
            theirs.setdefault((e.get("tid"), name[5:]), []).append(float(e["ts"]))
    mine: dict = {}
    for r in recs:
        mine.setdefault((r.tid, r.name), []).append(r.start_ns / 1e3)
    diffs = []
    for key, ts in theirs.items():
        ours = mine.get(key)
        if ours is not None and len(ours) == len(ts):
            diffs += [a - b for a, b in zip(sorted(ts), sorted(ours))]
    return statistics.median(diffs) if diffs else None


def span_events(recs: list[Record], offset_us: float) -> list:
    """The spans as Chrome trace events on the trace's clock, one thread
    of the ``unet spans`` process per thread that ran them."""
    out, threads = [], {}
    for r in recs:
        threads[r.tid] = r.thread
        out.append({"ph": "X", "cat": "unet_span", "name": "unet." + r.name, "pid": "unet spans",
                    "tid": r.tid, "ts": r.start_ns / 1e3 + offset_us,
                    "dur": (r.end_ns - r.start_ns) / 1e3,
                    "args": {"id": r.id, "parent": r.parent, **r.ids, **r.counts}})
    out += [{"ph": "M", "name": "thread_name", "pid": "unet spans", "tid": tid,
             "args": {"name": name}} for tid, name in threads.items()]
    return out


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the body on ``device`` (default: the card) and the host;
    yields the profiler, and writes ``trace_<pid>_<ns>.json`` into
    ``log_dir`` when the body ends, the program's spans of every thread
    included."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with span("trace"):  # one range of this thread: the clocks' anchor
            yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    recs = records()
    offset = trace_offset_us(recs, doc["traceEvents"])
    if offset is not None:
        doc["traceEvents"] += span_events(recs, offset)
        with open(path, "w") as f:
            json.dump(doc, f)


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
