"""Logging: ANSI-coloured out/warning/error streams and nested progress
scopes (the TIPL ``tipl::out/warning/error/progress`` analog; a copy of
unet_studio_tpu/utils/log.py).
"""

from __future__ import annotations

import sys
import time

_COLORS = {"out": "", "warning": "\033[33m", "error": "\033[31m"}
_RESET = "\033[0m"
_depth = 0
show_prog = True


def _emit(kind: str, *args) -> None:
    msg = " ".join(str(a) for a in args)
    prefix = "  " * _depth
    color = _COLORS[kind] if sys.stderr.isatty() else ""
    reset = _RESET if color else ""
    tag = "" if kind == "out" else f"{kind.upper()}: "
    print(f"{prefix}{color}{tag}{msg}{reset}", flush=True)


def out(*args) -> None:
    _emit("out", *args)


def warning(*args) -> None:
    _emit("warning", *args)


def error(*args) -> None:
    _emit("error", *args)


class progress:
    """Scoped timer printing begin/end markers with elapsed time."""

    def __init__(self, title: str):
        self.title = title
        self.t0 = time.time()
        global _depth
        out(f"{title}...")
        _depth += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _depth
        _depth -= 1
        out(f"{self.title} done ({time.time() - self.t0:.1f}s)")
        return False

    def __call__(self, i: int, n: int) -> bool:
        """Iteration ticker; returns True while work should continue."""
        return True
