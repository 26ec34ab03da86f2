"""Startup asset discovery (reference: main.cpp:28-82): the root that
holds ``atlas/`` and the model zoo ``unet/*.nz``."""

from __future__ import annotations

import os


def find_asset_root(explicit: str | None = None) -> str | None:
    """Look for an atlas dir at ``explicit``, next to the package, then in
    the CWD."""
    candidates = []
    if explicit:
        candidates.append(explicit)
    candidates.append(os.path.join(os.path.dirname(__file__), "..", ".."))
    candidates.append(os.getcwd())
    for c in candidates:
        if os.path.isdir(os.path.join(c, "atlas")):
            return os.path.abspath(c)
    return None
