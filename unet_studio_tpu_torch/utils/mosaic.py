"""Mosaic export: a 3D volume's slices tiled into one 2D image, saved as
PNG (the GUI's mosaic export, mainwindow_training.cpp:814-840; the
counterpart of unet_studio_tpu/utils/mosaic.py)."""

from __future__ import annotations

import math

import numpy as np

from ..ui.png import LABEL_COLORS, encode_png


def make_mosaic(vol: np.ndarray, label: np.ndarray | None = None, axis: int = 0,
                max_tiles: int = 64, alpha: float = 0.45) -> np.ndarray:
    """(D, H, W) volume -> (rows*h, cols*w [, 3]) uint8 mosaic, with the
    label's colours over it when given."""
    n = vol.shape[axis]
    step = max(1, n // max_tiles)
    indices = list(range(0, n, step))[:max_tiles]
    mx = max(float(vol.max()), 1e-9)
    tiles = [(np.clip(np.take(vol, i, axis=axis) / mx, 0, 1) * 255).astype(np.uint8)
             for i in indices]
    if label is not None:
        colored = []
        for t, i in zip(tiles, indices):
            lab = np.clip(np.take(label, i, axis=axis).astype(np.int32), 0,
                          len(LABEL_COLORS) - 1)
            rgb = np.repeat(t[..., None], 3, -1).astype(np.float32)
            m = (lab > 0)[..., None]
            c = LABEL_COLORS[lab].astype(np.float32)
            colored.append(np.where(m, (1 - alpha) * rgb + alpha * c, rgb).astype(np.uint8))
        tiles = colored
    cols = int(math.ceil(math.sqrt(len(tiles))))
    rows = int(math.ceil(len(tiles) / cols))
    th, tw = tiles[0].shape[:2]
    out = np.zeros((rows * th, cols * tw) + tiles[0].shape[2:], np.uint8)
    for k, t in enumerate(tiles):
        r, c = divmod(k, cols)
        out[r * th:(r + 1) * th, c * tw:(c + 1) * tw] = t
    return out


def save_mosaic_png(path: str, vol, label=None, axis: int = 0, max_tiles: int = 64) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(make_mosaic(np.asarray(vol), label, axis, max_tiles)))
