"""Minimal PNG encoder (stdlib zlib only) and the label overlay colours,
for slice views and the CLI's mosaic (the counterpart of
unet_studio_tpu/ui/png.py)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """img: (H, W) uint8 grayscale or (H, W, 3) uint8 RGB -> PNG bytes."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        color_type = 0
        img = img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


# distinct label colours (RGB); class 0 is left unpainted
LABEL_COLORS = np.array(
    [
        [0, 0, 0],
        [255, 80, 80],
        [80, 160, 255],
        [90, 220, 90],
        [255, 200, 60],
        [210, 90, 230],
        [80, 220, 220],
        [255, 130, 40],
        [160, 160, 255],
        [200, 255, 100],
        [255, 110, 180],
    ],
    np.uint8,
)


def render_slice(image2d: np.ndarray, label2d: np.ndarray | None = None, vmin: float = 0.0,
                 vmax: float = 1.0, alpha: float = 0.45) -> bytes:
    """A grayscale slice with an optional coloured label overlay -> PNG
    bytes."""
    g = np.clip((image2d.astype(np.float32) - vmin) / max(vmax - vmin, 1e-9), 0, 1)
    g8 = (g * 255).astype(np.uint8)
    if label2d is None:
        return encode_png(g8)
    lab = np.clip(label2d.astype(np.int32), 0, len(LABEL_COLORS) - 1)
    color = LABEL_COLORS[lab]
    rgb = np.repeat(g8[..., None], 3, axis=-1).astype(np.float32)
    mask = (lab > 0)[..., None]
    out = np.where(mask, (1 - alpha) * rgb + alpha * color.astype(np.float32), rgb)
    return encode_png(out.astype(np.uint8))
