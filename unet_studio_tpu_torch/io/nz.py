"""`.nz` model container codec (gz-compressed MAT-v4 style records).

The reference serializes models with TIPL's ``gz_mat_read``/``gz_mat_write``
(main.cpp:157-233): a gzip stream of MATLAB Level-4 matrix records.  Keys:
``channels`` [in,out], ``architecture`` (string), ``dimension`` (3 ints),
``voxel_size`` (3 floats), ``fov_strategy``/``preproc``/``orientation``/
``postproc`` (strings), ``single_component_label``, ``testing_errors``,
``training_errors``, then ``tensor0..tensorN`` — one float matrix per
parameter in the model's registration order.

Record layout (MAT v4): 5 x int32 header ``[type, rows, cols, imagf,
namelen]``; ``type = P*10`` with P in {0:f64, 1:f32, 2:i32, 3:i16, 4:u16,
5:u8}; then the NUL-terminated name; then ``rows*cols`` elements
column-major.

Sloped (lossy) tensor compression (main.cpp:223-229 sets
``apply_slope=true`` and ``min_size_for_mask_slope=1024``): large float
tensors are quantized to uint8 with value 0 reserved for exact zeros
("mask") and 1..255 spanning [inter, inter+254*slope].  The slope pair is
carried in a sibling float32 record named ``<name>.slope`` holding
``[slope, inter]``; readers dequantize transparently.  TIPL itself is not
vendored in the reference snapshot, so this is a reconstruction of the
format from its call sites — round-trip fidelity is covered by tests, and
the reader also accepts plain float32/float64/int16 tensors.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

_P_TO_DTYPE = {
    0: np.float64,
    1: np.float32,
    2: np.int32,
    3: np.int16,
    4: np.uint16,
    5: np.uint8,
}
_DTYPE_TO_P = {np.dtype(v): k for k, v in _P_TO_DTYPE.items()}

SLOPE_SUFFIX = ".slope"


@dataclass
class NzModelFile:
    """Ordered key -> (rows, cols, array) container."""

    entries: dict[str, np.ndarray] = field(default_factory=dict)
    shapes: dict[str, tuple[int, int]] = field(default_factory=dict)

    def get_string(self, key: str, default: str = "") -> str:
        if key not in self.entries:
            return default
        raw = np.asarray(self.entries[key])
        return bytes(raw.astype(np.uint8).reshape(-1).tobytes()).split(b"\0")[0].decode(
            "utf-8", "replace"
        )

    def get_array(self, key: str, dtype=None):
        arr = self.entries.get(key)
        if arr is None:
            return None
        return arr.astype(dtype) if dtype is not None else arr

    def __contains__(self, key: str) -> bool:
        return key in self.entries


def _read_record(f):
    hdr = f.read(20)
    if len(hdr) < 20:
        return None
    type_code, rows, cols, imagf, namelen = struct.unpack("<5i", hdr)
    if namelen <= 0 or namelen > 4096 or rows < 0 or cols < 0:
        raise ValueError(f"corrupt .nz record header {hdr!r}")
    name = f.read(namelen).split(b"\0")[0].decode("utf-8", "replace")
    p = (type_code // 10) % 10
    if p not in _P_TO_DTYPE:
        raise ValueError(f"unsupported .nz element type {type_code} for {name!r}")
    dtype = np.dtype(_P_TO_DTYPE[p])
    n = rows * cols
    buf = f.read(n * dtype.itemsize)
    if len(buf) < n * dtype.itemsize:
        raise ValueError(f".nz record {name!r} truncated")
    arr = np.frombuffer(buf, dtype=dtype, count=n)
    # column-major (rows, cols); we keep flat + shape, consumers reshape
    return name, rows, cols, arr


def read_nz(path: str) -> NzModelFile:
    out = NzModelFile()
    raw_shapes: dict[str, tuple[int, int]] = {}
    with gzip.open(path, "rb") as f:
        while True:
            rec = _read_record(f)
            if rec is None:
                break
            name, rows, cols, arr = rec
            out.entries[name] = arr
            raw_shapes[name] = (rows, cols)

    # transparently dequantize sloped records
    for name in list(out.entries.keys()):
        if name.endswith(SLOPE_SUFFIX):
            continue
        slope_key = name + SLOPE_SUFFIX
        if slope_key in out.entries and out.entries[name].dtype != np.float32:
            q = out.entries[name]
            slope, inter = np.asarray(out.entries[slope_key], np.float64)[:2]
            deq = np.where(
                q == 0, 0.0, (q.astype(np.float64) - 1.0) * slope + inter
            ).astype(np.float32)
            out.entries[name] = deq
            del out.entries[slope_key]
            raw_shapes.pop(slope_key, None)
    out.shapes = {k: raw_shapes[k] for k in out.entries}
    return out


def _write_record(f, name: str, arr: np.ndarray, rows: int, cols: int):
    dtype = np.dtype(arr.dtype)
    if dtype == np.int64:
        arr, dtype = arr.astype(np.int32), np.dtype(np.int32)
    if dtype == np.uint32:
        arr, dtype = arr.astype(np.int32), np.dtype(np.int32)
    if dtype not in _DTYPE_TO_P:
        arr, dtype = arr.astype(np.float32), np.dtype(np.float32)
    type_code = _DTYPE_TO_P[dtype] * 10
    nb = name.encode("utf-8") + b"\0"
    f.write(struct.pack("<5i", type_code, rows, cols, 0, len(nb)))
    f.write(nb)
    f.write(np.ascontiguousarray(arr.reshape(-1)).tobytes())


def _quantize_mask_slope(x: np.ndarray):
    """uint8 mask+slope quantization: 0 stays 0, rest mapped to 1..255."""
    flat = x.reshape(-1).astype(np.float64)
    nz = flat != 0.0
    if not nz.any():
        return flat.astype(np.uint8), np.array([1.0, 0.0], np.float32)
    vmin = flat[nz].min()
    vmax = flat[nz].max()
    slope = (vmax - vmin) / 254.0
    if slope == 0.0:
        slope = 1.0
    q = np.zeros(flat.shape, np.uint8)
    q[nz] = np.clip(np.rint((flat[nz] - vmin) / slope) + 1.0, 1, 255).astype(np.uint8)
    return q, np.array([slope, vmin], np.float32)


def write_nz(
    path: str,
    entries: dict[str, object],
    shapes: dict[str, tuple[int, int]] | None = None,
    sloped_keys: set[str] | frozenset[str] = frozenset(),
    min_size_for_slope: int = 1024,
    precision: dict[str, int] | None = None,
) -> None:
    """Write an ordered dict of entries to a .nz container.

    ``entries`` values: str (written as uint8 text), or array-like.
    ``shapes[k] = (rows, cols)`` overrides the default 1 x N layout.
    Keys in ``sloped_keys`` with >= ``min_size_for_slope`` float elements
    are quantized with the mask+slope scheme (main.cpp:223-229).
    ``precision[k]`` rounds float entries to that many decimals
    (the reference stores error histories at precision 3, main.cpp:220-221).
    """
    shapes = shapes or {}
    precision = precision or {}
    with gzip.open(path, "wb", compresslevel=6) as f:
        for name, value in entries.items():
            if isinstance(value, str):
                data = np.frombuffer(value.encode("utf-8") + b"\0", np.uint8).copy()
                _write_record(f, name, data, 1, len(data))
                continue
            arr = np.asarray(value)
            rows, cols = shapes.get(name, (1, arr.size))
            if rows * cols != arr.size:
                raise ValueError(
                    f"shape {(rows, cols)} does not match size {arr.size} for {name!r}"
                )
            if name in precision and arr.dtype.kind == "f":
                arr = np.round(arr.astype(np.float64), precision[name]).astype(
                    np.float32
                )
            if (
                name in sloped_keys
                and arr.dtype.kind == "f"
                and arr.size >= min_size_for_slope
            ):
                q, slope_pair = _quantize_mask_slope(arr)
                _write_record(f, name, q, rows, cols)
                _write_record(f, name + SLOPE_SUFFIX, slope_pair, 1, 2)
            else:
                _write_record(f, name, arr, rows, cols)
