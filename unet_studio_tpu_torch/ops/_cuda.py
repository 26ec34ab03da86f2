"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` (Hopper) into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, never at import: one ``nvcc -c`` per source,
all started together, then one link.  The library is keyed by a hash of
the sources and flags and lives in ``<repo>/build/torch_kernels/``
(resolved from this file, not from the working directory), so a second
process reuses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("conv.cu", "conv_bwd.cu", "reduce.cu", "warp.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
# the warp equals its twin's order of f32 operations only without
# contraction of a * b + c into one rounding
SOURCE_FLAGS = {"warp.cu": ("-fmad=false",)}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {None: 0, "relu": 1, "leaky_relu": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_SIGNATURES = {
    # xa, pa_a, pb_a, act_a, xb, pa_b, pb_b, act_b, ci, w, bias, y, stats,
    # D, H, W, co, stride, dtype, stream
    "unet_conv3": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _P],
    # x, pa, pb, act, ci, w, bias, y, D, H, W, co, dtype, stream
    "unet_trans2x": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, mean, n_vox, c, mode, out, dtype, stream
    "unet_channel_moments": [_P, _P, _L, _I, _I, _P, _I, _P],
    # x, n, out, dtype, stream
    "unet_volume_max": [_P, _L, _P, _I, _P],
    # g, x, mean, inv, n_vox, c, out, dtype, stream
    "unet_channel_norm_bwd": [_P, _P, _P, _P, _L, _I, _P, _I, _P],
    # a, AD, AH, AW, ca, b, BD, BH, BW, cb, ks, stride, pad, part, nblk, out,
    # dtype, stream
    "unet_conv_dw": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P,
                     _I, _P],
    # g, co, w, dx, D, H, W, ci, dtype, stream
    "unet_conv3_s2_dx": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    "unet_trans2x_dx": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    # src, sd, sh, sw, coords, od, oh, ow, peak, out_img, out_lab, mode,
    # window, stream
    "unet_warp": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None  # None: loaded from the cache


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()), "-c", str(CSRC / src), "-o",
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        errors = []
        for src, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        so_tmp = Path(tmp) / target.name
        subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(so_tmp)],
            check=True, capture_output=True, text=True,
        )
        os.replace(so_tmp, target)  # atomic: a concurrent process never loads half a file


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, last_build_seconds
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libunet_torch_kernels_{_source_hash()}.so"
            if not target.exists():
                t0 = time.perf_counter()
                _build(target)
                last_build_seconds = time.perf_counter() - t0
            handle = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
