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

import contextlib
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
SOURCES = ("conv.cu", "conv_bwd.cu", "conv_tc.cu", "reduce.cu", "warp.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
# the warp equals its twin's order of f32 operations only without
# contraction of a * b + c into one rounding
SOURCE_FLAGS = {"warp.cu": ("-fmad=false",), "conv_tc.cu": ("-Xptxas", "-v"),
                "reduce.cu": ("-Xptxas", "-v")}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {None: 0, "relu": 1, "leaky_relu": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_SIGNATURES = {
    # f32: xa, pa_a, pb_a, act_a, xb, pa_b, pb_b, act_b, ci, w, bias, y,
    # part, stats, D, H, W, co, stride, stream
    "unet_conv3": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _P],
    # D, H, W, stride: rows of unet_conv3's stats partials
    "unet_conv3_rows": [_I, _I, _I, _I],
    # x, pa, pb, act, ci, w, bias, y, D, H, W, co, dtype, stream
    "unet_trans2x": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, mean, n_vox, c, mode, part, ticket, out, dtype, stream
    "unet_channel_moments": [_P, _P, _L, _I, _I, _P, _P, _P, _I, _P],
    # x, n, part, ticket, out, dtype, stream
    "unet_volume_max": [_P, _L, _P, _P, _P, _I, _P],
    # g, x, mean, inv, n_vox, c, part, ticket, out, dtype, stream
    "unet_channel_norm_bwd": [_P, _P, _P, _P, _L, _I, _P, _P, _P, _I, _P],
    # a, AD, AH, AW, ca, b, BD, BH, BW, cb, ks, stride, pad, part, nblk, out,
    # dtype, stream
    "unet_conv_dw": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P,
                     _I, _P],
    # g, co, w, dx, D, H, W, ci, stream (f32)
    "unet_conv3_s2_dx": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
    # g, co, w, dx, D, H, W, ci, dtype, stream
    "unet_trans2x_dx": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    # tensor-core (bf16) route: xa, pa_a, pb_a, act_a, xb, pa_b, pb_b, act_b,
    # ci, w, bias, y, part, stats, D, H, W, co, stream
    "unet_conv3_tc": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _P],
    # x, w, bias, y, part, stats, D, H, W, co, stream
    "unet_conv3_entry_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # K3: x, pa, pb, act, ci, w, bias, y, part, stats, D, H, W, co, stream
    "unet_conv3_s2_tc": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # kind, ci, co, D, H, W: rows of the tensor-core forward's stats partials
    "unet_conv3_tc_rows": [_I, _I, _I, _I, _I, _I],
    # x, g, D, H, W, ci, co, part, nblk, out, stream (bf16 K5)
    "unet_conv_dw_tc": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    # x, g, OD, OH, OW, ci, co, part, nblk, out, stream (bf16 K6)
    "unet_conv_dw_s2_tc": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    # part, nblk, n, out, stream
    "unet_dw_reduce": [_P, _I, _L, _P, _P],
    # g, co, w, dx, OD, OH, OW, ci, stream
    "unet_conv3_s2_dx_tc": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
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
        errors, logs = [], []
        for src, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src}:\n{out}")
            elif "-v" in SOURCE_FLAGS.get(src, ()):
                logs.append(out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        _log_path(target).write_text("".join(logs))
        so_tmp = Path(tmp) / target.name
        subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(so_tmp)],
            check=True, capture_output=True, text=True,
        )
        os.replace(so_tmp, target)  # atomic: a concurrent process never loads half a file


def _log_path(target: Path) -> Path:
    return target.with_suffix(".ptxas.txt")


def ptxas_report() -> list[dict]:
    """Registers, shared memory and spills of each kernel built with
    ``-Xptxas -v`` (``SOURCE_FLAGS``), from the log kept beside the library:
    one dict per kernel, its mangled name and ptxas's lines about it."""
    lib()
    text = _log_path(BUILD_DIR / f"libunet_torch_kernels_{_source_hash()}.so").read_text()
    out, cur = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = {"kernel": line.split("'")[1], "info": []}
            out.append(cur)
        elif cur is not None and ("Used" in line or "spill" in line or "bytes stack" in line):
            cur["info"].append(line.split(":", 1)[-1].strip())
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, last_build_seconds
    if _lib is not None:
        return _lib
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


def on_device(t: torch.Tensor):
    """A context that makes ``t``'s card the current one; nothing to do
    (and no device switch paid) when it already is."""
    if t.device.index == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card (PyTorch's own
    accessor, without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
