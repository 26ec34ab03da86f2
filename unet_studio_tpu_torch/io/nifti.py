"""NIfTI-1 codec (.nii / .nii.gz), host-side, numpy only.

Provides the observable I/O surface the reference gets from TIPL's
``tipl::io::gz_nifti`` (reference: train.cpp:13-40, evaluate.cpp:424-458):

* read volume + dims + voxel size + srow affine
* "is MNI" template flag (sform/qform code == NIFTI_XFORM_MNI_152)
* LPS canonicalization with a recorded flip/swap sequence that can be
  replayed in reverse at save time (TIPL's ``apply_flip_swap_seq``)
* 3D and 4D float/int volumes, gz or plain

Array layout convention: volumes are returned as C-contiguous numpy
arrays with shape ``(nz, ny, nx)`` (z slowest), i.e. the (D, H, W)
layout the compute path uses. 4D data is ``(nt, nz, ny, nx)``.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

# NIfTI-1 datatype codes
_DT_UINT8 = 2
_DT_INT16 = 4
_DT_INT32 = 8
_DT_FLOAT32 = 16
_DT_FLOAT64 = 64
_DT_INT8 = 256
_DT_UINT16 = 512
_DT_UINT32 = 768

_DTYPES = {
    _DT_UINT8: np.uint8,
    _DT_INT16: np.int16,
    _DT_INT32: np.int32,
    _DT_FLOAT32: np.float32,
    _DT_FLOAT64: np.float64,
    _DT_INT8: np.int8,
    _DT_UINT16: np.uint16,
    _DT_UINT32: np.uint32,
}

_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_XFORM_MNI_152 = 4

HEADER_SIZE = 348


@dataclass
class NiftiImage:
    """A loaded NIfTI volume plus the metadata the pipelines consume."""

    data: np.ndarray  # (nz,ny,nx) or (nt,nz,ny,nx), C-contiguous
    voxel_size: np.ndarray  # (3,) float32: (vx, vy, vz) in x,y,z order
    affine: np.ndarray  # (4,4) float32 srow (voxel (x,y,z,1) -> world)
    is_mni: bool = False
    descrip: str = ""
    flip_swap: list[str] = field(default_factory=list)

    @property
    def shape_xyz(self) -> tuple[int, int, int]:
        """Spatial dims as (nx, ny, nz)."""
        s = self.data.shape[-3:]
        return (s[2], s[1], s[0])


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        # compresslevel 6: gzip's default 9 is several times slower for a
        # few percent size on typical volumes
        return gzip.open(path, mode, compresslevel=6) if "w" in mode else gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> NiftiImage:
    with _open(path, "rb") as f:
        hdr = f.read(HEADER_SIZE)
        if len(hdr) < HEADER_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        if sizeof_hdr != HEADER_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        dim = struct.unpack_from("<8h", hdr, 40)
        datatype = struct.unpack_from("<h", hdr, 70)[0]
        pixdim = struct.unpack_from("<8f", hdr, 76)
        vox_offset = struct.unpack_from("<f", hdr, 108)[0]
        scl_slope = struct.unpack_from("<f", hdr, 112)[0]
        scl_inter = struct.unpack_from("<f", hdr, 116)[0]
        descrip = hdr[148:228].split(b"\0")[0].decode("latin-1", "replace")
        qform_code = struct.unpack_from("<h", hdr, 252)[0]
        sform_code = struct.unpack_from("<h", hdr, 254)[0]
        srow = np.array(struct.unpack_from("<12f", hdr, 280), np.float32).reshape(3, 4)
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        ndim = int(dim[0])
        if ndim < 3:
            # promote 2D to 3D with nz=1
            nx, ny, nz, nt = int(dim[1]), int(dim[2] or 1), 1, 1
        else:
            nx, ny, nz = int(dim[1]), int(dim[2]), int(dim[3])
            nt = int(dim[4]) if ndim >= 4 and dim[4] > 1 else 1

        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        np_dtype = _DTYPES[datatype]

        count = nx * ny * nz * nt
        skip = int(vox_offset) - HEADER_SIZE
        if skip > 0:
            f.read(skip)
        raw = f.read(count * np.dtype(np_dtype).itemsize)
        arr = np.frombuffer(raw, dtype=np_dtype, count=count)

    # file order: x fastest -> reshape (nt, nz, ny, nx)
    arr = arr.reshape(nt, nz, ny, nx)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        arr = arr.astype(np.float32) * np.float32(slope) + np.float32(scl_inter)
    if nt == 1:
        arr = arr[0]

    affine = np.eye(4, dtype=np.float32)
    if sform_code > 0:
        affine[:3, :] = srow
    else:
        # fall back to pixdim scaling only (qform rotation unsupported on purpose:
        # the reference pipelines only consume scale + translation, train.cpp:26-29)
        affine[0, 0] = pixdim[1] or 1.0
        affine[1, 1] = pixdim[2] or 1.0
        affine[2, 2] = pixdim[3] or 1.0

    voxel_size = np.array(
        [abs(pixdim[1]) or 1.0, abs(pixdim[2]) or 1.0, abs(pixdim[3]) or 1.0],
        np.float32,
    )

    is_mni = (sform_code == _XFORM_MNI_152) or (qform_code == _XFORM_MNI_152) or (
        "mni" in descrip.lower()
    )
    return NiftiImage(
        data=np.ascontiguousarray(arr),
        voxel_size=voxel_size,
        affine=affine,
        is_mni=is_mni,
        descrip=descrip,
    )


def write_nifti(
    path: str,
    data: np.ndarray,
    voxel_size=(1.0, 1.0, 1.0),
    affine: np.ndarray | None = None,
    is_mni: bool = False,
    descrip: str = "unet_studio_tpu_torch",
) -> None:
    """Write (nz,ny,nx) or (nt,nz,ny,nx) array as NIfTI-1 (.nii or .nii.gz)."""
    data = np.asarray(data)
    if data.ndim == 3:
        nt, (nz, ny, nx) = 1, data.shape
        ndim = 3
    elif data.ndim == 4:
        nt = data.shape[0]
        nz, ny, nx = data.shape[1:]
        ndim = 4
    else:
        raise ValueError(f"expected 3D/4D array, got shape {data.shape}")

    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype == np.int64:
        data = data.astype(np.int32)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    dt_code = _CODES.get(np.dtype(data.dtype))
    if dt_code is None:
        data = data.astype(np.float32)
        dt_code = _DT_FLOAT32
    itemsize = data.dtype.itemsize

    if affine is None:
        affine = np.diag([voxel_size[0], voxel_size[1], voxel_size[2], 1.0]).astype(
            np.float32
        )
    affine = np.asarray(affine, np.float32)

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dim = [ndim, nx, ny, nz, nt, 1, 1, 1]
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, dt_code)
    struct.pack_into("<h", hdr, 72, itemsize * 8)  # bitpix
    pixdim = [1.0, float(voxel_size[0]), float(voxel_size[1]), float(voxel_size[2]), 1.0, 1.0, 1.0, 1.0]
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    db = descrip.encode("latin-1", "replace")[:79]
    hdr[148 : 148 + len(db)] = db
    code = _XFORM_MNI_152 if is_mni else 1
    struct.pack_into("<h", hdr, 252, code)  # qform_code
    struct.pack_into("<h", hdr, 254, code)  # sform_code
    # quatern b,c,d + offsets kept zero; sform carries geometry
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].reshape(-1).tolist())
    hdr[344:348] = b"n+1\0"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\0\0\0\0")  # extension flag
        f.write(np.ascontiguousarray(data).tobytes())


# ---------------------------------------------------------------------------
# flip/swap canonicalization (TIPL apply_flip_swap_seq analog,
# reference usage: evaluate.cpp:434)
# ---------------------------------------------------------------------------

def apply_flip_swap(data: np.ndarray, ops: list[str], reverse: bool = False) -> np.ndarray:
    """Apply a flip/swap op sequence to (…,nz,ny,nx) data.

    With ``reverse=True`` the sequence is undone (ops applied in reverse
    order; each op is its own inverse).
    """
    seq = list(reversed(ops)) if reverse else ops
    ax = lambda xyz: data.ndim - 1 - xyz  # noqa: E731  x->last axis
    for op in seq:
        if op == "flip_x":
            data = np.flip(data, axis=ax(0))
        elif op == "flip_y":
            data = np.flip(data, axis=ax(1))
        elif op == "flip_z":
            data = np.flip(data, axis=ax(2))
        elif op == "swap_xy":
            data = np.swapaxes(data, ax(0), ax(1))
        elif op == "swap_yz":
            data = np.swapaxes(data, ax(1), ax(2))
        elif op == "swap_xz":
            data = np.swapaxes(data, ax(0), ax(2))
        else:
            raise ValueError(f"unknown flip/swap op {op}")
    return np.ascontiguousarray(data)


def canonicalize_lps(img: NiftiImage) -> NiftiImage:
    """Reorient to the LPS-like voxel order the model zoo was trained in.

    Mirrors TIPL's load-time reorientation: permute/flip voxel axes so the
    affine's rotation part is closest to ``diag(-, -, +)``.  Records the
    flip/swap sequence in ``img.flip_swap`` so results can be written back
    in the original file orientation (evaluate.cpp:431-438).
    """
    A = img.affine[:3, :3].copy()
    ops: list[str] = []
    data = img.data

    # 1. permute: for each world axis, find the voxel axis with max |component|
    perm = [int(np.argmax(np.abs(A[i]))) for i in range(3)]
    if len(set(perm)) != 3:
        # degenerate affine; keep as-is
        perm = [0, 1, 2]
    # express permutation as a sequence of swaps on (x,y,z)
    cur = [0, 1, 2]
    swap_names = {(0, 1): "swap_xy", (1, 2): "swap_yz", (0, 2): "swap_xz"}
    for world in range(3):
        src = cur.index(perm[world])
        if src != world:
            a, b = min(src, world), max(src, world)
            ops.append(swap_names[(a, b)])
            cur[src], cur[world] = cur[world], cur[src]
            A[:, [src, world]] = A[:, [world, src]]
    # 2. flips: want sign(A[0,0]) < 0, sign(A[1,1]) < 0, sign(A[2,2]) > 0
    want = (-1.0, -1.0, 1.0)
    for axis, w in enumerate(want):
        if A[axis, axis] * w < 0:
            ops.append(("flip_x", "flip_y", "flip_z")[axis])
            A[:, axis] = -A[:, axis]

    if ops:
        data = apply_flip_swap(data, ops)
        vs = img.voxel_size[[abs_axis for abs_axis in perm]]
    else:
        vs = img.voxel_size
    out_affine = img.affine.copy()
    out_affine[:3, :3] = A
    return NiftiImage(
        data=data,
        voxel_size=np.asarray(vs, np.float32),
        affine=out_affine,
        is_mni=img.is_mni,
        descrip=img.descrip,
        flip_swap=ops,
    )
