"""The benchmark's inputs, all made from ``--seed``: the network's weights
and the volumes, on the card in a few large calls of one
``torch.Generator``, and a NIfTI-1 writer and reader for the files the
program reads and writes.

- ``make_weights``: the conv and transposed-conv weights U(+-1/sqrt(fan_in))
  (torch's module default, the program's ``init_params`` distribution)
  from one uniform draw; every bias 0 and every norm scale 1 (as nnU-Net's
  He init sets biases: drawn head biases set the classes' shares, and
  with them how long a label file takes to write, by seed).
- ``template_pair`` and ``heads``: smooth synthetic heads, ellipsoids of
  random centre, radii and texture (a frozen copy of chip_smoke.py's
  ``phantom_batch`` pattern, with phase 8's zero background for the
  template); labels 0 outside, 1 the shell, 2 the core.  The heads are
  int16 T1w-like scans with uniform noise on every voxel, so that their
  gzip files are as hard to inflate as a scan's.
- ``write_nifti`` / ``read_nifti``: frozen copies of the program's
  io/nifti.py codec, reduced to 3-D volumes with a diagonal affine.
"""

from __future__ import annotations

import gzip
import math
import struct

import numpy as np
import torch

from .reference.net import param_order, param_shape

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_XFORM_MNI_152 = 4
HEADER_SIZE = 348


def make_weights(spec, gen: torch.Generator, device) -> dict:
    """``{"encode0.0.w": tensor, ...}`` f32 on ``device``."""
    order = param_order(spec)
    drawn = [(k, layer, w) for k, layer, w in order
             if layer.kind in ("conv", "conv_trans") and w == "w"]
    sizes = [math.prod(param_shape(layer, w)) for _, layer, w in drawn]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (k, layer, w), part in zip(drawn, u.split(sizes)):
        fan_in = layer.in_c * layer.ks**3 if layer.kind == "conv" else layer.out_c * 8
        out[k] = (part * (1.0 / math.sqrt(fan_in))).view(param_shape(layer, w))
    for k, layer, w in order:
        if k not in out:
            fill = torch.ones if w == "w" else torch.zeros
            out[k] = fill(param_shape(layer, w), device=device)
    return {k: out[k] for k, _, _ in order}


def _ellipsoid(dhw, gen, device):
    """(d, lab): the normalized radius field of a random ellipsoid and its
    labels, with three random texture frequencies."""
    z, y, x = torch.meshgrid(*[torch.linspace(-1, 1, s, device=device) for s in dhw],
                             indexing="ij")
    r = torch.rand(9, generator=gen, device=device)
    c, rad, f = (r[:3] - 0.5) * 0.2, r[3:6] * 0.2 + 0.6, r[6:] * 4 + 2
    d = ((z - c[0]) / rad[0]) ** 2 + ((y - c[1]) / rad[1]) ** 2 + ((x - c[2]) / rad[2]) ** 2
    lab = (d < 1).to(torch.int16) + (d < 0.35).to(torch.int16)
    tex = torch.sin(f[0] * x + f[1] * y) * torch.cos(f[2] * z)
    return lab, tex


def template_pair(dhw, gen, device):
    """(image f32, label int16) numpy (D, H, W): the template, zero
    outside the head."""
    lab, tex = _ellipsoid(dhw, gen, device)
    img = (lab > 0) * (0.5 + 0.2 * lab + 0.1 * tex)
    return img.float().cpu().numpy(), lab.cpu().numpy()


def heads(dhw, n: int, gen, device) -> list[np.ndarray]:
    """``n`` int16 (D, H, W) scans."""
    out = []
    for _ in range(n):
        lab, tex = _ellipsoid(dhw, gen, device)
        img = (lab > 0) * (600.0 + 250.0 * lab + 100.0 * tex)
        noise = torch.randint(0, 40, dhw, generator=gen, device=device)
        out.append((img + noise).to(torch.int16).cpu().numpy())
    return out


def write_nifti(path: str, data: np.ndarray, voxel_size=(1.0, 1.0, 1.0), is_mni=False,
                compresslevel: int = 1) -> None:
    """A 3-D (nz, ny, nx) volume as a gzip NIfTI-1 file with the affine
    diag(voxel_size) (sform and qform code 4, MNI, for a template)."""
    data = np.ascontiguousarray(data)
    nz, ny, nx = data.shape
    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *map(float, voxel_size), 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    code = _XFORM_MNI_152 if is_mni else 1
    struct.pack_into("<h", hdr, 252, code)
    struct.pack_into("<h", hdr, 254, code)
    aff = np.zeros((3, 4), np.float32)
    aff[0, 0], aff[1, 1], aff[2, 2] = voxel_size
    struct.pack_into("<12f", hdr, 280, *aff.reshape(-1).tolist())
    hdr[344:348] = b"n+1\0"
    with gzip.open(path, "wb", compresslevel=compresslevel) as f:
        f.write(bytes(hdr))
        f.write(b"\0\0\0\0")
        f.write(data.tobytes())


def read_nifti(path: str) -> np.ndarray:
    """The (nz, ny, nx) data of a 3-D gzip NIfTI-1 file."""
    with gzip.open(path, "rb") as f:
        hdr = f.read(HEADER_SIZE)
        dim = struct.unpack_from("<8h", hdr, 40)
        dtype = np.dtype(_DTYPES[struct.unpack_from("<h", hdr, 70)[0]])
        skip = int(struct.unpack_from("<f", hdr, 108)[0]) - HEADER_SIZE
        f.read(skip)
        nx, ny, nz = dim[1:4]
        raw = f.read(nx * ny * nz * dtype.itemsize)
    return np.frombuffer(raw, dtype).reshape(nz, ny, nx)
