"""The field-of-view resample of the evaluate path: the model-grid
transform and its separable form (the counterpart of the JAX package's
unet_studio_tpu/ops/resample.py ``model_grid_transform``,
``axis_interp_matrix``, ``diag_affine_matrices`` and
``separable_resample``).

The align_top transform is diagonal (scale + translate), so a trilinear
resample factorizes into one interpolation matrix per axis, applied as
three f32 tensor contractions.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def axis_interp_matrix(n_in: int, n_out: int, scale: float, offset: float) -> np.ndarray:
    """(n_out, n_in) one-axis linear-interpolation matrix for the sample
    positions ``p_i = i*scale + offset``: corner indices edge-clamped,
    out-of-range positions (p < 0 or p > n_in-1) give an all-zero row."""
    p = np.arange(n_out, dtype=np.float64) * float(scale) + float(offset)
    valid = (p >= 0.0) & (p <= n_in - 1)
    i0 = np.floor(p).astype(np.int64)
    f = (p - i0).astype(np.float32)
    j0 = np.clip(i0, 0, n_in - 1)
    j1 = np.clip(i0 + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, j0), (1.0 - f) * valid)
    np.add.at(m, (rows, j1), f * valid)
    return m


def separable_resample(vol: torch.Tensor, mz: np.ndarray, my: np.ndarray, mx: np.ndarray):
    """Resample (D, H, W[, C]) through per-axis interpolation matrices, in
    f32 (with the default ``torch.backends.cuda.matmul.allow_tf32 =
    False`` the contractions run in full f32 on the card)."""
    def contract(m, v, axis):
        mt = torch.as_tensor(m, dtype=torch.float32, device=v.device)
        return torch.movedim(torch.tensordot(mt, torch.movedim(v, axis, 0), dims=([1], [0])),
                             0, axis)

    # contract the axis that shrinks most first (cheapest intermediate)
    mats = sorted([(0, mz), (1, my), (2, mx)], key=lambda am: am[1].shape[0] / am[1].shape[1])
    out = vol.float()
    for axis, m in mats:
        out = contract(m, out, axis)
    return out


def diag_affine_matrices(mat34: np.ndarray, in_dhw, out_dhw):
    """Per-axis interpolation matrices (mz, my, mx) for a diagonal 3x4
    voxel transform (out voxel -> in voxel, (x,y,z) convention).  Raises
    if off-diagonal terms are present."""
    m = np.asarray(mat34, np.float64)
    off = m[:, :3] - np.diag(np.diag(m[:, :3]))
    if np.abs(off).max() > 1e-9:
        raise ValueError("transform is not axis-aligned")
    mx = axis_interp_matrix(in_dhw[2], out_dhw[2], m[0, 0], m[0, 3])
    my = axis_interp_matrix(in_dhw[1], out_dhw[1], m[1, 1], m[1, 3])
    mz = axis_interp_matrix(in_dhw[0], out_dhw[0], m[2, 2], m[2, 3])
    return mz, my, mx


def model_grid_transform(image_shape_xyz, image_vs, model_shape_xyz, model_vs,
                         fov_strategy: str = "align_top") -> np.ndarray:
    """Voxel transform (3x4) from the model grid to the image grid
    (read_image_and_label, train.cpp:26-29): scaling by the voxel-size
    ratio, x/y centred, z aligned at the top of the head."""
    if fov_strategy not in ("", "align_top"):
        warnings.warn(
            f"fov_strategy {fov_strategy!r} is not implemented; using align_top",
            stacklevel=2,
        )
    image_vs = np.asarray(image_vs, np.float64)
    model_vs = np.asarray(model_vs, np.float64)
    img = np.asarray(image_shape_xyz, np.float64)
    mdl = np.asarray(model_shape_xyz, np.float64)
    t = 0.5 * ((img - 1.0) * image_vs - (mdl - 1.0) * model_vs)
    scale = model_vs / image_vs
    mat = np.zeros((3, 4), np.float32)
    mat[0, 0], mat[1, 1], mat[2, 2] = scale
    mat[:, 3] = t / image_vs
    return mat
