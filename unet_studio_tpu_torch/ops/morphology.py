"""Host-side morphology for evaluate post-processing and the atlas (the
counterpart of unet_studio_tpu/ops/morphology.py): 6-connected
components, the single-component reduction, defragmentation, smoothing
and the region-grow label fill.  Volumes are numpy (D, H, W); components
come from scipy.ndimage."""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_STRUCT6 = ndimage.generate_binary_structure(3, 1)  # 6-connectivity


def connected_components(mask: np.ndarray):
    """Label 6-connected components.  Returns (labels int32, counts)."""
    labels, n = ndimage.label(mask, structure=_STRUCT6)
    if n == 0:
        return labels.astype(np.int32), np.zeros(1, np.int64)
    counts = np.bincount(labels.reshape(-1), minlength=n + 1)
    return labels.astype(np.int32), counts


def largest_component(mask: np.ndarray) -> np.ndarray:
    """Keep only the largest 6-connected component of a boolean mask."""
    labels, counts = connected_components(mask)
    if counts.size <= 1:
        return np.zeros_like(mask, dtype=bool)
    counts = counts.copy()
    counts[0] = 0
    return labels == int(np.argmax(counts))


def defragment_by_size_ratio(mask: np.ndarray, size_ratio: float = 0.05) -> np.ndarray:
    """Remove components smaller than ``size_ratio`` x the largest one
    (the ``defragment_each`` postproc action, evaluate.cpp:348-360)."""
    labels, counts = connected_components(mask)
    if counts.size <= 1:
        return mask.astype(bool)
    counts = counts.copy()
    counts[0] = 0
    keep = counts >= counts.max() * size_ratio
    keep[0] = False
    return keep[labels]


def apply_single_component(label_vol: np.ndarray, classes) -> np.ndarray:
    """For each class id in ``classes``, keep only its largest connected
    component (the .nz ``single_component_label`` field, main.cpp:186)."""
    out = label_vol.copy()
    for c in classes:
        m = label_vol == c
        if not m.any():
            continue
        keep = largest_component(m)
        out[m & ~keep] = 0
    return out


def fill_and_smooth_labels(mask: np.ndarray, atlas: np.ndarray) -> np.ndarray:
    """Fill unlabeled voxels inside ``mask`` with the nearest atlas label,
    then majority-smooth inside the mask (TIPL
    ``morphology::fill_and_smooth_labels``, evaluate.cpp:160-175)."""
    atlas = atlas.copy()
    fill = mask.astype(bool) & (atlas == 0)
    if fill.any() and (atlas > 0).any():
        # nearest labeled voxel through the distance transform's indices
        _, idx = ndimage.distance_transform_edt(atlas == 0, return_indices=True)
        atlas[fill] = atlas[idx[0][fill], idx[1][fill], idx[2][fill]]
    smoothed = _majority_filter(atlas)
    atlas[mask.astype(bool)] = smoothed[mask.astype(bool)]
    return atlas


def _majority_filter(labels: np.ndarray) -> np.ndarray:
    """Mode over the 6-neighbourhood and the centre, by per-class votes;
    the centre weighs 1.5, so it wins a tie."""
    uniq = np.unique(labels)
    if uniq.size <= 1:
        return labels
    best_votes = np.zeros(labels.shape, np.float32)
    best_label = labels.copy()
    kernel = np.zeros((3, 3, 3), np.float32)
    kernel[1, 1, :] = kernel[1, :, 1] = kernel[:, 1, 1] = 1.0
    kernel[1, 1, 1] = 1.5
    for c in uniq:
        votes = ndimage.convolve((labels == c).astype(np.float32), kernel, mode="nearest")
        better = votes > best_votes
        best_votes = np.where(better, votes, best_votes)
        best_label = np.where(better, c, best_label)
    return best_label.astype(labels.dtype)


def gaussian_smooth(vol: np.ndarray) -> np.ndarray:
    """Separable [1,2,1]/4 binomial blur (tipl::filter::gaussian analog)."""
    out = vol.astype(np.float32)
    for axis in range(3):
        out = ndimage.convolve1d(
            out, np.array([0.25, 0.5, 0.25], np.float32), axis=axis, mode="nearest"
        )
    return out


def smooth_mask(mask: np.ndarray) -> np.ndarray:
    """One pass of binary smoothing (postproc.txt:3): a voxel joins the
    mask when more than half of its 6-neighbourhood is set, leaves it when
    fewer than half are, and is unchanged on a tie."""
    m = mask.astype(np.float32)
    kernel = np.zeros((3, 3, 3), np.float32)
    kernel[1, 1, :] = kernel[1, :, 1] = kernel[:, 1, 1] = 1.0
    kernel[1, 1, 1] = 0.0
    votes = ndimage.convolve(m, kernel, mode="nearest")
    out = mask.astype(bool).copy()
    out[votes > 3] = True
    out[votes < 3] = False
    return out


def anisotropic_diffusion(vol: np.ndarray, n_iter: int = 3) -> np.ndarray:
    """Perona-Malik edge-preserving smoothing (postproc.txt:14):
    conductance 1/(1+(|grad|/K)^2), K re-estimated per iteration from the
    mean absolute gradient."""
    out = vol.astype(np.float32).copy()
    for _ in range(n_iter):
        flux = np.zeros_like(out)
        for axis in range(3):
            fwd = np.diff(out, axis=axis, append=np.take(out, [-1], axis=axis))
            bwd = -np.diff(out, axis=axis, prepend=np.take(out, [0], axis=axis))
            k = max(float(np.mean(np.abs(fwd))), 1e-6)
            flux += fwd / (1.0 + (fwd / k) ** 2)
            flux += bwd / (1.0 + (bwd / k) ** 2)
        out += (1.0 / 7.0) * flux
    return out
