"""Template/atlas parcellation (reference: evaluate.hpp:26-41,
evaluate.cpp:60-179; the counterpart of unet_studio_tpu/engine/atlas.py).

* ``load_template``: a tissue segmentation template; CSF labels (>= 5)
  are zeroed.
* ``load_atlas``: majority-resample the atlas onto the template grid (on
  the device), mask it by the template, reclassify each region to its
  majority tissue (zeroing dissenting voxels), then region-grow fill the
  tissues with more than 75% atlas coverage (on the host); the corrected
  atlas is cached as ``<cache_dir>/<name>.corrected.nii.gz``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.bids import PAIR_ERRORS
from ..io.nifti import read_nifti, write_nifti
from ..ops.morphology import fill_and_smooth_labels
from ..ops.resample import resample_affine
from ..utils.device import resolve_device

TISSUE_NAMES = (
    "background",
    "white matter",
    "gray matter",
    "cerebellar gray matter",
    "subcortical",
)
TEMPLATE_REGION_COUNT = 5


def reclassify_labels_by_template(template: np.ndarray, atlas: np.ndarray):
    """Zero the atlas voxels whose tissue differs from their region's
    majority tissue (evaluate.cpp:60-110).  Returns (atlas, voxels erased
    per region)."""
    n_tissue = int(template.max()) + 1
    n_regions = int(atlas.max())
    if n_regions == 0:
        return atlas, []
    a = atlas.reshape(-1).astype(np.int64)
    t = template.reshape(-1).astype(np.int64)
    sel = (a > 0) & (t < n_tissue)
    votes = np.bincount(a[sel] * n_tissue + t[sel],
                        minlength=(n_regions + 1) * n_tissue).reshape(n_regions + 1, n_tissue)
    majority = votes.argmax(axis=1)
    majority[0] = 0
    erase = (a > 0) & (t != majority[a])
    out = atlas.copy()
    out.reshape(-1)[erase] = 0
    erased_counts = np.bincount(a[erase], minlength=n_regions + 1)[1:]
    return out, erased_counts.tolist()


def _h4(a) -> np.ndarray:
    a = np.asarray(a, np.float64)
    return a if a.shape == (4, 4) else np.vstack([a, [0, 0, 0, 1]])


class AtlasParcellation:
    """A template and an atlas on its grid; the resample runs on
    ``device`` (default: the card).  ``seconds`` holds the last
    ``load_atlas``'s ``resample_s`` and ``fill_s`` (reclassify and
    region grow)."""

    def __init__(self, cache_dir: str = "corrected_atlas", device=None):
        self.device = resolve_device(device)
        self.cache_dir = cache_dir
        self.template = None  # (D, H, W) uint8 tissue labels
        self.template_vs = None
        self.template_affine = None
        self.atlas = None  # (D, H, W) uint16 region labels
        self.atlas_region_count = 0
        self.error_msg = ""
        self.seconds: dict[str, float] = {}

    def load_template(self, path: str) -> bool:
        try:
            img = read_nifti(path)
        except PAIR_ERRORS as e:
            self.error_msg = str(e)
            return False
        t = img.data.astype(np.int32)
        t[t >= TEMPLATE_REGION_COUNT] = 0  # remove CSF (evaluate.hpp:38)
        self.template = t.astype(np.uint8)
        self.template_vs = img.voxel_size
        self.template_affine = img.affine
        return True

    def _resample_to_template(self, img) -> np.ndarray:
        """Majority-resample an atlas NIfTI onto the template grid through
        the two sform affines (template voxel -> world -> atlas voxel)."""
        t = time.perf_counter()
        m = np.linalg.inv(_h4(img.affine)) @ _h4(self.template_affine)
        vol = torch.from_numpy(np.ascontiguousarray(img.data, np.float32)).to(self.device)
        out = resample_affine(vol, torch.from_numpy(m[:3, :].astype(np.float32)),
                              self.template.shape, method="majority")
        out = out.cpu().numpy().astype(np.uint16)
        self.seconds["resample_s"] = time.perf_counter() - t
        return out

    def load_atlas(self, path: str) -> bool:
        base = os.path.basename(path)
        for suffix in (".nii.gz", ".nii"):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
        corrected = os.path.join(self.cache_dir, base + ".corrected.nii.gz")
        self.seconds = {}
        if os.path.exists(corrected):
            self.atlas = self._resample_to_template(read_nifti(corrected))
            self.atlas_region_count = int(self.atlas.max())
            return True
        try:
            img = read_nifti(path)
        except PAIR_ERRORS as e:
            self.error_msg = str(e)
            return False
        atlas = self._resample_to_template(img)
        t = time.perf_counter()
        self.atlas_region_count = int(atlas.max())
        atlas[self.template == 0] = 0

        # per-tissue atlas coverage (evaluate.cpp:141-155)
        coverage = np.zeros(TEMPLATE_REGION_COUNT)
        for tissue in range(1, TEMPLATE_REGION_COUNT):
            total = int((self.template == tissue).sum())
            if total:
                coverage[tissue] = float(((atlas > 0) & (self.template == tissue)).sum()) / total

        atlas, _ = reclassify_labels_by_template(self.template, atlas)

        # region-grow fill of the well-covered tissues (evaluate.cpp:162-175)
        for tissue in range(1, TEMPLATE_REGION_COUNT):
            if coverage[tissue] > 0.75:
                atlas = fill_and_smooth_labels(self.template == tissue, atlas)
        self.seconds["fill_s"] = time.perf_counter() - t

        os.makedirs(self.cache_dir, exist_ok=True)
        write_nifti(corrected, atlas.astype(np.uint16), self.template_vs, self.template_affine,
                    is_mni=True)
        self.atlas = atlas
        return True
