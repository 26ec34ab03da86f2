"""BIDS-style dataset discovery and label bookkeeping (the counterpart of
the JAX package's unet_studio_tpu/data/bids.py; reference:
train.cpp:182-257, 259-343), and the loader that resamples one pair onto
the model grid (read_image_and_label, train.cpp:13-40).
"""

from __future__ import annotations

import glob
import os
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.nifti import canonicalize_lps, read_nifti
from ..utils.device import resolve_device

DSEG_SUFFIX = "_dseg.nii.gz"

# what reading a damaged or mismatched pair raises (truncated gzip, bad
# header, label grid unlike the image's); QC records these per pair
PAIR_ERRORS = (OSError, EOFError, ValueError, zlib.error)


def get_bids_pairs(bids: str) -> tuple[list[str], list[str]]:
    """For each comma-separated root, match every ``*_dseg.nii.gz`` label to
    all sibling images sharing its prefix (train.cpp:182-227)."""
    images, labels = [], []
    for root in bids.split(","):
        root = root.strip()
        if not os.path.isdir(root):
            raise FileNotFoundError(f"invalid BIDS directory: {root}")
        files = sorted(glob.glob(os.path.join(root, "**", "*.nii.gz"), recursive=True))
        for label in files:
            if not label.endswith(DSEG_SUFFIX):
                continue
            prefix = label[: -len(DSEG_SUFFIX)]
            for image in files:
                if image != label and image.startswith(prefix):
                    images.append(image)
                    labels.append(label)
    if not images:
        raise FileNotFoundError("no image/label pairs found")
    return images, labels


def read_label_info(path: str) -> tuple[bool, int]:
    """(is_template, max_label): a label is a template iff its NIfTI is
    flagged MNI space (train.cpp:229-246)."""
    img = read_nifti(path)
    return img.is_mni, int(np.max(img.data))


def shift_subject_label(image: np.ndarray, label: np.ndarray, max_template_label: int):
    """Offset subject labels past the template classes; untouched foreground
    becomes class 1 (train.cpp:248-257)."""
    return np.where(label != 0, label + max_template_label, (image > 0).astype(label.dtype))


@dataclass
class TrainingDataset:
    """Classified training pairs and the sampling policy of the
    reference's reader thread (train.cpp:259-443)."""

    images: list[str]
    labels: list[str]
    is_template: list[bool] = field(default_factory=list)
    need_shift: list[bool] = field(default_factory=list)
    max_template_label: int = 0
    template_indices: list[int] = field(default_factory=list)
    subject_indices: list[int] = field(default_factory=list)
    test_indices: list[int] = field(default_factory=list)
    errors: dict[int, str] = field(default_factory=dict)

    @classmethod
    def scan(cls, images: list[str], labels: list[str], out_count: int,
             strict: bool = True) -> "TrainingDataset":
        """Read every label once and classify the pairs.  An unreadable
        label raises; with ``strict=False`` it is recorded in ``ds.errors``
        (by pair index) and classified as a non-template instead, so QC
        goes on past a bad pair (qc.cpp:305-315)."""
        ds = cls(images=list(images), labels=list(labels))
        info: dict[str, tuple[bool, int]] = {}
        failed: dict[str, str] = {}
        for lbl in dict.fromkeys(labels):
            try:
                info[lbl] = read_label_info(lbl)
            except PAIR_ERRORS as e:
                if strict:
                    raise
                info[lbl] = (False, 0)
                failed[lbl] = str(e)
        ds.errors = {i: failed[lbl] for i, lbl in enumerate(labels) if lbl in failed}
        max_template_label = 0
        for i, lbl in enumerate(labels):
            is_template, max_label = info[lbl]
            ds.is_template.append(is_template)
            if is_template:
                max_template_label = max(max_template_label, max_label)
                ds.template_indices.append(i)
            else:
                ds.subject_indices.append(i)
        if not ds.template_indices or max_template_label == 0:
            max_template_label = 5  # no template label: 5 regions (train.cpp:311-314)
        ds.max_template_label = max_template_label
        for lbl in labels:
            is_template, max_label = info[lbl]
            ds.need_shift.append((not is_template) and max_label < max_template_label
                                 and max_label + max_template_label < out_count)
        # validation set: the 2 largest template files (train.cpp:345-357)
        by_size = sorted(ds.template_indices, key=lambda i: os.path.getsize(images[i]),
                         reverse=True)
        ds.test_indices = by_size[:2]
        return ds

    @property
    def has_subject_data(self) -> bool:
        return bool(self.subject_indices)

    def sample_index(self, rng: np.random.Generator, slot_in_batch: int, batch_size: int) -> int:
        """The reference's batch mix: the first ``len(template_indices)``
        slots of each batch draw templates, the rest subjects
        (train.cpp:395-398)."""
        use_template = (not self.subject_indices) or (
            slot_in_batch % batch_size < len(self.template_indices))
        pool = self.template_indices if use_template else self.subject_indices
        return pool[int(rng.integers(0, len(pool)))]


_GEOMETRIC_PREPROC = (
    "flip_x", "flip_y", "flip_z", "swap_xy", "swap_yz", "swap_xz",
    "upsampling", "downsampling",
)


def _apply_preproc_pair(data, ldata, preproc: str):
    """Apply a model's '+'-joined preproc chain to a native-grid (image,
    label) pair before the model-grid resample: the per-volume operations
    the evaluate engine applies to its inputs (evaluate.cpp:5-17).
    Geometric operations move both volumes, so the label stays aligned;
    intensity operations touch the image only.  The label is downsampled
    by taking every second voxel (a mean of labels means nothing)."""
    from ..engine.evaluate import run_preproc_op

    for op in filter(None, preproc.split("+")):
        data = run_preproc_op(data, op)
        if op in _GEOMETRIC_PREPROC:
            if op == "downsampling":
                d, h, w = (s // 2 * 2 for s in ldata.shape)
                ldata = np.ascontiguousarray(ldata[:d:2, :h:2, :w:2])
            else:
                ldata = run_preproc_op(ldata, op)
    return data, ldata


def load_pair_on_model_grid(image_path: str, label_path: str, model_dim_xyz, model_vs,
                            preproc: str = "", device=None) -> tuple[np.ndarray, np.ndarray]:
    """Load one (image, label) pair and resample it onto the model grid
    with the align-top field of view (read_image_and_label,
    train.cpp:13-40): the image trilinearly, normalized to [0, 1], the label
    by majority vote, on ``device`` (default: the card).  ``preproc``: a
    '+'-joined chain applied to the native volumes first (QC of a model
    with preprocessing); as in the evaluate engine, up/downsampling leaves
    the voxel size at its native value.  Returns (image (D, H, W), label
    (D, H, W)), f32 numpy."""
    from ..ops.resample import resample_to_model_grid

    dev = resolve_device(device)
    img = canonicalize_lps(read_nifti(image_path))
    lbl = canonicalize_lps(read_nifti(label_path))
    data = img.data.astype(np.float32)
    if data.ndim == 4:
        data = data[0]
    ldata = lbl.data.astype(np.float32)
    if ldata.ndim == 4:
        ldata = ldata[0]
    if ldata.shape != data.shape:
        raise ValueError(f"label grid {ldata.shape} != image grid {data.shape} "
                         f"({label_path} vs {image_path})")
    if preproc:
        data, ldata = _apply_preproc_pair(data, ldata, preproc)
    out_img = resample_to_model_grid(torch.from_numpy(np.ascontiguousarray(data)).to(dev),
                                     img.voxel_size, model_dim_xyz, model_vs).cpu().numpy()
    mx = out_img.max()
    if mx > 0:
        out_img /= mx
    out_lbl = resample_to_model_grid(torch.from_numpy(np.ascontiguousarray(ldata)).to(dev),
                                     img.voxel_size, model_dim_xyz, model_vs,
                                     method="majority").cpu().numpy()
    return out_img.astype(np.float32), out_lbl.astype(np.float32)
