"""QC action: per-class wrong-voxel ratios over all training pairs
(reference: qc.cpp:55-378; the counterpart of the JAX package's
unet_studio_tpu/engine/qc.py), the reference's built-in regression
harness.

For every (image, label) pair: the level-0 forward on the device,
``argmax != target`` masked to valid voxels, per-class voxel and wrong
counts from one integer bincount (collapse-aware for shifted subject
labels), then a TSV report written atomically.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.bids import (
    PAIR_ERRORS,
    TrainingDataset,
    load_pair_on_model_grid,
    shift_subject_label,
)
from ..models.unet3d import UNet3d, forward_fused
from ..utils.device import resolve_device


@dataclass
class QcStat:
    voxels: int = 0
    wrong: int = 0

    def ratio(self) -> float:
        return self.wrong / self.voxels if self.voxels else 0.0


@dataclass
class QcCase:
    image: str
    label: str
    overall: QcStat = field(default_factory=QcStat)
    stats: list[QcStat] = field(default_factory=list)
    unavailable_before: int = 0
    error: str = ""
    load_s: float = 0.0  # host read + resample onto the model grid (worker thread)
    device_s: float = 0.0  # forward and counts, copy of the counts included


@torch.no_grad()
def qc_counts(model: UNet3d, img: torch.Tensor, lab: torch.Tensor, collapse_before: int,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The per-case device function (the JAX package's ``_qc_fn``):
    ``img``, ``lab`` (D, H, W) on the model's device -> (2, C+1) int64
    counts, row 0 the voxels per class, row 1 the wrong ones; column C
    holds the voxels whose label is not a class.  ``C`` is the class count
    after collapsing the first ``collapse_before`` classes into one (their
    logits by logsumexp), as for a shifted subject label."""
    raw_c = model.out_count
    logits = forward_fused(model.spec, model.params(), img[None, ..., None],
                           compute_dtype=compute_dtype, level0_only=True)[0][0]
    target = lab.to(torch.int64)
    valid = (target >= 0) & (target < raw_c)
    c = raw_c
    if collapse_before:
        merged = torch.logsumexp(logits[..., :collapse_before], dim=-1, keepdim=True)
        logits = torch.cat([merged, logits[..., collapse_before:]], dim=-1)
        target = (target - collapse_before + 1).clamp_min(0)
        c = raw_c - collapse_before + 1
    label_bin = torch.where(valid, target.clamp(0, c - 1), c).reshape(-1)
    wrong = ((logits.argmax(dim=-1) != target) & valid).reshape(-1)
    # one integer bincount: bins [0, C] the right voxels, [C+1, 2C+1] the
    # wrong ones (a float sum would round past 2^24 voxels)
    both = torch.bincount(label_bin + (c + 1) * wrong.to(torch.int64), minlength=2 * (c + 1))
    both = both.view(2, c + 1)
    return torch.stack([both.sum(0), both[1]])


def run_qc(model: UNet3d, images: list[str], labels: list[str], report_path: str,
           compute_dtype=torch.bfloat16, n_workers: int = 4, device=None) -> list[QcCase]:
    """Score ``model`` on every pair and write the TSV to ``report_path``;
    on ``device`` (default: the card).  ``n_workers`` host threads read
    and resample the pairs (the reference's worker pool, qc.cpp:273).

    A pair that cannot be read, or whose label grid differs from its
    image's, becomes an ``error:`` row and the run goes on
    (qc.cpp:305-315); an error of the forward ends the run."""
    dev = resolve_device(device)
    if model.out_count < 2:
        raise ValueError("QC requires a categorical model")
    model = model.to(dev)
    # a model with preprocessing: QC inputs go through the operations the
    # evaluate engine applies; geometric ones move the label too
    preproc = "+".join(filter(None, [model.preproc, model.orientation]))
    ds = TrainingDataset.scan(images, labels, model.out_count, strict=False)
    cases: list[QcCase] = []

    def _load(i):
        if i in ds.errors:
            raise ValueError(ds.errors[i])
        t = time.perf_counter()
        img, lab = load_pair_on_model_grid(images[i], labels[i], model.dim, model.voxel_size,
                                           preproc=preproc, device=dev)
        if ds.need_shift[i]:
            lab = shift_subject_label(img, lab, ds.max_template_label)
        return img, lab, time.perf_counter() - t

    # loads run ahead of the device in a sliding window of n_workers + 2
    # futures, so a large QC set never holds more full-size pairs than that
    # on the host (qc.cpp:273); the device drains them in order
    n_workers = max(1, int(n_workers))
    window = n_workers + 2
    with ThreadPoolExecutor(max_workers=n_workers, thread_name_prefix="unet-qc") as pool:
        futures = {i: pool.submit(_load, i) for i in range(min(window, len(images)))}
        for i in range(len(images)):
            fut = futures.pop(i)
            if i + window < len(images):
                futures[i + window] = pool.submit(_load, i + window)
            collapse = ds.max_template_label + 1 if ds.need_shift[i] else 0
            case = QcCase(image=images[i], label=labels[i], unavailable_before=collapse)
            cases.append(case)
            try:
                img, lab, case.load_s = fut.result()
            except PAIR_ERRORS as e:
                case.error = str(e)
                continue
            t = time.perf_counter()
            counts = qc_counts(model, torch.from_numpy(img).to(dev), torch.from_numpy(lab).to(dev),
                               collapse, compute_dtype).cpu().numpy()
            case.device_s = time.perf_counter() - t
            case.stats = [QcStat() for _ in range(model.out_count)]
            for ci in range(counts.shape[1] - 1):
                stat = QcStat(int(counts[0, ci]), int(counts[1, ci]))
                case.overall.voxels += stat.voxels
                case.overall.wrong += stat.wrong
                if not collapse:
                    case.stats[ci] = stat
                elif ci:
                    case.stats[collapse + ci - 1] = stat
    write_report(report_path, cases, model.out_count)
    return cases


def write_report(report_path: str, cases: list[QcCase], out_count: int) -> None:
    """The TSV (qc.cpp:333-376), written to ``.tmp`` and moved into place."""
    tmp = report_path + ".tmp"
    with open(tmp, "w") as out:
        out.write("image\tground_truth\twrong_ratio")
        for c in range(out_count):
            out.write(f"\twrong_ratio{c}")
        out.write("\n")
        for case in cases:
            names = f"{os.path.basename(case.image)}\t{os.path.basename(case.label)}"
            if case.error:
                out.write(f"{names}\terror: {case.error}\n")
                continue
            out.write(f"{names}\t{case.overall.ratio():.9g}")
            for ci, stat in enumerate(case.stats):
                out.write("\tN/A" if ci < case.unavailable_before else f"\t{stat.ratio():.9g}")
            out.write("\n")
    os.replace(tmp, report_path)


def host_counts(logits: np.ndarray, label: np.ndarray, n_classes: int):
    """A host recount of one template pair's QC counts from its (D, H, W,
    C) level-0 logits: (voxels per class, wrong per class), int64."""
    target = label.astype(np.int64)
    valid = (target >= 0) & (target < n_classes)
    wrong = valid & (logits.argmax(-1) != target)
    return (np.bincount(target[valid], minlength=n_classes),
            np.bincount(target[wrong], minlength=n_classes))
