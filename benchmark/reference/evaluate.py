"""The reference of evaluate: what the program's ``EvaluateEngine`` gives
for one volume, in plain PyTorch, from the benchmark's own raw volume.

read (the voxel order made LPS, f32, divided by its maximum) -> the
align-top field of view onto the model grid by a separable linear
resample -> ``net.forward`` (level 0's head) -> the resample back onto
the native grid -> softmax -> label = argmax where the foreground
probability 1 - p0 exceeds 0.5, else 0.

``label_margin`` judges a label volume by the reference's probabilities:
per voxel, how far they are from giving that label by the same rule; the
reference's own labels read 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .net import forward, no_tf32
from .resample import diag_affine_matrices, model_grid_transform, separable_resample
from .train import canonical_lps


def fov_matrices(image_dhw, image_vs, model_dim_xyz, model_vs):
    """(forward, inverse) per-axis interpolation matrices between the
    native grid and the model grid (``make_infer_graph``'s)."""
    model_dhw = (model_dim_xyz[2], model_dim_xyz[1], model_dim_xyz[0])
    image_xyz = (image_dhw[2], image_dhw[1], image_dhw[0])
    m = model_grid_transform(image_xyz, image_vs, model_dim_xyz, model_vs).astype(np.float64)
    fwd34 = np.zeros((3, 4), np.float32)
    fwd34[:, :3] = np.diag(m[:, :3].diagonal())
    fwd34[:, 3] = m[:, 3]
    inv34 = np.zeros((3, 4), np.float32)
    for i in range(3):
        inv34[i, i] = 1.0 / m[i, i]
    inv34[:, 3] = -m[:, 3] / m[:, :3].diagonal()
    return (diag_affine_matrices(fwd34, image_dhw, model_dhw),
            diag_affine_matrices(inv34, model_dhw, image_dhw))


@torch.no_grad()
def probabilities(spec, params: dict, raw: np.ndarray, affine_diag, native_vs, model_dim_xyz,
                  model_vs, device, precision: str = "f32") -> torch.Tensor:
    """(C, D, H, W) f32 softmax probabilities on the canonical native grid."""
    data = canonical_lps(np.asarray(raw, np.float32), affine_diag)
    mx = data.max()
    chunk = torch.from_numpy(data / (mx if mx > 0 else 1.0)).to(device)[..., None]
    fwd, inv = fov_matrices(data.shape, native_vs, model_dim_xyz, model_vs)
    with no_tf32():
        model_in = separable_resample(chunk, *fwd)
        logits = forward(spec, params, model_in[None], precision=precision, heads="level0")[0][0]
        native = separable_resample(logits, *inv)
    return torch.softmax(torch.movedim(native, -1, 0), dim=0)


def labels_of(prob: torch.Tensor) -> torch.Tensor:
    fg = 1.0 - prob[0]
    return torch.where(fg > 0.5, torch.argmax(prob, dim=0), torch.zeros_like(fg, dtype=torch.long))


def label_margin(prob: torch.Tensor, label: torch.Tensor) -> float:
    """The widest distance, over voxels, by which ``prob`` (C, D, H, W)
    falls short of giving ``label`` (D, H, W): for a label L >= 1,
    max(p0 - 0.5, max_{j != L} p_j - p_L, 0); for 0, the nearer of
    p0 >= 0.5 and p0 >= every other p_j.  A label outside 0..C-1 reads 1."""
    c = prob.shape[0]
    lab = label.to(prob.device).long()
    bad = (lab < 0) | (lab >= c)
    lab = lab.clamp(0, c - 1)
    p_l = torch.gather(prob, 0, lab[None])[0]
    others = prob.scatter(0, lab[None], -1.0).amax(0)
    p0 = prob[0]
    fg_gap = (p0 - 0.5).clamp_min(0.0)
    margin_fg = torch.maximum(fg_gap, (others - p_l).clamp_min(0.0))
    best_rest = prob[1:].amax(0)
    margin_bg = torch.minimum((0.5 - p0).clamp_min(0.0), (best_rest - p0).clamp_min(0.0))
    margin = torch.where(lab == 0, margin_bg, margin_fg)
    margin = torch.where(bad, torch.ones_like(margin), margin)
    return float(margin.max())
