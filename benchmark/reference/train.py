"""The reference of template training: what the program's
``TrainEngine.run_epoch`` does for a one-template data set, in plain
PyTorch, from the benchmark's own inputs.

- The template pair onto the model grid (``load_pair_on_model_grid``:
  the voxel order made LPS, the align-top field of view, the image
  trilinearly and normalized to [0, 1], the label by majority vote).
- Each item: the template contrast simulation and the augmentation, with
  the draws of ``np.random.default_rng([seed, seed_id])`` in the
  program's order (``simulate``, ``augment``: frozen copies of the
  program's plain twins).
- The forward of ``net.forward``, the deep-supervision loss, the
  gradients summed in f32 over the batch and divided by it, the clip at
  12 and SGD-nesterov (``losses``, ``optimizer``: frozen copies), with the
  poly learning rate of each epoch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .augment import AugOptions, draw_augmentation, visual_perception_augmentation
from .losses import deep_supervision_loss
from .net import forward, no_tf32
from .optimizer import SGDConfig, init_opt_state, poly_lr, sgd_step
from .resample import resample_to_model_grid
from .simulate import draw_simulation, simulate_modality_template


def canonical_lps(data: np.ndarray, affine_diag) -> np.ndarray:
    """(nz, ny, nx) data of a file with a diagonal affine, with x and y
    flipped where the affine's sign is not LPS's (-, -, +)."""
    for axis_xyz, (s, want) in enumerate(zip(affine_diag, (-1.0, -1.0, 1.0))):
        if s * want < 0:
            data = np.flip(data, axis=2 - axis_xyz)
    return np.ascontiguousarray(data)


def template_on_model_grid(image, label, affine_diag, native_vs, model_dim_xyz, model_vs,
                           device):
    """(image (D, H, W) f32 in [0, 1], label (D, H, W) uint8) on the model
    grid, on ``device``."""
    img = torch.from_numpy(canonical_lps(np.asarray(image, np.float32), affine_diag)).to(device)
    lab = torch.from_numpy(canonical_lps(np.asarray(label, np.float32), affine_diag)).to(device)
    out_img = resample_to_model_grid(img, native_vs, model_dim_xyz, model_vs)
    mx = out_img.max()
    if mx > 0:
        out_img = out_img / mx
    out_lab = resample_to_model_grid(lab, native_vs, model_dim_xyz, model_vs, method="majority")
    return out_img, out_lab.to(torch.uint8)


@torch.no_grad()
def synthesize(image, label, n_classes: int, seed: int, seed_id: int,
               options: AugOptions = AugOptions()):
    """One template item: simulation, then the augmentation.  Returns
    f32 (image (D, H, W, 1), label (D, H, W))."""
    rng = np.random.default_rng([int(seed), int(seed_id)])
    x = simulate_modality_template(image.float(), label, n_classes,
                                   draw_simulation(rng, n_classes))
    draws = draw_augmentation(options, tuple(label.shape), rng, is_label=True,
                              device=image.device)
    return visual_perception_augmentation(x[..., None], label, draws, options, True, plain=True)


def train_steps(spec, params0: dict, image, label, *, seed: int, batch: int, steps: int,
                base_lr: float, total_epochs: int, precision: str = "f32",
                items: int = 0):
    """``steps`` epochs of one-template training from ``params0`` (left
    untouched).  Returns a dict: ``loss`` (per step, the sum of the items'
    losses), ``grad`` (step 1's gradients as SGD gets them, before the
    clip), ``params`` (after the last step), ``step_s`` (each step's
    seconds).  ``items``, a fault
    for the checks' readings: only the first that many items of each
    batch, the gradient their mean."""
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    opt = init_opt_state(params)
    names = list(params)
    out = {"loss": [], "step_s": []}
    with no_tf32():
        for epoch in range(steps):
            t = time.perf_counter()
            leaves = [params[k].detach().requires_grad_() for k in names]
            leaf_dict = dict(zip(names, leaves))
            acc = [torch.zeros_like(p) for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=image.device)
            used = items or batch
            for slot in range(used):
                img, lab = synthesize(image, label, spec.out_count, seed, epoch * batch + slot)
                outs = forward(spec, leaf_dict, img[None], precision=precision)
                loss, _ = deep_supervision_loss(outs, lab[None].long(), spec.out_count, 0)
                for a, g in zip(acc, torch.autograd.grad(loss, leaves, materialize_grads=True)):
                    a.add_(g)
                loss_sum += loss.detach()
                del outs, loss
            grads = {k: a / used for k, a in zip(names, acc)}
            if epoch == 0:
                out["grad"] = {k: g.clone() for k, g in grads.items()}
            lr = poly_lr(base_lr, epoch, total_epochs)
            opt = sgd_step(params, grads, opt, lr, SGDConfig())
            out["loss"].append(float(loss_sum))
            out["step_s"].append(time.perf_counter() - t)
    out["params"] = params
    return out
