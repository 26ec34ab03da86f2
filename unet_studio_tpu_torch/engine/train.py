"""The one-template train step (the counterpart of
unet_studio_tpu/engine/train.py ``build_train_step``; reference:
train.cpp:604-766).

Per step: for each item in turn, the training forward through the
kernels' autograd Functions, the deep-supervision loss and the backward
(gradients accumulated in f32), then /batch_size, clip at 12 and one
SGD-nesterov step, as the JAX package's ``device_step`` does with no
subject data.  The step takes items that are already synthesized:
contrast simulation and the visual-perception augmentation join in front
of it, inside the same step, in the next slice of the port (and with
them ``TrainEngine``, the BIDS reader and the CLI's ``train`` action).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.unet3d import UNet3d, forward_fused, forward_train
from ..ops.losses import calc_losses, deep_supervision_loss
from ..utils.device import resolve_device
from .optimizer import SGDConfig, sgd_step


@dataclass
class TrainParam:
    """The fields of training_param (train.hpp:8-30) the step reads."""

    batch_size: int = 32
    epoch: int = 10000
    learning_rate: float = 1e-3
    is_label: bool = True
    cost_ce: bool = True
    cost_dice: bool = True
    cost_mse: bool = True
    compute_dtype: str = "bfloat16"  # bf16 compute, f32 master weights


class TrainStep:
    """``step(opt_state, images, labels, need_shift, lr)`` -> (opt_state,
    metrics, loss): the parameters of the model are updated in place;
    ``metrics`` is [ce_sum, dice_sum, mse_sum, count] over the items (the
    level-0 losses, the reference's training errors) and ``loss`` the sum
    of the items' deep-supervision losses, both f32 on the device.

    ``images`` (B, D, H, W, C) float, ``labels`` (B, D, H, W) class
    indices, ``need_shift`` (B,) bools: with ``any_shift``, such an item's
    loss collapses its first ``collapse_k`` classes.  ``timings``, a dict,
    receives the step's forward, backward and optimizer seconds (the
    device is synchronized between them)."""

    def __init__(self, model: UNet3d, param: TrainParam, *, any_shift: bool = False,
                 collapse_k: int = 1, device=None):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model is on {model.device}, the step on {dev}")
        self.device = model.device
        self.spec = model.spec
        self.n_classes = model.out_count
        self.params = model.params()
        self.param = param
        self.cost = (param.cost_ce, param.cost_dice, param.cost_mse)
        self.cdt = torch.bfloat16 if param.compute_dtype == "bfloat16" else torch.float32
        self.any_shift = any_shift
        self.collapse_k = collapse_k
        self.sgd = SGDConfig()

    def _sync_time(self, timings) -> float:
        if timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def grads(self, images, labels, need_shift=None, *, plain: bool = False, timings=None):
        """(grads, metrics, loss): the gradients summed over the items and
        divided by ``batch_size``, keyed like ``model.params()``.
        ``plain=True`` runs the kernels' twins under plain autograd."""
        images = torch.as_tensor(images).to(self.device)
        labels = torch.as_tensor(labels).to(self.device)
        b = images.shape[0]
        shift = np.zeros(b, bool) if need_shift is None else np.asarray(
            torch.as_tensor(need_shift).cpu(), bool)
        names = list(self.params)
        leaves = [self.params[k].detach().requires_grad_() for k in names]
        leaf_dict = dict(zip(names, leaves))
        acc = None
        metrics = torch.zeros(4, dtype=torch.float32, device=self.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        fwd_s = bwd_s = 0.0
        for i in range(b):
            collapse = self.collapse_k if self.any_shift and shift[i] else 0
            t0 = self._sync_time(timings)
            outs = forward_train(self.spec, leaf_dict, images[i:i + 1],
                                 compute_dtype=self.cdt, plain=plain)
            loss, lvl0 = deep_supervision_loss(outs, labels[i:i + 1].long(), self.n_classes,
                                               collapse, *self.cost)
            t1 = self._sync_time(timings)
            g = torch.autograd.grad(loss, leaves, materialize_grads=True)
            del outs
            t2 = self._sync_time(timings)
            fwd_s, bwd_s = fwd_s + t1 - t0, bwd_s + t2 - t1
            acc = list(g) if acc is None else [a.add_(x) for a, x in zip(acc, g)]
            metrics += torch.cat([torch.stack(lvl0).detach(), metrics.new_ones(1)])
            loss_sum += loss.detach()
        if timings is not None:
            timings.update(forward_s=fwd_s, backward_s=bwd_s)
        grads = {k: a / self.param.batch_size for k, a in zip(names, acc)}
        return grads, metrics, loss_sum

    def __call__(self, opt_state, images, labels, need_shift=None, lr=None, *, timings=None):
        grads, metrics, loss = self.grads(images, labels, need_shift, timings=timings)
        t0 = self._sync_time(timings)
        lr = self.param.learning_rate if lr is None else lr
        opt_state = sgd_step(self.params, grads, opt_state, lr, self.sgd)
        if timings is not None:
            timings["optimizer_s"] = self._sync_time(timings) - t0
        return opt_state, metrics, loss


def build_train_step(model: UNet3d, param: TrainParam, *, any_shift: bool = False,
                     collapse_k: int = 1, device=None):
    """(train_step, valid_step) for ``model`` on ``device`` (default: the
    card; the CPU only when asked for).  ``train_step`` is a
    ``TrainStep``; ``valid_step(images (N, D, H, W, C), labels (N, D, H,
    W))`` returns the f32 [ce, dice, mse] of the inference forward's
    level-0 logits (train.py:223-226 of the JAX package)."""
    step = TrainStep(model, param, any_shift=any_shift, collapse_k=collapse_k, device=device)

    @torch.no_grad()
    def valid_step(images, labels):
        images = torch.as_tensor(images).to(step.device)
        labels = torch.as_tensor(labels).to(step.device)
        outs = forward_fused(step.spec, step.params, images, compute_dtype=step.cdt,
                             level0_only=True)
        return torch.stack(calc_losses(outs[0], labels.long(), step.n_classes))

    return step, valid_step
