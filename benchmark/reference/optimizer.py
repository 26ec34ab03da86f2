"""Frozen copy of unet_studio_tpu_torch/engine/optimizer.py.

SGD as the reference trains (the counterpart of
unet_studio_tpu/engine/optimizer.py; unet.cpp:246-277, train.cpp:566,763).

SGD, nesterov, momentum 0.99, two parameter groups: weight decay 3e-5 for
parameters with ndim > 1 and no bias in the name, 0 otherwise; poly
learning-rate decay ``lr * (1 - epoch/total)^0.9``; global gradient-norm
clip at 12 after the accumulated gradients are divided by the batch size.
Torch SGD semantics:

    g = g + wd * p            (decay group)
    buf = m * buf + g         (first step: buf = g)
    g = g + m * buf           (nesterov)
    p = p - lr * g

The state is one f32 momentum buffer per parameter (keyed like the
model's ``params()``) and a host step count.  Where the JAX package
returns new arrays, ``sgd_step`` updates the parameters and the buffers
in place, which saves a copy of each.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.99
    nesterov: bool = True
    weight_decay: float = 3e-5
    clip_norm: float = 12.0


def decay_mask(params: dict) -> dict:
    """True for the weight-decay group (ndim > 1, not a bias),
    unet.cpp:252-259."""
    return {k: (v.dim() > 1 and not k.endswith(".b")) for k, v in params.items()}


def init_opt_state(params: dict) -> dict:
    return {"momentum": {k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in params.items()},
            "step": 0}


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """torch ``clip_grad_norm_`` semantics (train.cpp:763): scale by
    min(max_norm / (total + 1e-6), 1)."""
    total = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    coef = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    return {k: g * coef for k, g in grads.items()}


@torch.no_grad()
def sgd_step(params: dict, grads: dict, opt_state: dict, lr: float,
             config: SGDConfig = SGDConfig()) -> dict:
    """One optimizer step on gradients already averaged over the batch.
    Updates ``params`` and the momentum buffers in place; returns the new
    state."""
    grads = clip_by_global_norm(grads, config.clip_norm)
    mask = decay_mask(params)
    first = opt_state["step"] == 0
    m = config.momentum
    momentum = opt_state["momentum"]
    for k, p in params.items():
        g = grads[k].float()
        if mask[k] and config.weight_decay:
            g = g + config.weight_decay * p.float()
        buf = g if first else m * momentum[k] + g
        step_g = g + m * buf if config.nesterov else buf
        momentum[k].copy_(buf)
        p.copy_((p.float() - lr * step_g).to(p.dtype))
    return {"momentum": momentum, "step": opt_state["step"] + 1}


def poly_lr(base_lr: float, epoch, total_epochs: int, power: float = 0.9) -> float:
    """lr * (1 - e/E)^0.9 in f32 (train.cpp:566)."""
    frac = 1.0 - torch.tensor(float(epoch), dtype=torch.float32) / float(total_epochs)
    return float(base_lr * torch.pow(torch.clamp_min(frac, 0.0), power))
