"""Segmentation losses (the counterpart of unet_studio_tpu/ops/losses.py;
reference: calc_losses, train.cpp:501-552).

Given logits (N, D, H, W, C) and integer targets (N, D, H, W):

* optional class collapse: the first ``collapse_before`` channels merge by
  logsumexp into one foreground class (subject labels shifted past the
  template classes, train.cpp:673-674)
* validity mask: voxels with target >= C are ignored
* masked cross-entropy
* "MSE": sum_c p_c^2 - 2 p_target + 1 per voxel, masked mean
* soft Dice over classes 1..C-1 (eps 1e-5), reported as 1 - mean dice

Everything is computed in f32 on channel-leading planes, one (N, D, H, W)
plane per class; probabilities are never stacked into a (..., C) tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ChannelLeading(NamedTuple):
    """Logits already as channel-leading planes ``(C, N, D, H, W)``: the
    training forward writes its level-0 head straight into this form."""

    planes: torch.Tensor


def calc_losses(logits, target: torch.Tensor, n_classes: int, collapse_before: int = 0,
                psum=None):
    """(ce, dice, mse) f32 scalars.  ``logits``: (N, D, H, W, C) or a
    ``ChannelLeading``; ``target``: (N, D, H, W) integer.  ``psum``, where
    the volume is split into z-slabs over ranks (``parallel/spatial.py``),
    adds the slabs' sums (the valid count, the CE and MSE sums, the dice
    intersections and cardinalities) before they are divided."""
    if collapse_before < 0 or collapse_before >= n_classes:
        raise ValueError("invalid collapse_before")
    target = target.long()
    raw_target = target
    if isinstance(logits, ChannelLeading):
        lg_t = logits.planes.float()
        batch = lg_t.shape[1]
    else:
        lg_t = logits.movedim(-1, 0).float()
        batch = logits.shape[0]
    lg = list(lg_t.unbind(0))

    if collapse_before:
        m = lg[0]
        for c in range(1, collapse_before):
            m = torch.maximum(m, lg[c])
        merged = m + torch.log(sum(torch.exp(lg[c] - m) for c in range(collapse_before)))
        lg = [merged] + lg[collapse_before:]
        target = torch.clamp_min(target - collapse_before + 1, 0)

    out_c = len(lg)
    in_range = raw_target < n_classes
    valid = in_range.float()
    target = torch.where(in_range, target, 0)

    mx = lg[0]
    for c in range(1, out_c):
        mx = torch.maximum(mx, lg[c])
    lse = mx + torch.log(sum(torch.exp(lg[c] - mx) for c in range(out_c)))
    logit_t = sum(torch.where(target == c, lg[c], 0.0) for c in range(out_c))
    ce_sum = ((lse - logit_t) * valid).sum()

    def prob_of(logit_c):
        return torch.clamp(torch.exp(logit_c - lse), 1e-6, 1.0 - 1e-6)

    sum_p2 = sum(torch.square(prob_of(lg[c])) for c in range(out_c))
    target_prob = prob_of(logit_t)
    mse_sum = ((sum_p2 - 2.0 * target_prob + 1.0) * valid).sum()

    # soft dice over classes 1..out_c-1, per sample then averaged
    inters, cards = [], []
    for c in range(1, out_c):
        p = prob_of(lg[c]) * valid
        m = (target == c).float() * valid
        inters.append(torch.sum(p * m, dim=(1, 2, 3)))
        cards.append(torch.sum(p + m, dim=(1, 2, 3)))
    n_valid = valid.sum()
    if psum is not None:
        sums = psum(torch.cat([torch.stack([n_valid, ce_sum, mse_sum]), *inters, *cards]))
        n_valid, ce_sum, mse_sum = sums[:3]
        per_class = sums[3:].split(batch)
        inters, cards = per_class[:out_c - 1], per_class[out_c - 1:]
    n = torch.clamp_min(n_valid, 1.0)
    ce = ce_sum / n
    mse = mse_sum / n
    eps = 1e-5
    dice_sum = 0.0
    for inter, card in zip(inters, cards):
        dice_sum = dice_sum + torch.sum((2.0 * inter + eps) / (card + eps))
    dice = 1.0 - dice_sum / float(batch * max(1, out_c - 1))
    return ce, dice, mse


def deep_supervision_loss(outputs: list, target: torch.Tensor, n_classes: int,
                          collapse_before: int = 0, cost_ce: bool = True,
                          cost_dice: bool = True, cost_mse: bool = True, psum=None):
    """Weighted multi-scale loss (train.cpp:637-700): level k weighs
    (1/2^k) / sum.  The target of level k > 0 is the level above's,
    nearest-downsampled by 2 (``t[:, ::2, ::2, ::2]``, the index map
    i -> 2i of torch's nearest interpolation).  Returns (total, (ce0,
    dice0, mse0)): the level-0 metrics are the reference's training
    errors (train.cpp:676-682).  ``psum`` as in ``calc_losses``: on a
    z-slab, the level-k target is the slab's own ``[::2]`` cut, which
    lines up with the global one when the slab starts on a multiple of
    2^k."""
    weight_sum = sum(1.0 / (1 << k) for k in range(len(outputs)))
    total = 0.0
    level0 = None
    cur_target = target
    for k, logits in enumerate(outputs):
        if k > 0:
            cur_target = cur_target[:, ::2, ::2, ::2]
        ce, dice, mse = calc_losses(logits, cur_target, n_classes, collapse_before, psum)
        if k == 0:
            level0 = (ce, dice, mse)
        terms = [t for t, on in ((ce, cost_ce), (dice, cost_dice), (mse, cost_mse)) if on]
        level_loss = sum(terms) if terms else ce
        total = total + level_loss * ((1.0 / (1 << k)) / weight_sum)
    return total, level0
