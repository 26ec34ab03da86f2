"""Frozen copy of unet_studio_tpu_torch/ops/simulate.py.

Random MR-contrast simulation (the counterpart of the JAX package's
unet_studio_tpu/ops/simulate.py; reference: simulate_modality,
train.cpp:43-180).

From a normalized T1w volume, one template trains a contrast-agnostic
model:

- template variant: a per-label random lookup (0.4-0.6) builds a tissue
  field z, smoothed twice; the intensity is remapped by a random 20-term
  polynomial in {x, 1-x, z, 1-z} with powers 0-3 and random weights, then
  a random gamma in [0.6, 1.8], and renormalized over the foreground;
  voxels <= 0.02 stay 0;
- subject variant: the same with z a smoothed copy of the image itself.

The random draws are arguments (``SimDraws``, from ``draw_simulation``),
so a test can replay the JAX package's keys; the arithmetic keeps the JAX
package's order of f32 operations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TERM_COUNT = 20


@dataclass
class SimDraws:
    """The simulation's random draws: the per-label lookup (template
    variant only), the polynomial's exponents a (of x), b (of z), c (of
    1-x), d (of 1-z) and weights w, one each per term, and the gamma."""

    lut: np.ndarray | None  # (max_label + 1,) f32 in [0.4, 0.6)
    a: np.ndarray  # (20,) ints
    b: np.ndarray
    c: np.ndarray
    d: np.ndarray
    w: np.ndarray  # (20,) f32 in [0, 1)
    gamma: float  # f32 in [0.6, 1.8)


def draw_simulation(rng: np.random.Generator, max_label: int | None) -> SimDraws:
    """The draws of one simulation; ``max_label`` None for the subject
    variant.  (a, b) is uniform over the 15 pairs with a + b > 0 (the
    reference's rejection loop)."""
    lut = None
    if max_label is not None:
        lut = (np.float32(0.4) + np.float32(0.2) * rng.random(max_label + 1, np.float32)
               ).astype(np.float32)
    idx = rng.integers(1, 16, TERM_COUNT)
    return SimDraws(lut=lut, a=idx // 4, b=idx % 4, c=rng.integers(0, 4, TERM_COUNT),
                    d=rng.integers(0, 4, TERM_COUNT), w=rng.random(TERM_COUNT, np.float32),
                    gamma=float(np.float32(0.6) + np.float32(1.2) * rng.random(dtype=np.float32)))


def gaussian3(vol: torch.Tensor) -> torch.Tensor:
    """Separable [1, 2, 1] / 4 smoothing per axis, edge-padded: the 3^3
    binomial kernel of TIPL's ``filter::gaussian``.  vol: (D, H, W)."""
    for ax in range(3):
        n = vol.shape[ax]
        lo = torch.cat([vol.narrow(ax, 0, 1), vol.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([vol.narrow(ax, 1, n - 1), vol.narrow(ax, n - 1, 1)], dim=ax)
        vol = 0.25 * lo + 0.5 * vol + 0.25 * hi
    return vol


def _poly_remap(x: torch.Tensor, z: torch.Tensor, draws: SimDraws) -> torch.Tensor:
    """s = sum_t w_t x^a (1-x)^c z^b (1-z)^d, then s^gamma."""
    def powers(v):
        v2 = v * v
        return (torch.ones_like(v), v, v2, v2 * v)

    px, pz, qx, qz = powers(x), powers(z), powers(1.0 - x), powers(1.0 - z)
    s = None
    for t in range(TERM_COUNT):
        term = float(draws.w[t]) * (px[int(draws.a[t])] * pz[int(draws.b[t])]
                                    * qx[int(draws.c[t])] * qz[int(draws.d[t])])
        s = term if s is None else s + term
    return torch.exp(float(draws.gamma) * torch.log(torch.clamp_min(s, 1e-20)))


def _renormalize(out: torch.Tensor, fg_mask: torch.Tensor) -> torch.Tensor:
    """min/max over the foreground, rescale all voxels, clamp to [0, 1]
    (train.cpp:111-116)."""
    big = 3.4e38
    mn = torch.where(fg_mask, out, big).min()
    mx = torch.where(fg_mask, out, -big).max()
    ok = mx > mn
    scale = torch.where(ok, 1.0 / (mx - mn), 1.0)
    return torch.clamp(torch.where(ok, (out - mn) * scale, out), 0.0, 1.0)


def simulate_modality_template(t1w: torch.Tensor, label: torch.Tensor, max_label: int,
                               draws: SimDraws) -> torch.Tensor:
    """Template variant (train.cpp:43-117): t1w in [0, 1] (D, H, W), label
    integer-valued (D, H, W), max_label the model's out_count."""
    lut = torch.as_tensor(draws.lut, dtype=torch.float32).to(t1w.device)
    lab = label.long()
    z = gaussian3(gaussian3(lut[lab.clamp(0, max_label)]))
    body = t1w > 0.02
    out = torch.where(body, _poly_remap(t1w, z, draws), 0.0)
    return _renormalize(out, body & (lab != 0))


def simulate_modality_subject(t1w: torch.Tensor, draws: SimDraws) -> torch.Tensor:
    """Subject variant (train.cpp:119-180): z is the smoothed image;
    renormalized over all remapped voxels."""
    z = gaussian3(gaussian3(t1w))
    body = t1w > 0.02
    out = torch.where(body, _poly_remap(t1w, z, draws), 0.0)
    return _renormalize(out, body)
