"""K10-K12: the augmentation's warp, one hand-written Hopper kernel
(``csrc/warp.cu``) behind two wrappers, with their plain twins in
``ops/resample.py``.

It covers the JAX package's supercell warp in
unet_studio_tpu/ops/pallas_warp.py: ``extract_combine_native``
(``_geom_kernel``, ``_combine_blk_kernel``, ``_unblockify_kernel``; K10),
``build_table_kernel`` (``_table_planes_kernel``, ``_table_swap_kernel``;
K11) and ``extract_combine_packed`` (``_kernel``; K12).  The TPU built a
window table and extracted corners from it because its gathers are bound
by transactions; the kernel reads the source directly through L2.  The
``window`` flag keeps the supercell route's semantics (taps clamped to a
6x6x6 window per 2x2x2 output block), which the JAX package takes where
``augment._supercell_warp_ok`` holds; without it the kernel is the
corner-cell sampler.

- ``warp_image_label(image0, label, coords, window)``: the fused image
  (trilinear) + label (majority) warp of the template item; the image is
  packed with the label into one f32 scaled by its peak, K2 ``max``.
- ``warp_linear(vol, coords, window)``: trilinear sampling of one
  continuous channel (the rubber-stamp background, the subject mode).

Each runs its twin when its tensors lie on the CPU and launches the
kernel when they lie on a card, where it raises on what the kernel does
not take: labels of 256 or more, and odd sizes (or sources narrower than
6) with ``window``.  Both sides agree to f32 rounding of the image and
exactly in the labels: the kernel keeps the twin's order of operations
and is built with ``-fmad=false``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .resample import (
    SupercellLinearSampler,
    _pack_image_label,
    sample_linear,
    sample_warp_image_label,
    sample_warp_image_label_supercell,
    supercell_warp_shape_ok,
)

_MODE_PACKED, _MODE_LINEAR = 0, 1


def warp_image_label_plain(image0, label, coords, window: bool):
    """The twin: ``sample_warp_image_label_supercell`` with ``window``,
    else ``sample_warp_image_label`` (the peak by K2 ``max``'s twin)."""
    if window:
        return sample_warp_image_label_supercell(image0, label, coords, plain=True)
    return sample_warp_image_label(image0, label, coords, plain=True)


def warp_linear_plain(vol, coords, window: bool):
    """The twin: ``SupercellLinearSampler(vol).sample`` with ``window``,
    else ``sample_linear``."""
    if window:
        return SupercellLinearSampler(vol).sample(coords)
    return sample_linear(vol, coords)


def _check(src: torch.Tensor, coords: torch.Tensor, window: bool, name: str) -> None:
    for t in (src, coords):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected cuda or cpu")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if src.dim() != 3 or coords.dim() != 4 or coords.shape[-1] != 3:
        raise ValueError(f"{name}: expected a (D, H, W) source and (D, H, W, 3) coordinates")
    if src.device != coords.device:
        raise ValueError(f"{name}: source and coordinates on different devices")
    if window and not (supercell_warp_shape_ok(src.shape)
                       and all(s % 2 == 0 for s in coords.shape[:3])):
        raise ValueError(f"{name}: window needs even sizes (source at least 6): "
                         f"{tuple(src.shape)}, {tuple(coords.shape[:3])}")


def _launch(src, coords, peak, mode: int, window: bool, name: str):
    out_img = torch.empty(coords.shape[:3], dtype=torch.float32, device=src.device)
    out_lab = torch.empty_like(out_img) if mode == _MODE_PACKED else None
    with torch.cuda.device(src.device):
        rc = _cuda.lib().unet_warp(
            src.data_ptr(), *src.shape, coords.data_ptr(), *coords.shape[:3], _cuda.ptr(peak),
            out_img.data_ptr(), _cuda.ptr(out_lab), mode, int(window), _cuda.stream_ptr(src),
        )
    _cuda.check(rc, name)
    return out_img, out_lab


def warp_image_label(image0: torch.Tensor, label: torch.Tensor, coords: torch.Tensor,
                     window: bool):
    """Fused warp of ``image0`` (D, H, W) trilinearly and the integer
    ``label`` (D, H, W) by majority vote through ``coords`` (Do, Ho, Wo, 3)
    (x, y, z), with the supercell semantics when ``window``.  Returns f32
    (image', label')."""
    if coords.device.type == "cpu":
        return warp_image_label_plain(image0, label, coords, window)
    name = "warp_image_label"
    _check(image0, coords, window, name)
    if label.shape != image0.shape:
        raise ValueError(f"{name}: label {tuple(label.shape)} != image {tuple(image0.shape)}")
    if float(label.max()) >= 256:
        raise ValueError(f"{name}: labels must be below 256")
    packed, peak = _pack_image_label(image0, label.float())
    out = _launch(packed.contiguous(), coords, peak, _MODE_PACKED, window, name)
    warp_image_label.launches += 1
    return out


def warp_linear(vol: torch.Tensor, coords: torch.Tensor, window: bool) -> torch.Tensor:
    """Trilinear sampling of one continuous (D, H, W) ``vol`` at ``coords``
    (Do, Ho, Wo, 3) (x, y, z), with the supercell semantics when
    ``window``.  Returns f32 (Do, Ho, Wo)."""
    if coords.device.type == "cpu":
        return warp_linear_plain(vol, coords, window)
    name = "warp_linear"
    _check(vol, coords, window, name)
    out, _ = _launch(vol, coords, None, _MODE_LINEAR, window, name)
    warp_linear.launches += 1
    return out


WRAPPERS = (warp_image_label, warp_linear)
for _fn in WRAPPERS:
    _fn.launches = 0
