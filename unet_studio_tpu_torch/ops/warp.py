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
  (trilinear) + label (majority) warp of the template item.  The twin
  packs the image with the label into one f32 scaled by its peak (K2
  ``max``); the kernel's own pass packs the image and a uint8 label into
  one uint32 per voxel, ``label << 16 | image part`` (``pack_words``): the
  twin's packed value is an exact integer below 2^24, so its unpacking
  gives back the same (image part, label) pair as the word's two fields.
- ``warp_linear(vol, coords, window)``: trilinear sampling of one
  continuous channel (the rubber-stamp background, the subject mode).

Labels reach the kernel as ``torch.uint8``, whose range the type
guarantees: the training path hands them over so (``TrainEngine``
converts a batch of integer labels once when it assembles it, and the
augmentation keeps a uint8 label's type through to the warp), and the
wrapper then checks nothing and makes the host wait for nothing.  A label
of another dtype is rounded, checked on the host (one sync) and cast:
labels of 256 or more, or negative, raise.

The kernel's thread map and packing are here as plain functions
(``warp_block_voxels``, ``shuffle_block_minmax``, ``window_anchor``,
``pack_words``), the same arithmetic as ``csrc/warp.cu``'s, which
tests/test_torch_warp.py replays against the twin's anchors and packing.

Each wrapper runs its twin when its tensors lie on the CPU and launches
the kernel when they lie on a card, where it raises on what the kernel
does not take: odd sizes (or sources narrower than 6) with ``window``.
Both sides agree to f32 rounding of the image and exactly in the labels:
the kernel keeps the twin's order of operations and is built with
``-fmad=false``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .reduce import volume_max
from .resample import (
    SupercellLinearSampler,
    sample_linear,
    sample_warp_image_label,
    sample_warp_image_label_supercell,
    supercell_warp_shape_ok,
)

_MODE_PACKED, _MODE_LINEAR = 0, 1

# a block of warp_kernel: 4 warps over 2 z x 8 y x 8 x output voxels
WARP_BLOCK = (2, 8, 8)
# the lane bits that tell apart the 8 voxels of a 2x2x2 output block (x, y, z)
BLOCK_LANE_BITS = (1, 8, 16)
_INT_MAX, _INT_MIN = 2**31 - 1, -(2**31)


def warp_block_voxels(out_dims):
    """(z, y, x), each (blocks, 4, 32): the output voxel of lane l of warp
    w of block b in warp_kernel's map, blocks x fastest: (2 bz + l // 16,
    8 by + 2 w + (l // 8) % 2, 8 bx + l % 8), some past the output's edge."""
    od, oh, ow = out_dims
    nbz, nby, nbx = (-(-n // t) for n, t in zip(out_dims, WARP_BLOCK))
    b = torch.arange(nbz * nby * nbx).view(-1, 1, 1)
    warp = torch.arange(4).view(1, -1, 1)
    lane = torch.arange(32).view(1, 1, -1)
    z = 2 * (b // (nbx * nby)) + lane // 16
    y = 8 * (b // nbx % nby) + 2 * warp + lane // 8 % 2
    x = 8 * (b % nbx) + lane % 8
    return z, y, x


def shuffle_block_minmax(v: torch.Tensor, inside: torch.Tensor):
    """The min and max of int ``v`` over each lane's 2x2x2 block, lanes on
    the last axis (32), as warp_kernel's ``__shfl_xor`` tree over
    ``BLOCK_LANE_BITS`` takes them: lanes outside the output give INT_MAX
    to the min and INT_MIN to the max."""
    lane = torch.arange(32)
    mn = torch.where(inside, v, _INT_MAX)
    mx = torch.where(inside, v, _INT_MIN)
    for m in BLOCK_LANE_BITS:
        mn = torch.minimum(mn, mn[..., lane ^ m])
        mx = torch.maximum(mx, mx[..., lane ^ m])
    return mn, mx


def window_anchor(mn, mx, size: int):
    """The window's anchor on one axis of a source of ``size``: clip((mn +
    mx - 2) // 4, 0, size / 2 - 1)."""
    return torch.div(mn + mx - 2, 4, rounding_mode="floor").clamp(0, size // 2 - 1)


def pack_words(image: torch.Tensor, label: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """``warp_pack_kernel``'s word per voxel (int64 here): label << 16 | I, I =
    round(clamp(image / max(peak, 1e-12), 0, 1) * 65535), label uint8.
    Its fields as f32 are what ``_pack_image_label`` followed by the
    unpacking of ``_combine_packed_corners`` gives (finite images)."""
    pk = peak.clamp_min(1e-12)
    quant = torch.round(torch.clamp(image / pk, 0.0, 1.0) * 65535.0).to(torch.int64)
    return label.to(torch.int64) << 16 | quant


def _label_u8(label: torch.Tensor, name: str) -> torch.Tensor:
    """The label as the kernel reads it: uint8 as it is; any other dtype
    rounded, its range checked on the host (one sync) and cast."""
    if label.dtype == torch.uint8:
        return label
    lab = torch.round(label.float())
    lo, hi = torch.stack(torch.aminmax(lab)).tolist()
    if hi >= 256:
        raise ValueError(f"{name}: labels must be below 256")
    if lo < 0:
        raise ValueError(f"{name}: labels must not be negative")
    return lab.to(torch.uint8)


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


def _launch(src, lab, coords, peak, mode: int, window: bool, name: str):
    out_img = torch.empty(coords.shape[:3], dtype=torch.float32, device=src.device)
    out_lab = packed = None
    if mode == _MODE_PACKED:
        out_lab = torch.empty_like(out_img)
        packed = torch.empty(src.shape, dtype=torch.int32, device=src.device)
    with torch.cuda.device(src.device):
        rc = _cuda.lib().unet_warp(
            src.data_ptr(), _cuda.ptr(lab), _cuda.ptr(packed), *src.shape, coords.data_ptr(),
            *coords.shape[:3], _cuda.ptr(peak), out_img.data_ptr(), _cuda.ptr(out_lab), mode,
            int(window), _cuda.stream_ptr(src),
        )
    _cuda.check(rc, name)
    return out_img, out_lab


def warp_image_label(image0: torch.Tensor, label: torch.Tensor, coords: torch.Tensor,
                     window: bool):
    """Fused warp of ``image0`` (D, H, W) trilinearly and the integer
    ``label`` (D, H, W; uint8, or any dtype with values in 0..255) by
    majority vote through ``coords`` (Do, Ho, Wo, 3) (x, y, z), with the
    supercell semantics when ``window``.  Returns f32 (image', label')."""
    name = "warp_image_label"
    if label.shape != image0.shape:
        raise ValueError(f"{name}: label {tuple(label.shape)} != image {tuple(image0.shape)}")
    if coords.device.type == "cpu":
        _label_u8(label, name)  # the label's range is held as on the card
        return warp_image_label_plain(image0, label, coords, window)
    _check(image0, coords, window, name)
    lab = _label_u8(label, name).contiguous()
    if lab.device != image0.device:
        raise ValueError(f"{name}: image and label on different devices")
    # the packing pass reads 4 voxels at a time: 16-byte image, 4-byte label
    if image0.data_ptr() % 16:
        image0 = image0.clone()
    if lab.data_ptr() % 4:
        lab = lab.clone()
    out = _launch(image0, lab, coords, volume_max(image0), _MODE_PACKED, window, name)
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
    out, _ = _launch(vol, None, coords, None, _MODE_LINEAR, window, name)
    warp_linear.launches += 1
    return out


WRAPPERS = (warp_image_label, warp_linear)
for _fn in WRAPPERS:
    _fn.launches = 0
