"""Visual-perception augmentation (the counterpart of the JAX package's
unet_studio_tpu/ops/augment.py; reference:
visual_perception_augmentation.cpp:163-438, .cu:282-544), on the device.

Operation order (the reference's):
  1. downsample x/y/z (down-and-back low-pass)       (.cpp:205-220)
  2. cropping (random box hole, label zeroed)        (.cpp:222-230)
  3. truncation z (zero top/bottom slabs)            (.cpp:231-250)
  4. additive uniform noise                          (.cpp:252-258)
  5. lighting: ambient / diffuse / specular          (.cpp:260-277)
  6. one displacement field: lens distortion + sinusoidal distortion foci
     + perspective + rigid affine; the image sampled trilinearly and the
     label by majority vote, through the warp kernel (``ops/warp.py``)
                                                     (.cpp:281-335)
  7. clamp >= 0 + normalize per channel              (.cpp:339-343)
  8. background synthesis (label mode): zero_background, or
     rubber-stamping + Perlin texture                (.cpp:345-426)

Probability gates: option 0 = off, 1..3 = 25/50/75 %, >= 4 = always
(.cpp:182-190).  The draws are split from the maths:
``draw_augmentation`` draws every gate, scalar and vector of one item from
an ``np.random.Generator`` in the order the JAX package's ``_KeyFeed``
hands out its keys (the values of a gated op are drawn whether or not its
gate fires, as the feed's keys are), and the noise volume on the device
from a generator seeded from that stream.  ``visual_perception_augmentation``
is deterministic given the draws; the items go through one at a time, so
the gates are plain Python branches.

The JAX package's documented deviations are kept as they are
(docs/augmentation-deviations.md): the crop centre inside the volume, the
rubber stamps at quarter resolution through the linear window sampler on
a mean-pooled source, and half-resolution Perlin noise.

Layout: image (D, H, W, C) f32; label (D, H, W) f32, or uint8, whose
range the warp then needs no check of (``ops/warp.py``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from ..utils.profiling import count, span
from .perlin import perlin_octaves
from .resample import affine_matrix, apply_affine, meshgrid_xyz, supercell_warp_shape_ok
from .warp import warp_image_label, warp_image_label_plain, warp_linear, warp_linear_plain

N_STAMPS = 5


@dataclass(frozen=True)
class AugOptions:
    """The augmentation options (defaults = options.txt; the ids of the
    reference's CLI flags)."""

    cropping: int = 0
    cropping_size_min: float = 0.1
    cropping_size_max: float = 0.2
    truncation_z: int = 1
    downsample_x: int = 2
    downsample_x_ratio: float = 0.5
    downsample_y: int = 2
    downsample_y_ratio: float = 0.5
    downsample_z: int = 2
    downsample_z_ratio: float = 0.5
    noise: int = 2
    noise_mag: float = 0.2
    ambient: int = 2
    ambient_mag: float = 2.0
    diffuse: int = 2
    diffuse_mag: float = 2.0
    specular: int = 2
    specular_freq: float = 2.0
    specular_mag: float = 0.5
    translocation_ratio: float = 0.2
    rotation_x: float = 0.2
    rotation_y: float = 0.2
    rotation_z: float = 0.2
    scaling_up: float = 1.25
    scaling_down: float = 0.8
    aspect_ratio: float = 1.25
    perspective: float = 0.1
    lens_distortion: float = 0.1
    distortion: int = 1
    distortion_count: int = 3
    distortion_radius_min: float = 0.1
    distortion_radius_max: float = 0.5
    distortion_mag_min: float = 0.05
    distortion_mag_max: float = 0.1
    zero_background: int = 1
    rubber_stamping: int = 2
    rubber_stamping_mag: float = 0.5
    perlin_texture: int = 2
    perlin_texture_mag: float = 0.5

    @classmethod
    def from_dict(cls, d: dict) -> "AugOptions":
        names = {f.name: f.type for f in fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k in names:
                kwargs[k] = int(float(v)) if names[k] in (int, "int") else float(v)
        return cls(**kwargs)

    def to_dict(self) -> dict:
        """Every option by id: ``AugOptions.from_dict(o.to_dict()) == o``."""
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class Stamp:
    """One rubber stamp: translation, rotation and scaling draws (3,) each
    and the per-channel target peaks (C,) in [0, 1)."""

    translation: np.ndarray
    rotation: np.ndarray
    scaling: np.ndarray
    target: np.ndarray


@dataclass
class AugDraws:
    """Every random draw of one item.  Vectors are f32 (3,) in (x, y, z)
    order unless noted; each holds the value of the JAX package's
    ``_uniform(key, lo, hi)`` for the same draw, before the arithmetic the
    augmentation applies to it."""

    downsample: tuple = (False, False, False)  # gates, x, y, z
    crop: bool = False
    crop_size: float = 0.0  # in [cropping_size_min, cropping_size_max)
    crop_value: float = 0.0  # in [0, 2)
    crop_frac: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    trunc: bool = False
    trunc_top: float = 0.0  # in [-1, 1)
    trunc_bot: float = 0.0
    noise: torch.Tensor | None = None  # (D, H, W, C) in [0, noise_mag), when the gate fires
    ambient: bool = False
    ambient_u: float = 0.0  # in [0, 1)
    diffuse: bool = False
    diffuse_dir: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    specular: bool = False
    specular_frac: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))
    resolution: float = 1.0  # in [1/scaling_up, 1/scaling_down)
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    aspect: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    perspective: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    lens_u: float = 0.0  # in [0, 1)
    distortion: bool = False
    foci_num: float = 1.0  # in [1, distortion_count + 1)
    # per focus: (centre fraction (3,) in [0.3, 0.7), radius draw, magnitude)
    foci: list = field(default_factory=list)
    zero_background: bool = False
    stamp: bool = False
    stamps: list = field(default_factory=list)  # N_STAMPS Stamp
    perlin: bool = False
    perlin_zoom: float = 0.005  # in [0.005, 0.05)
    perlin_mag: float = 0.0  # in [0, 1)
    perlin_seed: int = 0  # in [0, 2^31 - 1)


def _f32(v) -> torch.Tensor:
    """A host value as an f32 tensor on the CPU (0-d or 1-d)."""
    return torch.tensor(np.asarray(v, np.float32))


def _gate(opt_value: int, rng: np.random.Generator) -> bool:
    """Off for 0, on for >= 4, else on with probability 0.25 * value
    (.cpp:182-190); draws only for the random gates."""
    v = int(opt_value)
    if v <= 0:
        return False
    if v >= 4:
        return True
    return bool(rng.random(dtype=np.float32) < 0.25 * v)


def draw_augmentation(options: AugOptions, shape_dhw, rng: np.random.Generator, *,
                      channels: int = 1, is_label: bool = True, device=None) -> AugDraws:
    """Every draw of one item of the (D, H, W) grid, in the JAX package's
    feed order; the noise volume (D, H, W, ``channels``) on ``device``
    (default: the CPU) from a generator seeded from ``rng``."""
    opt = options

    def uni(lo, hi, n=None):
        u = rng.random(n, dtype=np.float32) if n else rng.random(dtype=np.float32)
        v = np.float32(lo) + u * (np.float32(hi) - np.float32(lo))
        return v.astype(np.float32) if n else float(np.float32(v))

    dr = AugDraws()
    dr.downsample = tuple(_gate(g, rng) for g in
                          (opt.downsample_x, opt.downsample_y, opt.downsample_z))
    if opt.cropping > 0:
        dr.crop = _gate(opt.cropping, rng)
        dr.crop_size = uni(opt.cropping_size_min, opt.cropping_size_max)
        dr.crop_value = uni(0.0, 2.0)
        dr.crop_frac = uni(0.0, 1.0, 3)
    if opt.truncation_z > 0:
        dr.trunc = _gate(opt.truncation_z, rng)
        dr.trunc_top, dr.trunc_bot = uni(-1.0, 1.0), uni(-1.0, 1.0)
    if opt.noise > 0:
        fire = _gate(opt.noise, rng)
        seed = int(rng.integers(2**62))
        if fire:
            gen = torch.Generator(device=device or "cpu").manual_seed(seed)
            dr.noise = torch.rand((*shape_dhw, channels), generator=gen,
                                  device=device or "cpu") * float(np.float32(opt.noise_mag))
    if opt.ambient > 0:
        dr.ambient = _gate(opt.ambient, rng)
        dr.ambient_u = uni(0.0, 1.0)
    if opt.diffuse > 0:
        dr.diffuse = _gate(opt.diffuse, rng)
        dr.diffuse_dir = uni(-0.5, 0.5, 3)
    if opt.specular > 0:
        dr.specular = _gate(opt.specular, rng)
        dr.specular_frac = uni(0.4, 0.6, 3)
    dr.resolution = uni(1.0 / opt.scaling_up, 1.0 / opt.scaling_down)
    dr.translation = uni(-1.0, 1.0, 3)
    dr.rotation = uni(-1.0, 1.0, 3)
    dr.aspect = uni(1.0 / opt.aspect_ratio, opt.aspect_ratio, 3)
    dr.perspective = uni(-0.5, 0.5, 3)
    if opt.lens_distortion > 0.0:
        dr.lens_u = uni(0.0, 1.0)
    if opt.distortion > 0:
        dr.distortion = _gate(opt.distortion, rng)
        dr.foci_num = uni(1.0, opt.distortion_count + 1.0)
        dr.foci = [(uni(0.3, 0.7, 3), uni(opt.distortion_radius_min, opt.distortion_radius_max),
                    uni(opt.distortion_mag_min, opt.distortion_mag_max))
                   for _ in range(int(opt.distortion_count))]
    if is_label:
        dr.zero_background = _gate(opt.zero_background, rng)
        dr.stamp = _gate(opt.rubber_stamping, rng)
        dr.stamps = [Stamp(uni(-0.5, 0.5, 3), uni(-2 * np.pi, 2 * np.pi, 3), uni(0.8, 1.25, 3),
                           uni(0.0, 1.0, channels)) for _ in range(N_STAMPS)]
        dr.perlin = _gate(opt.perlin_texture, rng)
        dr.perlin_zoom = uni(0.005, 0.05)
        dr.perlin_mag = uni(0.0, 1.0)
        dr.perlin_seed = int(rng.integers(0, 2**31 - 1))
    return dr


@functools.lru_cache(maxsize=64)
def _supercell_warp_ok(opt: AugOptions, shape_dhw) -> bool:
    """Whether the warp takes the supercell window semantics, as the JAX
    package decides it (augment.py:168-210): where the option bounds keep
    the worst draw's local Jacobian row-sums moderate (the window then
    covers nearly every block) and the sizes suit the window.

    Cached on (options, grid), all it reads: the scan costs tens of ms of
    host time, and the JAX package evaluates it once, when the step is
    traced.  ``shape_dhw`` is a tuple (or ``torch.Size``)."""
    count("const_miss")
    if not supercell_warp_shape_ok(shape_dhw):
        return False
    s_max = float(opt.aspect_ratio) / float(opt.scaling_down)

    def rot(ax_, ay_, az_):
        cx, sx = np.cos(ax_), np.sin(ax_)
        cy, sy = np.cos(ay_), np.sin(ay_)
        cz, sz = np.cos(az_), np.sin(az_)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return rx @ ry @ rz

    # |R| row-sums peak inside the draw range, so scan a grid over it
    def axis_grid(m):
        return np.unique(np.concatenate([np.linspace(-m, m, 9), [0.0]]))

    rs = max(
        np.max(np.sum(np.abs(rot(a, b, c)), axis=1))
        for a in axis_grid(opt.rotation_x)
        for b in axis_grid(opt.rotation_y)
        for c in axis_grid(opt.rotation_z)
    )
    return (
        s_max * float(rs) <= 2.6
        and float(opt.lens_distortion) <= 0.2
        and float(opt.distortion_mag_max) <= 0.2
        and float(opt.perspective) <= 0.2
    )


def _roundtrip_matrix(n: int, ratio: float) -> np.ndarray:
    """n x n matrix for downsample-to-int(n*ratio)-and-back along one axis
    with corner-anchored linear interpolation (tipl::scale semantics)."""
    nl = max(int(n * ratio), 1)

    def interp_matrix(n_out, n_in):
        m = np.zeros((n_out, n_in), np.float32)
        if n_out == 1:
            m[0, 0] = 1.0
            return m
        scale = (n_in - 1) / (n_out - 1)
        for i in range(n_out):
            p = i * scale
            j = min(int(np.floor(p)), n_in - 1)
            f = p - j
            m[i, j] += 1.0 - f
            if j + 1 < n_in:
                m[i, j + 1] += f
        return m

    return interp_matrix(n, nl) @ interp_matrix(nl, n)


@functools.lru_cache(maxsize=16)
def _roundtrip_matrix_on(n: int, ratio: float, device: str) -> torch.Tensor:
    """``_roundtrip_matrix(n, ratio)`` as an f32 tensor on ``device``,
    built and copied once per key: the JAX package builds it when the step
    is traced, a constant of the compiled program.  Shared by every call:
    read it, never write into it."""
    count("const_miss")
    return torch.from_numpy(_roundtrip_matrix(n, ratio)).to(device)


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """Per channel of (..., C): scale the max to 1 (max <= 0 leaves it)."""
    mx = img.flatten(0, -2).amax(0)
    return torch.where(mx > 0, img / mx, img)


def _normalize_to(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mx = img.flatten(0, -2).amax(0)
    return torch.where(mx > 0, img * (target.to(img.device) / mx), img)


def _dot3(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """sum_i v[..., i] * f[i], in the order x, y, z."""
    f = f.to(v.device)
    return v[..., 0] * f[0] + v[..., 1] * f[1] + v[..., 2] * f[2]


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of (..., 3), keepdim."""
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _upsample(v: torch.Tensor, r: int, shape_dhw) -> torch.Tensor:
    """Nearest upsampling of (d, h, w[, C]) by r, cut to the (D, H, W) grid."""
    v = v.repeat_interleave(r, 0).repeat_interleave(r, 1).repeat_interleave(r, 2)
    return v[: shape_dhw[0], : shape_dhw[1], : shape_dhw[2]]


def warp_coords(draws: AugDraws, options: AugOptions, shape_dhw, device=None) -> torch.Tensor:
    """The sample position (D, H, W, 3) (x, y, z) of each output voxel:
    lens distortion, distortion foci, perspective, then the rigid affine
    with zoom and aspect (.cpp:281-320)."""
    opt, dr = options, draws
    d, h, w = shape_dhw
    max_dim = float(max(d, h, w))
    whd = _f32([w, h, d])
    center = whd * 0.5  # tipl uses shape * 0.5 here
    translation = _f32(dr.translation) * (opt.translocation_ratio * whd)
    rotation = _f32(dr.rotation) * _f32([opt.rotation_x, opt.rotation_y, opt.rotation_z])
    scaling = _f32(dr.resolution) * _f32(dr.aspect)
    trans34 = affine_matrix(translation, rotation, scaling, shape_dhw)

    pos = meshgrid_xyz(shape_dhw, device)
    if opt.lens_distortion > 0.0:  # always applied when > 0 (.cpp:304-305)
        mag = _f32(dr.lens_u) * opt.lens_distortion
        radius = max_dim / 2.0
        dirv = pos - _f32([w // 2, h // 2, d // 2]).to(pos.device)
        len2 = (dirv * dirv).sum(-1, keepdim=True)
        pos = pos + dirv * ((-(mag / (radius * radius))).to(pos.device) * len2)
    if dr.distortion:
        num = math.floor(dr.foci_num)
        base = meshgrid_xyz(shape_dhw, device)
        disp = None
        for frac, r_u, m_u in dr.foci[:num]:  # the inactive foci add exact zeros
            c = (_f32(frac) * _f32([w - 1, h - 1, d - 1])).to(pos.device)
            radius = w * _f32(r_u)
            mag = _f32(m_u)
            dirv = base - c
            length = _norm3(dirv)
            inside = (length <= radius.item()) & (length > 1e-6)
            coef = torch.where(
                inside,
                (-radius * mag).to(pos.device) * torch.sin(length * (math.pi / radius).to(pos.device))
                / length,
                0.0,
            )
            term = dirv * coef
            disp = term if disp is None else disp + term
        if disp is not None:
            pos = pos + disp
    if opt.perspective > 0.0:
        persp = _f32(dr.perspective) * (opt.perspective / whd)
        denom = _dot3(pos - center.to(pos.device), persp) + 1.0
        pos = pos / denom[..., None]
    return apply_affine(pos, trans34)


def visual_perception_augmentation(image: torch.Tensor, label: torch.Tensor, draws: AugDraws,
                                   options: AugOptions = AugOptions(), is_label: bool = True, *,
                                   plain: bool = False):
    """Augment one item with the given draws.  image (D, H, W, C) f32 in
    [0, 1]; label (D, H, W) f32 or uint8.  Returns f32 (image', label').
    ``plain`` warps through the kernel's twins on any device."""
    opt, dr = options, draws
    warp_il = warp_image_label_plain if plain else warp_image_label
    warp_lin = warp_linear_plain if plain else warp_linear
    label_u8 = label if label.dtype == torch.uint8 else None
    label = label.float()
    dev = image.device
    d, h, w = label.shape
    shape_dhw = (d, h, w)
    max_dim = float(max(d, h, w))
    channels = image.shape[-1]

    # -- 1. downsample-and-back low-pass --------------------------------------
    with span("synth.lowpass"):
        for axis, fire, ratio in ((2, dr.downsample[0], opt.downsample_x_ratio),
                                  (1, dr.downsample[1], opt.downsample_y_ratio),
                                  (0, dr.downsample[2], opt.downsample_z_ratio)):
            if fire:
                m = _roundtrip_matrix_on(label.shape[axis], float(ratio), str(dev))
                image = torch.movedim(torch.tensordot(m, torch.movedim(image, axis, 0),
                                                      dims=([1], [0])), 0, axis)

    # -- 2. cropping (the crop centre inside the volume: a deviation) ----------
    if dr.crop:
        with span("synth.crop"):
            r = _f32(dr.crop_size) * w
            dims = _f32([w - 1, h - 1, d - 1])
            center = r + _f32(dr.crop_frac) * torch.clamp_min(dims - r - r, 0.0)
            grid = meshgrid_xyz(shape_dhw, dev)
            inside = ((grid - center.to(dev)).abs() <= r.item()).all(-1)
            hole = inside & (label != 0)
            image = torch.where(hole[..., None], dr.crop_value, image)
            label = torch.where(hole, 0.0, label)

    # -- 3. truncation z -------------------------------------------------------
    if dr.trunc:
        with span("synth.trunc"):
            n_top = torch.floor(_f32(dr.trunc_top).abs() * 0.5 * d)
            n_bot = torch.floor(_f32(dr.trunc_bot).abs() * 0.5 * d)
            zi = torch.arange(d, dtype=torch.float32, device=dev)[:, None, None]
            keep = ((zi < (d - n_top).item()) & (zi >= n_bot.item())).float()
            image = image * keep[..., None]
            label = label * keep

    # -- 4. noise: uniform [0, mag) additive ------------------------------------
    if dr.noise is not None:
        with span("synth.noise"):
            image = image + dr.noise.to(dev)

    # -- 5. lighting -------------------------------------------------------------
    with span("synth.lighting"):
        center = _f32([w, h, d]) * 0.5
        if dr.ambient:
            image = image + (_f32(dr.ambient_u) * opt.ambient_mag).item()
        if dr.diffuse:
            f = _f32(dr.diffuse_dir)
            f = f / torch.clamp_min(torch.sqrt((f * f).sum()), 1e-12)
            f = f * (opt.diffuse_mag / max_dim)
            grid = meshgrid_xyz(shape_dhw, dev)
            gain = torch.clamp_min(1.0 + _dot3(grid - center.to(dev), f), 0.0)
            image = image * gain[..., None]
        if dr.specular:
            c = _f32(dr.specular_frac) * _f32([w - 1, h - 1, d - 1])
            freq = opt.specular_freq * (np.pi * 0.5) / max_dim
            mag = opt.specular_mag
            grid = meshgrid_xyz(shape_dhw, dev)
            dist = _norm3(grid - c.to(dev))[..., 0]
            gain = (torch.cos(dist * freq) + 1.0) * mag + (1.0 - 2.0 * mag)
            image = image * gain[..., None]

    # -- 6. the displacement field and the warp ---------------------------------
    with span("synth.coords"):
        coords = warp_coords(dr, opt, shape_dhw, dev)
    with span("synth.warp"):
        use_sc = _supercell_warp_ok(opt, shape_dhw)
        if is_label:
            # a uint8 label reaches the warp as uint8: cropping and truncation
            # only zero voxels, so after them the cast back is exact
            wlab = label if label_u8 is None else (
                label.to(torch.uint8) if dr.crop or dr.trunc else label_u8)
            ch0, out_label = warp_il(image[..., 0].contiguous(), wlab, coords, use_sc)
            # extra channels: the window where the JAX package takes its
            # supercell sampler (one extra channel at most)
            rest = [warp_lin(image[..., c].contiguous(), coords, use_sc and channels <= 2)
                    for c in range(1, channels)]
            out_image = torch.stack([ch0, *rest], dim=-1)
        elif channels == 1 and use_sc:
            out_image = warp_lin(image[..., 0].contiguous(), coords, True)[..., None]
            out_label = warp_lin(label.contiguous(), coords, True)
        else:
            out_image = torch.stack([warp_lin(image[..., c].contiguous(), coords, False)
                                     for c in range(channels)], dim=-1)
            out_label = warp_lin(label.contiguous(), coords, False)

    # -- 7. clamp + normalize per channel ----------------------------------------
    with span("synth.normalize"):
        out_image = _normalize(torch.clamp_min(out_image, 0.0))

    # -- 8. background synthesis (label mode) ------------------------------------
    if is_label:
        if dr.zero_background:
            with span("synth.normalize"):
                out_image = torch.where((out_label == 0)[..., None], 0.0, out_image)
        else:
            out_image = _synthesize_background(out_image, out_label, image, label, dr, opt,
                                               warp_lin)
    return out_image, out_label


def _blend(src: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return src + b * torch.clamp_min(1.0 - src, 0.1)


def _synthesize_background(img, out_label, image, label, dr: AugDraws, opt: AugOptions,
                           warp_lin):
    """Rubber stamps of the pre-warp foreground, then Perlin texture, in
    the background; clamp and renormalize (.cpp:345-426).  ``image`` and
    ``label`` are the item before the warp."""
    dev = img.device
    d, h, w = out_label.shape
    shape_dhw = (d, h, w)
    bg_mask = (out_label == 0)[..., None]
    if dr.stamp:
        with span("synth.stamp"):
            # at quarter resolution, nearest-upsampled (a deviation: the
            # reference renders full-resolution stamps); with one channel,
            # from a mean-pooled source in low-resolution voxel units
            # through the window sampler
            masked = image * (label != 0)[..., None]
            r = 4 if all(s % 4 == 0 for s in shape_dhw) else (
                2 if all(s % 2 == 0 for s in shape_dhw) else 1)
            low = (d // r, h // r, w // r)
            grid_low = meshgrid_xyz(low, dev) * float(r)
            use_sc = r > 1 and image.shape[-1] == 1 and supercell_warp_shape_ok(low)
            if use_sc:
                mlow = masked[..., 0].reshape(d // r, r, h // r, r, w // r, r).mean(
                    dim=(1, 3, 5))
            whd = _f32([w, h, d])
            for st in dr.stamps:
                m34 = affine_matrix(_f32(st.translation) * whd, _f32(st.rotation),
                                    _f32(st.scaling), shape_dhw)
                coords = apply_affine(grid_low, m34)
                if use_sc:
                    bg = warp_lin(mlow, coords * (1.0 / r), True)[..., None]
                else:
                    bg = torch.stack([warp_lin(masked[..., c].contiguous(), coords, False)
                                      for c in range(image.shape[-1])], dim=-1)
                bg = torch.clamp_min(bg, 0.0)
                bg = _normalize_to(bg, _f32(st.target) * opt.rubber_stamping_mag)
                if r > 1:
                    bg = _upsample(bg, r, shape_dhw)
                img = torch.where(bg_mask, _blend(img, bg), img)
    if dr.perlin:
        with span("synth.perlin"):
            # half-resolution noise, nearest-upsampled (a deviation), sampled
            # at the even full-resolution positions of the same lattice
            zoom = _f32(dr.perlin_zoom)
            half = ((d + 1) // 2, (h + 1) // 2, (w + 1) // 2)
            bg = perlin_octaves(half, zoom * 2.0, dr.perlin_seed, device=dev)
            mx = bg.amax()
            target = (_f32(dr.perlin_mag) * opt.perlin_texture_mag).to(dev)
            bg = torch.where(mx > 0, bg * (target / mx), bg)
            bg = _upsample(bg, 2, shape_dhw)
            img = torch.where(bg_mask, _blend(img, bg[..., None]), img)
    with span("synth.normalize"):
        return _normalize(torch.clamp_min(img, 0.0))
