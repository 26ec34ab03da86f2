"""Frozen copy of unet_studio_tpu_torch/ops/resample.py (plain PyTorch; the
K2 ``max`` wrapper replaced by its twin, the warp twins of ops/warp.py
appended).

Spatial resampling (the counterpart of the JAX package's
unet_studio_tpu/ops/resample.py), plain PyTorch:

- the field-of-view resample of the evaluate path: the model-grid
  transform and its separable form (the align_top transform is diagonal,
  so a trilinear resample factorizes into one interpolation matrix per
  axis, applied as three f32 tensor contractions);
- the augmentation's warp samplers and their two semantics, which are
  the plain twins of the warp kernel (``ops/warp.py``):
  - the corner-cell samplers ``sample_linear``, ``sample_majority`` and
    the fused image + label ``sample_warp_image_label``;
  - the supercell route, ``sample_warp_image_label_supercell`` and
    ``SupercellLinearSampler``: each 2x2x2 output block reads its 8
    corners per voxel from one 6x6x6 edge-clamped source window anchored
    at a stride-2 anchor (``_supercell_table``, K11's function), clamping
    taps that fall outside it.  The TPU needed the window table because
    its gathers are bound by transactions; the twin keeps the table
    explicit so the kernel, which reads the source directly, is held to
    it;
- affine transforms and the BIDS loader's resample onto the model grid.

Coordinates are (x, y, z) voxel positions over (D, H, W) = (z, y, x)
volumes; positions outside the volume give 0.  Every sampler keeps the
JAX package's order of f32 operations (weights ``wz * wy * wx``, sums
over the corners c = dz*4 + dy*2 + dx in order), so the two agree to f32
rounding and the labels exactly.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F



def volume_max_plain(x: torch.Tensor) -> torch.Tensor:
    """0-d f32: max(0, max(x)) (ops/reduce.py ``volume_max_plain``)."""
    return x.float().max().clamp_min(0.0)


def axis_interp_matrix(n_in: int, n_out: int, scale: float, offset: float) -> np.ndarray:
    """(n_out, n_in) one-axis linear-interpolation matrix for the sample
    positions ``p_i = i*scale + offset``: corner indices edge-clamped,
    out-of-range positions (p < 0 or p > n_in-1) give an all-zero row."""
    p = np.arange(n_out, dtype=np.float64) * float(scale) + float(offset)
    valid = (p >= 0.0) & (p <= n_in - 1)
    i0 = np.floor(p).astype(np.int64)
    f = (p - i0).astype(np.float32)
    j0 = np.clip(i0, 0, n_in - 1)
    j1 = np.clip(i0 + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, j0), (1.0 - f) * valid)
    np.add.at(m, (rows, j1), f * valid)
    return m


def separable_resample(vol: torch.Tensor, mz: np.ndarray, my: np.ndarray, mx: np.ndarray):
    """Resample (D, H, W[, C]) through per-axis interpolation matrices, in
    f32 (with the default ``torch.backends.cuda.matmul.allow_tf32 =
    False`` the contractions run in full f32 on the card)."""
    def contract(m, v, axis):
        mt = torch.as_tensor(m, dtype=torch.float32, device=v.device)
        return torch.movedim(torch.tensordot(mt, torch.movedim(v, axis, 0), dims=([1], [0])),
                             0, axis)

    # contract the axis that shrinks most first (cheapest intermediate)
    mats = sorted([(0, mz), (1, my), (2, mx)], key=lambda am: am[1].shape[0] / am[1].shape[1])
    out = vol.float()
    for axis, m in mats:
        out = contract(m, out, axis)
    return out


def diag_affine_matrices(mat34: np.ndarray, in_dhw, out_dhw):
    """Per-axis interpolation matrices (mz, my, mx) for a diagonal 3x4
    voxel transform (out voxel -> in voxel, (x,y,z) convention).  Raises
    if off-diagonal terms are present."""
    m = np.asarray(mat34, np.float64)
    off = m[:, :3] - np.diag(np.diag(m[:, :3]))
    if np.abs(off).max() > 1e-9:
        raise ValueError("transform is not axis-aligned")
    mx = axis_interp_matrix(in_dhw[2], out_dhw[2], m[0, 0], m[0, 3])
    my = axis_interp_matrix(in_dhw[1], out_dhw[1], m[1, 1], m[1, 3])
    mz = axis_interp_matrix(in_dhw[0], out_dhw[0], m[2, 2], m[2, 3])
    return mz, my, mx


def model_grid_transform(image_shape_xyz, image_vs, model_shape_xyz, model_vs,
                         fov_strategy: str = "align_top") -> np.ndarray:
    """Voxel transform (3x4) from the model grid to the image grid
    (read_image_and_label, train.cpp:26-29): scaling by the voxel-size
    ratio, x/y centred, z aligned at the top of the head."""
    if fov_strategy not in ("", "align_top"):
        warnings.warn(
            f"fov_strategy {fov_strategy!r} is not implemented; using align_top",
            stacklevel=2,
        )
    image_vs = np.asarray(image_vs, np.float64)
    model_vs = np.asarray(model_vs, np.float64)
    img = np.asarray(image_shape_xyz, np.float64)
    mdl = np.asarray(model_shape_xyz, np.float64)
    t = 0.5 * ((img - 1.0) * image_vs - (mdl - 1.0) * model_vs)
    scale = model_vs / image_vs
    mat = np.zeros((3, 4), np.float32)
    mat[0, 0], mat[1, 1], mat[2, 2] = scale
    mat[:, 3] = t / image_vs
    return mat


def resample_affine(vol: torch.Tensor, mat34: torch.Tensor, out_shape_dhw, method="linear"):
    coords = apply_affine(meshgrid_xyz(out_shape_dhw, vol.device), mat34)
    if method == "linear":
        return sample_linear(vol, coords)
    return sample_majority(vol, coords)


def resample_to_model_grid(vol: torch.Tensor, image_vs, model_shape_xyz, model_vs,
                           method="linear") -> torch.Tensor:
    """Resample a (D, H, W) image volume onto the model grid
    (train.cpp:26-29), with the gather samplers."""
    img_xyz = (vol.shape[2], vol.shape[1], vol.shape[0])
    mat = model_grid_transform(img_xyz, image_vs, model_shape_xyz, model_vs)
    out_dhw = (model_shape_xyz[2], model_shape_xyz[1], model_shape_xyz[0])
    return resample_affine(vol, torch.from_numpy(mat), out_dhw, method=method)


# ---------------------------------------------------------------------------
# affine transforms (reference: tipl::affine_param / transformation_matrix)
# ---------------------------------------------------------------------------


def meshgrid_xyz(shape_dhw, device=None) -> torch.Tensor:
    """(D, H, W, 3) grid of (x, y, z) voxel coordinates, f32."""
    d, h, w = shape_dhw
    z, y, x = torch.meshgrid(*[torch.arange(n, dtype=torch.float32, device=device)
                               for n in (d, h, w)], indexing="ij")
    return torch.stack([x, y, z], dim=-1)


def affine_matrix(translation=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0),
                  scaling=(1.0, 1.0, 1.0), shape_dhw=(1, 1, 1)) -> torch.Tensor:
    """The (3, 4) f32 voxel transform TIPL builds from an ``affine_param``
    (visual_perception_augmentation.cpp:284-296): destination (x, y, z)
    -> source (x, y, z), q = S R (p - c) + c + t with c the volume centre,
    R = Rx Ry Rz and S the per-axis scaling.  Computed on the CPU."""
    def f32(v):
        if torch.is_tensor(v):
            return v.detach().to("cpu", torch.float32)
        return torch.tensor(np.asarray(v, np.float32))

    tx, ty, tz = (f32(v) for v in translation)
    rx, ry, rz = (f32(v) for v in rotation)
    cx = (shape_dhw[2] - 1) * 0.5
    cy = (shape_dhw[1] - 1) * 0.5
    cz = (shape_dhw[0] - 1) * 0.5

    def mat(rows):
        return torch.stack([torch.stack([f32(v) for v in r]) for r in rows])

    def rot_x(a):
        c, s = torch.cos(a), torch.sin(a)
        return mat([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])

    def rot_y(a):
        c, s = torch.cos(a), torch.sin(a)
        return mat([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])

    def rot_z(a):
        c, s = torch.cos(a), torch.sin(a)
        return mat([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    r = rot_x(rx) @ rot_y(ry) @ rot_z(rz)
    a = torch.diag(torch.stack([f32(v) for v in scaling])) @ r
    center = f32([cx, cy, cz])
    offset = center + torch.stack([tx, ty, tz]) - a @ center
    return torch.cat([a, offset[:, None]], dim=1)


def apply_affine(coords: torch.Tensor, mat34: torch.Tensor) -> torch.Tensor:
    """coords (..., 3) through a (3, 4) affine -> (..., 3), each row summed
    in the order x, y, z, offset."""
    m = mat34.to(device=coords.device, dtype=torch.float32)
    x, y, z = coords.unbind(-1)
    return torch.stack([x * m[i, 0] + y * m[i, 1] + z * m[i, 2] + m[i, 3] for i in range(3)],
                       dim=-1)


# ---------------------------------------------------------------------------
# corner-cell samplers
# ---------------------------------------------------------------------------

_CORNERS = [(dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


class _Cell(NamedTuple):
    """Per-voxel sample geometry: the floor of each coordinate (z, y, x)
    as int64, the fractions (fz, fy, fx) and the in-volume mask."""

    floor: tuple
    frac: tuple
    valid: torch.Tensor


def _cell(coords: torch.Tensor, shape_dhw) -> _Cell:
    d, h, w = shape_dhw
    x, y, z = coords.unbind(-1)
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1) & (z >= 0) & (z <= d - 1)
    fl = [torch.floor(v) for v in (z, y, x)]
    return _Cell(tuple(f.long() for f in fl), tuple(v - f for v, f in zip((z, y, x), fl)),
                 valid)


def _weights(frac) -> list[torch.Tensor]:
    """The 8 trilinear weights ``wz * wy * wx`` in corner order."""
    fz, fy, fx = frac
    out = []
    for dz, dy, dx in _CORNERS:
        wz = fz if dz else 1 - fz
        wy = fy if dy else 1 - fy
        wx = fx if dx else 1 - fx
        out.append(wz * wy * wx)
    return out


def _corner_taps(cell: _Cell, shape_dhw):
    """Per axis, the (t=0, t=1) source indices of the corner-cell
    sampler: the floor clipped into the volume, its neighbour clipped at
    the far edge."""
    taps = []
    for f, n in zip(cell.floor, shape_dhw):
        lo = f.clamp(0, n - 1)
        taps.append((lo, (lo + 1).clamp_max(n - 1)))
    return taps


def _gather8(vol: torch.Tensor, taps, shape_dhw) -> list[torch.Tensor]:
    """The 8 corner values (corner order) of (D, H, W[, C]) ``vol`` at the
    per-axis tap indices."""
    _, h, w = shape_dhw
    flat = vol.reshape(-1, *vol.shape[3:])
    (z0, z1), (y0, y1), (x0, x1) = taps
    out = []
    for dz, dy, dx in _CORNERS:
        out.append(flat[((z1 if dz else z0) * h + (y1 if dy else y0)) * w + (x1 if dx else x0)])
    return out


def _blend(weights, vals, channels: bool) -> torch.Tensor:
    """sum_c w_c * v_c in corner order."""
    out = None
    for wgt, v in zip(weights, vals):
        term = (wgt[..., None] if channels else wgt) * v
        out = term if out is None else out + term
    return out


def sample_linear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sampling of (D, H, W[, C]) ``vol`` at ``coords`` (..., 3)
    (x, y, z); positions outside the volume give 0."""
    shape = tuple(vol.shape[:3])
    cell = _cell(coords, shape)
    vals = _gather8(vol, _corner_taps(cell, shape), shape)
    channels = vol.dim() == 4
    mask = cell.valid.to(vol.dtype)
    return _blend(_weights(cell.frac), vals, channels) * (mask[..., None] if channels else mask)


def _majority(labels, weights) -> torch.Tensor:
    """The label whose corners' weights sum highest; the earlier candidate
    wins a tie.  Each score sums the weights of the corners sharing the
    candidate's label, in corner order."""
    best_label, best_score = labels[0], None
    for c in range(8):
        score = weights[0] * (labels[0] == labels[c])
        for j in range(1, 8):
            score = score + weights[j] * (labels[j] == labels[c])
        if best_score is None:
            best_score = score
        else:
            better = score > best_score
            best_score = torch.where(better, score, best_score)
            best_label = torch.where(better, labels[c], best_label)
    return best_label


def sample_majority(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Majority-vote label sampling (``tipl::estimate<tipl::majority>``):
    the 8 corner labels vote with their trilinear weights."""
    shape = tuple(vol.shape[:3])
    cell = _cell(coords, shape)
    labels = _gather8(vol, _corner_taps(cell, shape), shape)
    best = _majority(labels, [w.float() for w in _weights(cell.frac)])
    return torch.where(cell.valid, best, torch.zeros_like(best))


def _pack_image_label(image0: torch.Tensor, label: torch.Tensor, plain: bool = False):
    """``round(label) * 2^16 + round(image / peak * 65535)`` in one f32
    (exact for integers < 2^24), and the peak: the image quantized to 16
    bits of its peak (relative error 1.5e-5), labels < 256.  The peak is
    K2 ``max`` (``volume_max``), its twin with ``plain``."""
    vmax = volume_max_plain(image0)
    peak = vmax.clamp_min(1e-12)
    img16 = torch.round(torch.clamp(image0 / peak, 0.0, 1.0) * 65535.0)
    return torch.round(label) * 65536.0 + img16, peak


def _combine_packed_corners(nbr, frac, valid, peak):
    """The fused warp's tail: unpack the 8 packed corner values, blend the
    image part trilinearly and vote the label part.  Returns (image',
    label')."""
    weights = _weights(frac)
    labels = [torch.floor(v * (1.0 / 65536.0)) for v in nbr]
    imgs = [v - lab * 65536.0 for v, lab in zip(nbr, labels)]
    out_img = _blend(weights, imgs, False) * (peak / 65535.0)
    vf = valid.float()
    return out_img * vf, _majority(labels, weights) * vf


def sample_warp_image_label(image0: torch.Tensor, label: torch.Tensor, coords: torch.Tensor,
                            plain: bool = False):
    """Fused warp of one image channel (trilinear) and an integer label
    (majority) through one set of coordinates, from one packed f32 per
    voxel (``_pack_image_label``).  Returns (image', label')."""
    packed, peak = _pack_image_label(image0, label, plain)
    shape = tuple(packed.shape)
    cell = _cell(coords, shape)
    nbr = _gather8(packed, _corner_taps(cell, shape), shape)
    return _combine_packed_corners(nbr, cell.frac, cell.valid, peak)


# ---------------------------------------------------------------------------
# supercell route: one 6x6x6 source window per 2x2x2 output block
# ---------------------------------------------------------------------------

_SC_L = 6  # source window width per axis
_SC_S = 2  # anchor stride == output block edge


def supercell_warp_shape_ok(shape_dhw) -> bool:
    return all(int(s) % 2 == 0 and int(s) >= _SC_L for s in shape_dhw)


def _supercell_table(vol: torch.Tensor):
    """(D, H, W) -> ((Az*Ay*Ax, 216) table, (Az, Ay, Ax)): row a holds the
    6x6x6 source window anchored at (2az, 2ay, 2ax), edge-clamped, minor
    order (iz, iy, ix): K11's function, an unfold of the edge-padded
    volume."""
    d, h, w = vol.shape
    p = _SC_L - _SC_S  # the window reaches index 2(A-1) + 5 = dim + 3
    vp = F.pad(vol[None, None], (0, p, 0, p, 0, p), mode="replicate")[0, 0]
    t = vp.unfold(0, _SC_L, _SC_S).unfold(1, _SC_L, _SC_S).unfold(2, _SC_L, _SC_S)
    return t.reshape(-1, _SC_L**3), (d // 2, h // 2, w // 2)


def _supercell_anchors(cell: _Cell, anchors) -> tuple:
    """Per 2x2x2 output block and axis (z, y, x), the window anchor
    ``clip((min floor + max floor - 2) // 4, 0, A - 1)``: the largest even
    base <= min(floor) whose window still covers max(floor) + 1, balanced
    when both allow slack, clipped into the anchor grid."""
    out = []
    for f, n in zip(cell.floor, anchors):
        d, h, w = f.shape
        b = f.reshape(d // 2, 2, h // 2, 2, w // 2, 2)
        mn, mx = b.amin(dim=(1, 3, 5)), b.amax(dim=(1, 3, 5))
        out.append(torch.div(mn + mx - 2, 4, rounding_mode="floor").clamp(0, n - 1))
    return tuple(out)


def _supercell_offsets(cell: _Cell, anchors):
    """The raster-layout form of the JAX package's ``_blockify_geometry``:
    per output voxel, the table row of its block and, per axis, its
    offset in the window, ``clip(floor - 2 anchor, 0, 4)``."""
    az, ay, ax = _supercell_anchors(cell, anchors)

    def up(a):  # (D/2, H/2, W/2) -> (D, H, W)
        return a.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)

    row = up((az * anchors[1] + ay) * anchors[2] + ax)
    offs = tuple((f - 2 * up(a)).clamp(0, _SC_L - 2)
                 for f, a in zip(cell.floor, (az, ay, ax)))
    return row, offs


def _window_gather(table: torch.Tensor, row, offs) -> list[torch.Tensor]:
    """The 8 corner values (corner order) per voxel from its window row."""
    oz, oy, ox = offs
    flat = table.reshape(-1)
    base = row * _SC_L**3
    return [flat[base + ((oz + dz) * _SC_L + oy + dy) * _SC_L + ox + dx]
            for dz, dy, dx in _CORNERS]


def sample_warp_image_label_supercell(image0: torch.Tensor, label: torch.Tensor,
                                      coords: torch.Tensor, plain: bool = False):
    """The fused warp with the supercell window semantics (even sizes of
    at least 6).  It equals ``sample_warp_image_label`` while every
    block's 8 positions fit one window (local warp Jacobian row-sums <= 2);
    beyond that the taps outside the window are clamped to its edge, the
    JAX package's documented deviation, which ``augment._supercell_warp_ok``
    gates on the option bounds."""
    packed, peak = _pack_image_label(image0, label, plain)
    table, anchors = _supercell_table(packed)
    cell = _cell(coords, tuple(packed.shape))
    row, offs = _supercell_offsets(cell, anchors)
    return _combine_packed_corners(_window_gather(table, row, offs), cell.frac, cell.valid, peak)


class SupercellLinearSampler:
    """Trilinear sampling of one continuous (D, H, W) volume with the
    supercell window semantics: the table is built once and serves many
    coordinate fields.  The blend runs per axis, x, then y, then z, as the
    JAX package's hat-weight contractions do."""

    def __init__(self, vol: torch.Tensor):
        if not supercell_warp_shape_ok(vol.shape):
            raise ValueError(f"shape {tuple(vol.shape)} not supercell-compatible")
        self.shape = tuple(vol.shape)
        self.table, self.anchors = _supercell_table(vol)

    def sample(self, coords: torch.Tensor) -> torch.Tensor:
        """coords (Do, Ho, Wo, 3), Do/Ho/Wo even, in the table volume's
        voxel space -> (Do, Ho, Wo)."""
        cell = _cell(coords, self.shape)
        row, offs = _supercell_offsets(cell, self.anchors)
        return _separable_blend(_window_gather(self.table, row, offs), cell.frac) * \
            cell.valid.float()


def _separable_blend(v, frac) -> torch.Tensor:
    """Trilinear blend of the 8 corner values per axis: x, then y, then z."""
    fz, fy, fx = frac

    def lerp(a, b, f):
        return a * (1.0 - f) + b * f

    r = [lerp(v[2 * i], v[2 * i + 1], fx) for i in range(4)]  # (dz, dy) pairs
    s = [lerp(r[0], r[1], fy), lerp(r[2], r[3], fy)]
    return lerp(s[0], s[1], fz)


def warp_image_label_plain(image0, label, coords, window: bool):
    """ops/warp.py's twin: ``sample_warp_image_label_supercell`` with
    ``window``, else ``sample_warp_image_label``."""
    if window:
        return sample_warp_image_label_supercell(image0, label, coords, plain=True)
    return sample_warp_image_label(image0, label, coords, plain=True)


def warp_linear_plain(vol, coords, window: bool):
    """ops/warp.py's twin: ``SupercellLinearSampler(vol).sample`` with
    ``window``, else ``sample_linear``."""
    if window:
        return SupercellLinearSampler(vol).sample(coords)
    return sample_linear(vol, coords)
