"""The port's warp (K10-K12) and K2's remaining modes against the JAX
package, on the CPU.

The warp wrappers of ``unet_studio_tpu_torch/ops/warp.py`` run their
plain twins for CPU tensors; each is held to the JAX sampler of the same
semantics on the shapes and fields of tests/test_resample.py: the
identity at (12, 14, 16) (336 blocks, JAX's N-pad), a smooth field at
(12, 20, 16), a moderate affine at (24, 32, 28) and the worst
default-options draw there, where the supercell window clamps taps.
``window=True`` against ``sample_warp_image_label_supercell`` and
``SupercellLinearSampler.sample``, ``window=False`` against
``sample_warp_image_label``, ``sample_linear`` and ``sample_majority``.
One case runs the JAX package's Pallas route (the window table, K11, and
the native tail, K10) in interpret mode.  Tolerance: labels exactly, the
image to rtol = atol = 1e-6 (the JAX package's own gate for its kernel,
tests/test_resample.py:166-195).

K2's ``max``, ``sum`` and ``sqdiff`` twins against ``lane_max``,
``lane_sum`` and ``lane_sqdiff`` (Pallas, interpret mode) on a
(D, rows, 128) volume, the lanes as channels.

The kernel's own arithmetic, replayed in torch (no JAX): its lane map and
``__shfl_xor`` tree against the twin's window anchors, its packed words
against the twin's packing followed by the unpacking, bit for bit,
and the label types the wrapper takes (uint8 as it is; others checked:
256 or more, or negative, raise).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_studio_tpu.ops import packed as P
from unet_studio_tpu.ops import resample as JR
from unet_studio_tpu_torch.engine import train as TE
from unet_studio_tpu_torch.ops import reduce as R
from unet_studio_tpu_torch.ops import resample as TR
from unet_studio_tpu_torch.ops import warp as W
from torch_one_thread import one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-6, atol=1e-6)
# XLA's lowest backend optimisation level without the CPU fusion emitters:
# the references compile in a fraction of the default's time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _field(name):
    """(shape, coords (D, H, W, 3) as numpy) of tests/test_resample.py."""
    if name == "identity":
        shape = (12, 14, 16)
        return shape, np.asarray(JR.meshgrid_xyz(shape))
    if name == "smooth":
        shape = (12, 20, 16)
        m = JR.affine_matrix(translation=(1.2, -0.7, 0.4), rotation=(0.1, -0.15, 0.2),
                             scaling=(1.1, 0.9, 1.05), shape_dhw=shape)
        grid = JR.meshgrid_xyz(shape)
        return shape, np.asarray(JR.apply_affine(grid + 0.7 * jnp.sin(grid * 0.4), m))
    shape = (24, 32, 28)
    if name == "affine":
        m = JR.affine_matrix(translation=(2.3, -1.7, 0.9), rotation=(0.15, -0.2, 0.1),
                             scaling=(1.2, 0.85, 1.1), shape_dhw=shape)
        return shape, np.asarray(JR.apply_affine(JR.meshgrid_xyz(shape), m))
    m = JR.affine_matrix(rotation=(0.2, 0.2, 0.2), scaling=(1.5625,) * 3, shape_dhw=shape)
    grid = JR.meshgrid_xyz(shape)
    return shape, np.asarray(JR.apply_affine(grid + 2.0 * jnp.sin(grid * 0.3), m))


def _volumes(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.random(shape).astype(np.float32) * 2.5
    lab = ((rng.random(shape) * 6).astype(np.float32)) // 1
    return img, lab


def _t(a):
    return torch.from_numpy(np.array(a))


FIELDS = ("identity", "smooth", "affine", "worst")


@functools.lru_cache(maxsize=None)
def _reference(name):
    """Every JAX sampler on one field, in one compiled call: (volumes,
    coords, results)."""
    shape, coords = _field(name)
    img, lab = _volumes(shape, len(name))

    def fn(img, lab, coords):
        return {
            "sc": JR.sample_warp_image_label_supercell(img, lab, coords),
            "cc": JR.sample_warp_image_label(img, lab, coords),
            "lin_sc": JR.SupercellLinearSampler(img).sample(coords),
            "lin": JR.sample_linear(img, coords),
            "maj": JR.sample_majority(lab, coords),
        }

    out = _jit(fn, jnp.asarray(img), jnp.asarray(lab), jnp.asarray(coords))
    return img, lab, coords, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("name", FIELDS)
def test_warp_image_label(name, window):
    img, lab, coords, ref = _reference(name)
    ji, jl = ref["sc" if window else "cc"]
    ti, tl = W.warp_image_label(_t(img), _t(lab), _t(coords), window)
    np.testing.assert_allclose(ti.numpy(), ji, **TOL)
    np.testing.assert_array_equal(tl.numpy(), jl)
    if name == "worst" and window:
        # the window clamps some taps here: the two semantics differ
        _, cl = W.warp_image_label(_t(img), _t(lab), _t(coords), False)
        assert not torch.equal(tl, cl)


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("name", FIELDS)
def test_warp_linear_and_majority(name, window):
    img, lab, coords, ref = _reference(name)
    if not window:
        np.testing.assert_array_equal(TR.sample_majority(_t(lab), _t(coords)).numpy(),
                                      ref["maj"])
    got = W.warp_linear(_t(img), _t(coords), window)
    np.testing.assert_allclose(got.numpy(), ref["lin_sc" if window else "lin"], **TOL)


def test_window_table_is_the_jax_table():
    """K11's function: the 6^3 edge-clamped window per stride-2 anchor."""
    vol = np.random.default_rng(3).random((12, 20, 16)).astype(np.float32) * 7.0
    jt = _jit(lambda v: JR._supercell_table(v)[0], jnp.asarray(vol))
    tt, ta = TR._supercell_table(_t(vol))
    assert ta == (6, 10, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_warp_vs_pallas_route(monkeypatch):
    """The JAX package's own Pallas route in interpret mode (the window
    table kernel, K11, and the native-layout tail, K10)."""
    shape, coords = _field("smooth")
    img, lab = _volumes(shape, 11)
    monkeypatch.setenv("UNET_TPU_FORCE_PACKED", "1")
    ji, jl = _jit(JR.sample_warp_image_label_supercell, jnp.asarray(img), jnp.asarray(lab),
                  jnp.asarray(coords))
    ti, tl = W.warp_image_label(_t(img), _t(lab), _t(coords), True)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_affine_helpers():
    shape = (16, 20, 24)
    kw = dict(translation=(1.1, -0.7, 2.0), rotation=(0.1, 0.2, -0.15), scaling=(1.1, 0.9, 1.2))
    jm = JR.affine_matrix(shape_dhw=shape, **kw)
    tm = TR.affine_matrix(shape_dhw=shape, **kw)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    grid = TR.meshgrid_xyz(shape)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(JR.meshgrid_xyz(shape)))
    np.testing.assert_allclose(TR.apply_affine(grid, tm).numpy(),
                               np.asarray(JR.apply_affine(JR.meshgrid_xyz(shape), jm)),
                               rtol=1e-6, atol=1e-5)
    assert TR.supercell_warp_shape_ok((192, 224, 192))
    assert not TR.supercell_warp_shape_ok((191, 224, 192))
    assert not TR.supercell_warp_shape_ok((4, 224, 192))


@pytest.mark.parametrize("method", ["linear", "majority"])
def test_resample_to_model_grid(method):
    """The BIDS loader's resample onto the model grid."""
    rng = np.random.default_rng(5)
    vol = rng.random((14, 18, 12)).astype(np.float32)
    if method == "majority":
        vol = (vol * 4) // 1
    args = ((1.2, 0.9, 1.1), (16, 16, 16), (1.0, 1.0, 1.0))
    ref = _jit(lambda v: JR.resample_to_model_grid(v, *args, method=method), jnp.asarray(vol))
    got = TR.resample_to_model_grid(_t(vol), *args, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_k2_max_sum_sqdiff():
    x3 = np.random.default_rng(6).standard_normal((4, 8, 128)).astype(np.float32) + 0.3
    xt = _t(x3)
    np.testing.assert_allclose(R.channel_sum(xt).numpy(), np.asarray(P.lane_sum(jnp.asarray(x3))),
                               rtol=1e-5, atol=1e-5)
    mean = x3.reshape(-1, 128).mean(0)
    np.testing.assert_allclose(
        R.channel_sqdiff(xt, _t(mean)).numpy(),
        np.asarray(P.lane_sqdiff(jnp.asarray(x3), jnp.asarray(mean))), rtol=1e-5, atol=1e-5)
    for v in (x3, -np.abs(x3) - 1.0):
        want = float(jnp.max(P.lane_max(jnp.asarray(v))))
        assert float(R.volume_max(_t(v))) == want
    assert float(R.volume_max(_t(-np.abs(x3) - 1.0))) == 0.0  # zero-initialised


def test_pack_image_label():
    img, lab = _volumes((8, 10, 12), 2)
    jp, jpk = JR._pack_image_label(jnp.asarray(img), jnp.asarray(lab))
    tp, tpk = TR._pack_image_label(_t(img), _t(lab))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert float(tpk) == float(jpk)


def _smooth_coords(shape):
    """A moderate affine with a smooth wiggle, in torch (no JAX compile)."""
    grid = TR.meshgrid_xyz(shape)
    m = TR.affine_matrix(translation=(1.2, -0.7, 0.4), rotation=(0.1, -0.15, 0.2),
                         scaling=(1.1, 0.9, 1.05), shape_dhw=shape)
    return TR.apply_affine(grid + 0.7 * torch.sin(grid * 0.4), m)


@pytest.mark.parametrize("shape", [(12, 14, 16), (10, 22, 26), (9, 13, 11)])
def test_warp_lane_map_and_shuffle_anchors(shape):
    """warp_kernel's lane map covers every output voxel once; its
    __shfl_xor tree gives each lane the min and max floor over the voxels
    of its 2x2x2 block that lie inside the output, so the anchors are the
    twin's supercell anchors (even sizes), and at odd sizes the partial
    edge blocks' min and max skip the voxels outside."""
    z, y, x = W.warp_block_voxels(shape)
    inside = (z < shape[0]) & (y < shape[1]) & (x < shape[2])
    flat = ((z * shape[1] + y) * shape[2] + x)[inside]
    assert torch.equal(flat.sort().values, torch.arange(int(np.prod(shape))))
    zc, yc, xc = (t.clamp(max=n - 1) for t, n in zip((z, y, x), shape))
    cell = TR._cell(_smooth_coords(shape), shape)
    even = all(n % 2 == 0 for n in shape)
    want_anchors = TR._supercell_anchors(cell, tuple(n // 2 for n in shape)) if even else None
    pad = [(0, n % 2) for n in shape]
    for a, (f, n) in enumerate(zip(cell.floor, shape)):
        mn, mx = W.shuffle_block_minmax(f[zc, yc, xc], inside)
        # the block's min and max floor over its voxels inside the output
        lo = np.pad(f.numpy(), pad, constant_values=2**31 - 1)
        hi = np.pad(f.numpy(), pad, constant_values=-(2**31))
        blocks = [v.reshape(v.shape[0] // 2, 2, v.shape[1] // 2, 2, v.shape[2] // 2, 2)
                  for v in (lo, hi)]
        bmin = torch.from_numpy(blocks[0].min(axis=(1, 3, 5)))[zc // 2, yc // 2, xc // 2]
        bmax = torch.from_numpy(blocks[1].max(axis=(1, 3, 5)))[zc // 2, yc // 2, xc // 2]
        assert torch.equal(mn[inside], bmin[inside]) and torch.equal(mx[inside], bmax[inside])
        if even:
            got = W.window_anchor(mn, mx, n)
            assert torch.equal(got[inside], want_anchors[a][zc // 2, yc // 2, xc // 2][inside])


@pytest.mark.parametrize("peak", [2.5, 65535.0, 0.0])
def test_packed_words_are_the_packing_unpacked(peak):
    """The fields of the warp's packed word (its image part and label, as
    f32) equal ``_pack_image_label`` followed by the unpacking of
    ``_combine_packed_corners``, bit for bit (a zero as +0), on edge
    values: 0, -0, below 0, the peak, just under it, values half a step
    apart, labels 0 and 255; an all-zero image (peak 1e-12)."""
    k = np.arange(0, 65536, 4099, dtype=np.float64)
    steps = np.concatenate([(k + 0.5) / 65535 * peak, k / 65535 * peak])
    img = np.concatenate([[0.0, -0.0, -1e-3, 1e-30, peak, peak * (1 - 2**-24)], steps])
    img = torch.from_numpy(img.astype(np.float32))
    if peak == 0.0:
        img = torch.zeros_like(img)
    lab = torch.from_numpy(np.resize(np.array([0, 255, 1, 254, 7], np.uint8), img.shape))
    packed, pk = TR._pack_image_label(img, lab.float())
    want_l = torch.floor(packed * (1.0 / 65536.0))
    want_i = packed - want_l * 65536.0
    words = W.pack_words(img, lab, pk)
    got_i, got_l = (words & 0xFFFF).float(), (words >> 16).float()
    assert torch.equal(got_i.view(torch.int32), want_i.view(torch.int32))
    assert torch.equal(got_l, want_l) and float(want_l.max()) == 255.0


def test_warp_label_types_and_range():
    """uint8, int and float labels of the same values warp alike; a label
    of 256 or more (after rounding), or a negative one, raises, as float
    and as int."""
    shape = (8, 10, 12)
    img, lab = _volumes(shape, 4)
    img, lab, coords = _t(img), _t(lab), _smooth_coords(shape)
    ref_i, ref_l = W.warp_image_label(img, lab, coords, True)
    for other in (lab.to(torch.uint8), lab.long()):
        got_i, got_l = W.warp_image_label(img, other, coords, True)
        assert torch.equal(got_i, ref_i) and torch.equal(got_l, ref_l)
    for bad in (lab + 256.0, (lab + 300).long(), lab.clamp(max=0) + 255.6):
        with pytest.raises(ValueError, match="labels must be below 256"):
            W.warp_image_label(img, bad, coords, True)
    with pytest.raises(ValueError, match="labels must not be negative"):
        W.warp_image_label(img, lab - 1.0, coords, True)
    # TrainEngine hands integer label batches in 0..255 over as uint8
    batch = np.stack([lab.numpy(), lab.numpy() + 249.0])
    assert TE._labels_u8(batch).dtype == np.uint8
    assert np.array_equal(TE._labels_u8(batch), batch)
    for other in (batch + 0.5, batch + 2.0, batch - 1.0):
        assert TE._labels_u8(other) is other
