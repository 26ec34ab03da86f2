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
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_studio_tpu.ops import packed as P
from unet_studio_tpu.ops import resample as JR
from unet_studio_tpu_torch.ops import reduce as R
from unet_studio_tpu_torch.ops import resample as TR
from unet_studio_tpu_torch.ops import warp as W

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
