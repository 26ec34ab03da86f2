"""The port's Perlin noise, contrast simulation and visual-perception
augmentation against the JAX package, on the CPU.

The JAX package draws from ``jax.random`` keys, the port from numpy
generators, so the comparisons replay JAX's draws: ``_jax_aug_draws``
walks the augmentation's ``_KeyFeed`` in its order and fills the port's
``AugDraws`` with the values JAX draws from each key (the noise volume
included), ``_jax_sim_draws`` does the same for a simulation's key.
Each augmentation op runs alone, its gate forced on (>= 4) and every
other gate off (0), at 16^3 (the stamps' quarter resolution and the
window sampler need sizes divisible by 4), then the default options as
one.  Tolerances: Perlin 1e-6, the simulations and the augmentation 1e-5
(f32 rounding of exp/log and of the few sums whose order the two
compilers choose), labels exactly.  The JAX references are jitted at
XLA's lowest backend optimisation level.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_studio_tpu.ops import augment as JA
from unet_studio_tpu.ops import perlin as JP
from unet_studio_tpu.ops import simulate as JS
from unet_studio_tpu_torch.ops import augment as TA
from unet_studio_tpu_torch.ops import perlin as TP
from unet_studio_tpu_torch.ops import simulate as TS
from torch_one_thread import one_thread  # noqa: F401  (autouse)

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}


def _jit(fn, *args):
    """``fn`` jitted at the lowest optimisation level, then called."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _phantom(n=16):
    """Ball phantom: label 1 inside radius n/3, 2 inside n/6; an intensity
    ramp."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    label = (r < n / 3).astype(np.float32)
    label[r < n / 6] = 2.0
    img = np.clip(1.0 - r / (n / 2), 0, 1).astype(np.float32) * (label > 0)
    return img, label


def _u(key, lo, hi, shape=()):
    return np.array(JA._uniform(key, lo, hi, shape))


def _jax_aug_draws(key, opt, shape, channels=1, is_label=True) -> TA.AugDraws:
    """The port's draws from the JAX augmentation's key, in its feed order
    (unet_studio_tpu/ops/augment.py:263-526)."""
    feed = JA._KeyFeed(key)
    d, h, w = shape

    def gate(v):
        v = int(v)
        return False if v == 0 else True if v >= 4 else bool(
            jax.random.uniform(feed()) < 0.25 * v)

    dr = TA.AugDraws()
    dr.downsample = tuple(gate(g) for g in (opt.downsample_x, opt.downsample_y,
                                             opt.downsample_z))
    dr.crop = gate(opt.cropping)
    if int(opt.cropping) > 0:
        ks, kv, kl = feed(), feed(), feed()
        dr.crop_size = float(_u(ks, opt.cropping_size_min, opt.cropping_size_max))
        dr.crop_value = float(_u(kv, 0.0, 2.0))
        dr.crop_frac = np.array(jax.random.uniform(kl, (3,)))
    dr.trunc = gate(opt.truncation_z)
    if int(opt.truncation_z) > 0:
        kt, kb = feed(), feed()
        dr.trunc_top, dr.trunc_bot = float(_u(kt, -1, 1)), float(_u(kb, -1, 1))
    fire = gate(opt.noise)
    if int(opt.noise) > 0:
        kn = feed()
        if fire:
            dr.noise = torch.from_numpy(_u(kn, 0.0, opt.noise_mag, (d, h, w, channels)))
    dr.ambient = gate(opt.ambient)
    if int(opt.ambient) > 0:
        dr.ambient_u = float(_u(feed(), 0.0, 1.0))
    dr.diffuse = gate(opt.diffuse)
    if int(opt.diffuse) > 0:
        dr.diffuse_dir = _u(feed(), -0.5, 0.5, (3,))
    dr.specular = gate(opt.specular)
    if int(opt.specular) > 0:
        dr.specular_frac = _u(feed(), 0.4, 0.6, (3,))
    kr, kt, ko, ka, kp = feed(), feed(), feed(), feed(), feed()
    dr.resolution = float(_u(kr, 1.0 / opt.scaling_up, 1.0 / opt.scaling_down))
    dr.translation, dr.rotation = _u(kt, -1.0, 1.0, (3,)), _u(ko, -1.0, 1.0, (3,))
    dr.aspect = _u(ka, 1.0 / opt.aspect_ratio, opt.aspect_ratio, (3,))
    dr.perspective = _u(kp, -0.5, 0.5, (3,))
    if opt.lens_distortion > 0:
        dr.lens_u = float(_u(feed(), 0.0, 1.0))
    dr.distortion = gate(opt.distortion)
    if int(opt.distortion) > 0:
        kn = feed()
        keys = [(feed(), feed(), feed()) for _ in range(int(opt.distortion_count))]
        dr.foci_num = float(_u(kn, 1.0, opt.distortion_count + 1.0))
        dr.foci = [(_u(a, 0.3, 0.7, (3,)),
                    float(_u(b, opt.distortion_radius_min, opt.distortion_radius_max)),
                    float(_u(c, opt.distortion_mag_min, opt.distortion_mag_max)))
                   for a, b, c in keys]
    if is_label:
        dr.zero_background = gate(opt.zero_background)
        dr.stamp = gate(opt.rubber_stamping)
        k_args = feed()
        dr.perlin = gate(opt.perlin_texture)
        kz, km, kse = feed(), feed(), feed()
        for it in range(TA.N_STAMPS):
            ks = jax.random.split(jax.random.fold_in(k_args, it), 4)
            dr.stamps.append(TA.Stamp(_u(ks[0], -0.5, 0.5, (3,)),
                                      _u(ks[1], -2 * np.pi, 2 * np.pi, (3,)),
                                      _u(ks[2], 0.8, 1.25, (3,)),
                                      _u(ks[3], 0.0, 1.0, (channels,))))
        dr.perlin_zoom, dr.perlin_mag = float(_u(kz, 0.005, 0.05)), float(_u(km, 0.0, 1.0))
        dr.perlin_seed = int(jax.random.randint(kse, (), 0, 2**31 - 1))
    return dr


def _jax_sim_draws(key, max_label=None) -> TS.SimDraws:
    """The port's simulation draws from a JAX simulation key
    (unet_studio_tpu/ops/simulate.py:59-123)."""
    lut = None
    if max_label is not None:
        k_lut, key = jax.random.split(key)
        lut = np.array(0.4 + 0.2 * jax.random.uniform(k_lut, (max_label + 1,)))
    k_terms, k_gamma = jax.random.split(key)
    a, b, c, d, w = (np.array(v) for v in JS._random_terms(k_terms))
    gamma = float(0.6 + 1.2 * jax.random.uniform(k_gamma, ()))
    return TS.SimDraws(lut=lut, a=a, b=b, c=c, d=d, w=w, gamma=gamma)


def test_perlin_matches_jax():
    coords = np.random.default_rng(0).uniform(-20, 20, (6, 7, 8, 3)).astype(np.float32)
    want = _jit(JP.perlin3, jnp.asarray(coords), jnp.uint32(12345))
    got = TP.perlin3(torch.from_numpy(coords), 12345)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    seed, zoom = 2**31 - 7, np.float32(0.0731)
    want = _jit(lambda z, s: JP.perlin_octaves((9, 10, 12), z, s), jnp.float32(zoom),
                jnp.uint32(seed))
    got = TP.perlin_octaves((9, 10, 12), torch.tensor(zoom), seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gaussian3_matches_jax():
    vol = np.random.default_rng(1).random((7, 9, 11)).astype(np.float32)
    want = _jit(JS.gaussian3, jnp.asarray(vol))
    np.testing.assert_allclose(TS.gaussian3(torch.from_numpy(vol)).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _simulation_references():
    img, label = _phantom(16)
    key = jax.random.key(3)

    def both(i, lab, k):
        return (JS.simulate_modality_template.__wrapped__(i, lab, 3, k),
                JS.simulate_modality_subject.__wrapped__(i, k))

    out = _jit(both, jnp.asarray(img), jnp.asarray(label), key)
    return img, label, key, [np.asarray(v) for v in out]


@pytest.mark.parametrize("variant", ["template", "subject"])
def test_simulation_matches_jax(variant):
    img, label, key, (want_template, want_subject) = _simulation_references()
    if variant == "template":
        want = want_template
        got = TS.simulate_modality_template(torch.from_numpy(img), torch.from_numpy(label), 3,
                                            _jax_sim_draws(key, 3))
    else:
        want = want_subject
        got = TS.simulate_modality_subject(torch.from_numpy(img), _jax_sim_draws(key))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert got.min() >= 0.0 and got.max() <= 1.0


OFF = dict(cropping=0, truncation_z=0, downsample_x=0, downsample_y=0, downsample_z=0, noise=0,
           ambient=0, diffuse=0, specular=0, perspective=0.0, lens_distortion=0.0,
           distortion=0, zero_background=0, rubber_stamping=0, perlin_texture=0)
OPS = {
    "downsample": dict(downsample_x=4, downsample_y=4, downsample_z=4),
    "cropping": dict(cropping=4, cropping_size_min=0.3, cropping_size_max=0.4),
    "truncation": dict(truncation_z=4),
    "noise": dict(noise=4),
    "lighting": dict(ambient=4, diffuse=4, specular=4),
    "geometry": dict(lens_distortion=0.1, distortion=4, perspective=0.1),
    "zero_background": dict(zero_background=4),
    "rubber_stamping": dict(rubber_stamping=4),
    "perlin": dict(perlin_texture=4),
    "default": None,
}


def _options(op):
    return JA.AugOptions() if OPS[op] is None else JA.AugOptions(**{**OFF, **OPS[op]})


@functools.lru_cache(maxsize=None)
def _op_references():
    """The JAX augmentation under every configuration of ``OPS``, compiled
    as one program (one compile instead of one per configuration)."""
    img, label = _phantom(16)

    def all_ops(i, lab, k):
        return {op: JA.visual_perception_augmentation.__wrapped__(i, lab, k, _options(op), True)
                for op in OPS}

    key = jax.random.key(7)
    out = _jit(all_ops, jnp.asarray(img[..., None]), jnp.asarray(label), key)
    return img, label, key, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("op", list(OPS))
def test_augmentation_op_matches_jax(op):
    img, label, key, ref = _op_references()
    opt = _options(op)
    ji, jl = ref[op]
    draws = _jax_aug_draws(key, opt, img.shape)
    ti, tl = TA.visual_perception_augmentation(
        torch.from_numpy(img[..., None]), torch.from_numpy(label), draws,
        TA.AugOptions(**opt.to_dict()))
    np.testing.assert_allclose(ti.numpy(), ji, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tl.numpy(), jl)


def test_default_options_ranges_labels_and_determinism():
    img, label = _phantom(16)
    opt = TA.AugOptions()
    outs = []
    for seed in (0, 1, 0):
        rng = np.random.default_rng(seed)
        draws = TA.draw_augmentation(opt, img.shape, rng)
        outs.append(TA.visual_perception_augmentation(
            torch.from_numpy(img[..., None]), torch.from_numpy(label), draws, opt))
    for oi, ol in outs:
        assert oi.shape == (16, 16, 16, 1) and ol.shape == (16, 16, 16)
        assert torch.isfinite(oi).all() and oi.min() >= 0.0 and oi.max() <= 1.0
        assert set(torch.unique(ol).tolist()) <= {0.0, 1.0, 2.0}
        assert (ol > 0).any()
    assert torch.equal(outs[0][0], outs[2][0]) and torch.equal(outs[0][1], outs[2][1])
    assert not torch.equal(outs[0][0], outs[1][0])


def test_draws_follow_the_gates():
    """Gates at 0 never fire and draw nothing; at >= 4 they always fire;
    a 50 % gate fires about half the time."""
    rng = np.random.default_rng(0)
    off = TA.draw_augmentation(TA.AugOptions(**OFF), (8, 8, 8), rng)
    assert not any([*off.downsample, off.crop, off.trunc, off.ambient, off.diffuse,
                    off.specular, off.distortion, off.zero_background, off.stamp, off.perlin])
    assert off.noise is None
    on = TA.draw_augmentation(TA.AugOptions(noise=4, rubber_stamping=4), (8, 8, 8), rng)
    assert on.noise.shape == (8, 8, 8, 1) and 0 <= float(on.noise.min())
    assert float(on.noise.max()) < 0.2 and on.stamp and len(on.stamps) == TA.N_STAMPS
    fired = [TA.draw_augmentation(TA.AugOptions(**{**OFF, "ambient": 2}), (8, 8, 8),
                                  rng).ambient for _ in range(400)]
    assert 0.4 < np.mean(fired) < 0.6


def test_supercell_gate_and_options_roundtrip():
    for kw in ({}, {"rotation_x": 1.5}, {"lens_distortion": 0.3}, {"scaling_down": 0.5}):
        jo, to = JA.AugOptions(**kw), TA.AugOptions(**kw)
        for shape in ((192, 224, 192), (16, 16, 16), (15, 16, 16)):
            assert TA._supercell_warp_ok(to, shape) == JA._supercell_warp_ok(jo, shape)
    opt = TA.AugOptions(cropping=3, noise_mag=0.3)
    assert TA.AugOptions.from_dict(dataclasses.asdict(opt)) == opt
    assert TA.AugOptions.from_dict({"cropping": "2.0", "noise_mag": "0.25"}).cropping == 2
    np.testing.assert_array_equal(TA._roundtrip_matrix(16, 0.5), JA._roundtrip_matrix(16, 0.5))


def test_supercell_gate_cache_matches_a_fresh_scan():
    """The memoised gate answers as the scan itself does, one entry per
    (options, grid); options equal by value share an entry, a changed
    field has its own."""
    gate = TA._supercell_warp_ok
    gate.cache_clear()
    kws = ({}, {"rotation_x": 1.5}, {"lens_distortion": 0.3}, {"scaling_down": 0.5})
    shapes = ((192, 224, 192), (16, 16, 16), (15, 16, 16))
    fresh = {(i, shape): gate.__wrapped__(TA.AugOptions(**kw), shape)
             for i, kw in enumerate(kws) for shape in shapes}
    for _ in range(2):  # filled, then read
        for i, kw in enumerate(kws):
            for shape in shapes:
                assert gate(TA.AugOptions(**kw), shape) is fresh[i, shape]
    info = gate.cache_info()
    assert (info.misses, info.hits, info.currsize) == (12, 12, 12)
    assert fresh[0, (16, 16, 16)] and not fresh[0, (15, 16, 16)]
    assert not fresh[3, (16, 16, 16)]  # scaling_down 0.5: its own answer
    same = dataclasses.replace(TA.AugOptions(), rotation_x=1.5)
    assert gate(same, torch.Size((16, 16, 16))) is fresh[1, (16, 16, 16)]
    assert gate.cache_info().misses == 12


def test_cached_constants_leave_the_augmentation_bitwise_unchanged(monkeypatch):
    """The same draws give the same image and label, bit for bit, with the
    caches cold, warm, and with the constants built anew on every call;
    the shared low-pass matrices are never written into."""
    img, label = _phantom(16)
    opt = TA.AugOptions(downsample_x=4, downsample_y=4, downsample_z=4,
                        downsample_x_ratio=0.5, downsample_y_ratio=0.25,
                        downsample_z_ratio=0.75)
    draws = TA.draw_augmentation(opt, img.shape, np.random.default_rng(7))
    assert all(draws.downsample) and TA._supercell_warp_ok.__wrapped__(opt, img.shape)

    def run():
        return TA.visual_perception_augmentation(
            torch.from_numpy(img[..., None]), torch.from_numpy(label), draws, opt)

    TA._supercell_warp_ok.cache_clear()
    TA._roundtrip_matrix_on.cache_clear()
    cold = run()
    warm = run()
    assert TA._roundtrip_matrix_on.cache_info().hits == 3
    assert TA._supercell_warp_ok.cache_info().hits == 1
    with monkeypatch.context() as m:
        m.setattr(TA, "_supercell_warp_ok", TA._supercell_warp_ok.__wrapped__)
        m.setattr(TA, "_roundtrip_matrix_on",
                  lambda n, ratio, device: torch.from_numpy(TA._roundtrip_matrix(n, ratio)))
        uncached = run()
    for out in (warm, uncached):
        assert torch.equal(out[0], cold[0]) and torch.equal(out[1], cold[1])
    for ratio in (0.5, 0.25, 0.75):
        np.testing.assert_array_equal(TA._roundtrip_matrix_on(16, ratio, "cpu").numpy(),
                                      TA._roundtrip_matrix(16, ratio))
