"""The port's host I/O against the JAX package's: the .nz model codec
(every fixture model, the sloped codec, weight layouts) and the NIfTI
reader with LPS canonicalization."""

import os

import numpy as np
import pytest
import torch

from unet_studio_tpu.io import nifti as JN
from unet_studio_tpu.models import serialize as JS
from unet_studio_tpu.models.unet3d import jax_to_torch
from unet_studio_tpu_torch.io import nifti as TN
from unet_studio_tpu_torch.models import serialize as TS
from unet_studio_tpu_torch.models.unet3d import UNet3d, param_order

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NAMES = ["golden", "golden_bmu", "golden_mc", "golden_pp"]


@pytest.mark.parametrize("name", NAMES)
def test_nz_fixture_matches_jax(name):
    path = os.path.join(FIXTURES, name, "model.nz")
    jm = JS.load_model(path)
    tm = TS.load_model(path, device="cpu")
    for attr in ("dim", "fov_strategy", "preproc", "orientation", "postproc",
                 "single_component_label", "testing_errors", "training_errors"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    np.testing.assert_array_equal(tm.voxel_size, jm.voxel_size)
    sd = tm.state_dict()
    expect = TS.from_jax_params(jm.spec, {k: np.asarray(v) for k, v in jm.params.items()})
    assert list(sd) == list(expect)
    for k, v in expect.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    # parameters() enumerates the .nz positional tensor order
    assert len(list(tm.parameters())) == len(param_order(tm.spec))


def test_from_jax_params_layouts():
    """conv (kz,ky,kx,Ci,Co) -> (Co,Ci,kz,ky,kx); conv_trans
    (Ci,kz,ky,kx,Co) -> (Ci,Co,kz,ky,kx): the JAX package's own
    jax_to_torch, and an explicit element check of each."""
    jm = JS.load_model(os.path.join(FIXTURES, "golden", "model.nz"))
    params = {k: np.asarray(v) for k, v in jm.params.items()}
    sd = TS.from_jax_params(jm.spec, params)
    kinds = set()
    for name, layer, which in param_order(jm.spec):
        mod, i, _ = name.split(".")
        got = sd[f"{mod}.{i}.{'weight' if which == 'w' else 'bias'}"].numpy()
        np.testing.assert_array_equal(got, jax_to_torch(layer, which, params[name]))
        if which == "w" and layer.kind == "conv" and layer.ks == 3 and layer.in_c >= 3:
            assert got[1, 2, 0, 1, 2] == params[name][0, 1, 2, 2, 1]
            kinds.add("conv")
        if which == "w" and layer.kind == "conv_trans":
            assert got[3, 1, 0, 1, 1] == params[name][3, 0, 1, 1, 1]
            kinds.add("conv_trans")
    assert kinds == {"conv", "conv_trans"}


def test_sloped_roundtrip_and_cross_read(tmp_path):
    """A sloped save -> load holds within the codec's 2e-4 of each
    tensor's scale, and the JAX package reads the port's file to the same
    tensors."""
    src = TS.load_model(os.path.join(FIXTURES, "golden_mc", "model.nz"), device="cpu")
    out = str(tmp_path / "m.nz")
    TS.save_model(out, src, sloped=True)
    back = TS.load_model(out, device="cpu")
    for (k, a), b in zip(src.state_dict().items(), back.state_dict().values()):
        scale = max(float(a.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= scale * 2e-4, k
    jm = JS.load_model(out)
    for k, v in TS.from_jax_params(jm.spec, {k: np.asarray(v) for k, v in jm.params.items()}).items():
        np.testing.assert_array_equal(back.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    assert back.dim == src.dim and back.in_count == 2


def test_create_is_seeded_and_copy_from():
    arch = "conv8,ks3+norm,relu\nconv8,ks3,stride2\nconv8,ks3+conv3,ks1"
    a = UNet3d.create(1, 3, arch, seed=5, device="cpu")
    b = UNet3d.create(1, 3, arch, seed=5, device="cpu")
    for x, y in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # copy_from: size-checked parameter copy plus the geometry metadata
    c = UNet3d.create(1, 3, arch, seed=6, device="cpu")
    c.dim, c.voxel_size, c.preproc = (32, 32, 16), np.array([2.0, 2.0, 2.0], np.float32), "normalize"
    a.copy_from(c)
    for x, y in zip(a.parameters(), c.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.dim == (32, 32, 16) and a.preproc == "normalize" and a.voxel_size[0] == 2.0


def _nifti_cases(tmp_path):
    paths = [os.path.join(FIXTURES, n, "input.nii.gz") for n in NAMES]
    # an oblique-free affine with a swap and flips, so canonicalization
    # has work to do
    rng = np.random.default_rng(7)
    aff = np.array([[0, 0, -1.1, 5], [1.2, 0, 0, -3], [0, -0.9, 0, 2], [0, 0, 0, 1]],
                   np.float32)
    p = str(tmp_path / "swapped.nii.gz")
    JN.write_nifti(p, rng.random((6, 7, 8), np.float32), (1.2, 0.9, 1.1), aff)
    return paths + [p]


def test_nifti_read_and_canonicalize_match_jax(tmp_path):
    for path in _nifti_cases(tmp_path):
        j, t = JN.read_nifti(path), TN.read_nifti(path)
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.affine, j.affine)
        np.testing.assert_array_equal(t.voxel_size, j.voxel_size)
        jc, tc = JN.canonicalize_lps(j), TN.canonicalize_lps(t)
        assert tc.flip_swap == jc.flip_swap
        np.testing.assert_array_equal(tc.data, jc.data)
        np.testing.assert_array_equal(tc.affine, jc.affine)
        np.testing.assert_array_equal(tc.voxel_size, jc.voxel_size)
        back = TN.apply_flip_swap(tc.data, tc.flip_swap, reverse=True)
        np.testing.assert_array_equal(back, j.data)
