"""The port's evaluate path on the CPU: the four golden fixtures to
tests/test_golden.py's tolerances, a synthetic case against the JAX
package's EvaluateEngine (native grid != model grid, so both FOV
resamples run), the output types and post-processing actions, and the
CLI."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_studio_tpu.engine.evaluate import EvaluateEngine as JEngine
from unet_studio_tpu.models import serialize as JS
from unet_studio_tpu_torch import cli
from unet_studio_tpu_torch.engine.evaluate import EvaluateEngine
from unet_studio_tpu_torch.io.nifti import read_nifti, write_nifti
from unet_studio_tpu_torch.models import serialize as TS
from torch_one_thread import one_thread  # noqa: F401  (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("name", ["golden", "golden_bmu", "golden_mc", "golden_pp"])
def test_golden_fixtures(name):
    d = os.path.join(FIXTURES, name)
    exp = np.load(os.path.join(d, "expected.npz"))
    model = TS.load_model(os.path.join(d, "model.nz"), device="cpu")
    model.prepare_for_inference()
    eng = EvaluateEngine(model, compute_dtype=torch.float32, device="cpu")
    case = next(iter(eng.run([os.path.join(d, "input.nii.gz")])))
    assert not case.error_msg, case.error_msg
    assert float(np.mean(case.label == exp["label"])) > 0.999
    # fg_prob leaves the device as bf16 (one ulp ~0.0039 near 1.0)
    np.testing.assert_allclose(case.fg_prob, exp["fg_prob"], atol=8e-3)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A 16^3 1 mm model and an 18x20x22 native volume at
    (1.1, 0.9, 1.25) mm with a flipped axis."""
    d = tmp_path_factory.mktemp("synthetic")
    src = TS.load_model(os.path.join(FIXTURES, "golden", "model.nz"), device="cpu")
    model_path = str(d / "m.nz")
    TS.save_model(model_path, src, sloped=False)
    rng = np.random.default_rng(5)
    vol = np.zeros((22, 20, 18), np.float32)
    vol[4:18, 3:17, 3:15] = 1.0
    vol += rng.random(vol.shape, np.float32) * 0.3
    aff = np.diag([-1.1, 0.9, 1.25, 1.0]).astype(np.float32)
    img = str(d / "img.nii.gz")
    write_nifti(img, vol, (1.1, 0.9, 1.25), aff)
    return model_path, img


def test_matches_jax_engine(synthetic):
    model_path, img = synthetic
    jeng = JEngine(JS.load_model(model_path), compute_dtype=jnp.float32)
    jc = next(iter(jeng.run([img])))
    teng = EvaluateEngine(TS.load_model(model_path, device="cpu"),
                          compute_dtype=torch.float32, device="cpu")
    tc = next(iter(teng.run([img])))
    assert not jc.error_msg and not tc.error_msg
    assert tc.label.shape == jc.label.shape == (22, 20, 18)
    assert tc.flip_swap == jc.flip_swap and tc.flip_swap
    assert float(np.mean(tc.label == jc.label)) > 0.999
    np.testing.assert_allclose(tc.fg_prob, jc.fg_prob, atol=8e-3)
    ref = jc.label_prob
    assert np.abs(tc.label_prob - ref).max() / np.abs(ref).max() < 1e-4
    # post-processing actions on the same probabilities
    for cmd, p1, p2 in [("normalize_each", 0, 0), ("defragment_each", 0.3, 0),
                        ("soft_max", 0.2, 0), ("defragment", 0.5, 1), ("argmax", 0.5, 0)]:
        jeng.proc_action(jc, cmd, p1, p2)
        teng.proc_action(tc, cmd, p1, p2)
        np.testing.assert_allclose(tc.label_prob, jc.label_prob, atol=1e-4, err_msg=cmd)
    np.testing.assert_array_equal(tc.label, jc.label)


def test_save_case_output_types(synthetic, tmp_path):
    model_path, img = synthetic
    eng = EvaluateEngine(TS.load_model(model_path, device="cpu"),
                         compute_dtype=torch.float32, device="cpu")
    case = next(iter(eng.run([img])))
    native = read_nifti(img)
    shapes = {0: native.data.shape, 1: native.data.shape, 2: native.data.shape,
              3: (3, *native.data.shape)}
    for t, shape in shapes.items():
        out = str(tmp_path / f"o{t}.nii.gz")
        assert eng.save_case(case, out, t)
        back = read_nifti(out)
        assert back.data.shape == shape
        np.testing.assert_array_equal(back.affine, native.affine)
    assert not eng.save_case(case, str(tmp_path / "bad.nii.gz"), 4)
    # type 0 is the label volume written back in the file's orientation
    lab = read_nifti(str(tmp_path / "o0.nii.gz")).data
    assert set(np.unique(lab)) <= {0, 1, 2}


def test_cli_evaluate(synthetic, tmp_path):
    model_path, img_src = synthetic
    img = str(tmp_path / "case.nii.gz")
    with open(img_src, "rb") as f, open(img, "wb") as g:
        g.write(f.read())
    rc = cli.main(["--action", "evaluate", "--model", model_path, "--source", img,
                   "--device", "cpu", "--compute_dtype", "float32"])
    assert rc == 0
    out = read_nifti(img + ".result.nii.gz")
    assert out.data.shape == read_nifti(img).data.shape
    assert set(np.unique(out.data)) <= {0, 1, 2}
    assert cli.main(["--action", "train", "--model", model_path, "--device", "cpu"]) == 1
