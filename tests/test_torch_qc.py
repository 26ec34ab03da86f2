"""The port's QC (engine/qc.py, the CLI's ``qc`` action) against the JAX
package's on the CPU: the golden preproc model, a 16^3 BIDS directory
with a template, a shifted subject (collapsed classes, ``N/A`` columns)
and two damaged pairs (``error:`` rows); an error of the forward ends the
run; and the CLI's qc, evaluate with ``--mosaic`` and ``--template/--atlas``
on a 16^3 phantom."""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_studio_tpu import cli as jcli
from unet_studio_tpu.engine.qc import run_qc as jax_run_qc
from unet_studio_tpu.io.nifti import write_nifti
from unet_studio_tpu.models.serialize import load_model as jax_load_model
from unet_studio_tpu.models.serialize import save_model as jax_save_model
from unet_studio_tpu.models.unet3d import UNet3d as JaxUNet3d
from unet_studio_tpu_torch import cli
from unet_studio_tpu_torch.data.bids import get_bids_pairs
from unet_studio_tpu_torch.engine import qc as Q
from unet_studio_tpu_torch.models.serialize import load_model
from unet_studio_tpu_torch.utils.mosaic import make_mosaic
from torch_one_thread import one_thread  # noqa: F401  (autouse)

GOLDEN_PP = os.path.join(os.path.dirname(__file__), "fixtures", "golden_pp")


def _arch(out):
    return "\n".join([
        "conv8,ks3,stride1+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
        f"conv16,ks3,stride1+norm,leaky_relu+conv{out},ks1,stride1+conv_trans8,ks2,stride2",
        f"conv8,ks3,stride1+norm,leaky_relu+conv{out},ks1,stride1",
    ])


def _phantom(n=16, shift=0.0):
    z, y, x = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((x - n / 2 - shift) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    label = (r < n / 3).astype(np.int16)
    label[r < n / 6] = 2
    img = np.clip(1.0 - r / (n / 2), 0, 1).astype(np.float32) * (label > 0)
    return img, label


def _model(path, out, n=16):
    m = JaxUNet3d.create(1, out, _arch(out), seed=0)
    m.dim = (n, n, n)
    jax_save_model(path, m, sloped=False)
    return path


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _same_report(ours, theirs, tol=1e-3):
    """The same layout (header, names, N/A and error: cells) and ratios
    within ``tol``."""
    a, b = _rows(ours), _rows(theirs)
    assert len(a) == len(b) and a[0] == b[0]
    for ra, rb in zip(a[1:], b[1:]):
        assert len(ra) == len(rb) and ra[:2] == rb[:2]
        for ca, cb in zip(ra[2:], rb[2:]):
            if ca == "N/A" or ca.startswith("error:") or cb == "N/A" or cb.startswith("error:"):
                assert (ca == "N/A") == (cb == "N/A")
                assert ca.startswith("error:") == cb.startswith("error:")
            else:
                assert abs(float(ca) - float(cb)) <= tol, (ra, rb)


def _same_cases(ours, theirs, tol=1e-3):
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert (o.image, o.label, o.unavailable_before) == (t.image, t.label, t.unavailable_before)
        assert bool(o.error) == bool(t.error), (o.error, t.error)
        if o.error:
            continue
        assert [s.voxels for s in o.stats] == [s.voxels for s in t.stats]
        assert o.overall.voxels == t.overall.voxels
        assert abs(o.overall.ratio() - t.overall.ratio()) <= tol
        for so, st in zip(o.stats, t.stats):
            assert abs(so.ratio() - st.ratio()) <= tol


def test_qc_golden_preproc_model_matches_jax(tmp_path):
    """The normalize+flip_x golden model (tests/test_golden.py
    test_qc_on_preproc_model): QC routes image and label through the
    model's preprocessing in both packages."""
    images = [os.path.join(GOLDEN_PP, "qc_input.nii.gz")]
    labels = [os.path.join(GOLDEN_PP, "label.nii.gz")]
    ours = Q.run_qc(load_model(os.path.join(GOLDEN_PP, "model.nz"), device="cpu"), images,
                    labels, str(tmp_path / "port.tsv"), compute_dtype=torch.float32,
                    device="cpu")
    theirs = jax_run_qc(jax_load_model(os.path.join(GOLDEN_PP, "model.nz")), images, labels,
                        str(tmp_path / "jax.tsv"), compute_dtype=jnp.float32)
    _same_cases(ours, theirs)
    assert ours[0].overall.voxels == 16 ** 3 and ours[0].overall.ratio() < 0.02
    _same_report(str(tmp_path / "port.tsv"), str(tmp_path / "jax.tsv"))
    assert not os.path.exists(str(tmp_path / "port.tsv") + ".tmp")


def _bids(root):
    """A template (labels 0-2), a subject with one label (shifted past the
    template's, so QC collapses classes 0-2), a pair with a truncated
    label and a pair with a truncated image."""
    os.makedirs(root)
    img, lab = _phantom()
    write_nifti(os.path.join(root, "tpl-A_T1w.nii.gz"), img, is_mni=True)
    write_nifti(os.path.join(root, "tpl-A_dseg.nii.gz"), lab, is_mni=True)
    img, lab = _phantom(shift=2.0)
    write_nifti(os.path.join(root, "sub-01_T1w.nii.gz"), img)
    write_nifti(os.path.join(root, "sub-01_dseg.nii.gz"), (lab > 0).astype(np.int16))
    for name, truncated in (("sub-02", "_dseg.nii.gz"), ("sub-03", "_T1w.nii.gz")):
        for suffix in ("_T1w.nii.gz", "_dseg.nii.gz"):
            path = os.path.join(root, name + suffix)
            write_nifti(path, img if suffix == "_T1w.nii.gz" else lab)
            if suffix == truncated:
                with open(path, "rb") as f:
                    head = f.read(100)
                with open(path, "wb") as f:
                    f.write(head)
    return root


def test_qc_bids_rows_match_jax(tmp_path):
    root = _bids(str(tmp_path / "bids"))
    images, labels = get_bids_pairs(root)
    mp = _model(str(tmp_path / "m.nz"), 4)
    ours = Q.run_qc(load_model(mp, device="cpu"), images, labels, str(tmp_path / "port.tsv"),
                    compute_dtype=torch.float32, n_workers=2, device="cpu")
    theirs = jax_run_qc(jax_load_model(mp), images, labels, str(tmp_path / "jax.tsv"),
                        compute_dtype=jnp.float32, n_workers=2)
    _same_cases(ours, theirs)
    _same_report(str(tmp_path / "port.tsv"), str(tmp_path / "jax.tsv"))
    by_name = {os.path.basename(c.image): c for c in ours}
    sub = by_name["sub-01_T1w.nii.gz"]
    assert sub.unavailable_before == 3 and not sub.error and sub.overall.voxels == 16 ** 3
    assert by_name["sub-02_T1w.nii.gz"].error and by_name["sub-03_T1w.nii.gz"].error
    tpl = by_name["tpl-A_T1w.nii.gz"]
    assert tpl.overall.wrong > 0 and sum(s.voxels for s in tpl.stats) == 16 ** 3
    rows = {r[0]: r for r in _rows(str(tmp_path / "port.tsv"))}
    assert rows["sub-01_T1w.nii.gz"][3:6] == ["N/A"] * 3
    assert rows["sub-02_T1w.nii.gz"][2].startswith("error: ")
    assert rows["sub-03_T1w.nii.gz"][2].startswith("error: ")


def test_qc_counts_against_host_recount(tmp_path):
    """The device function's integer counts equal a numpy recount from the
    same logits, and the collapse merges the first classes' logits."""
    from unet_studio_tpu_torch.models.unet3d import UNet3d, forward_fused

    model = UNet3d.create(1, 4, _arch(4), seed=1, device="cpu")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((16, 16, 16), np.float32))
    lab = torch.from_numpy(rng.integers(-1, 6, (16, 16, 16)).astype(np.float32))
    counts = Q.qc_counts(model, img, lab, 0, torch.float32).numpy()
    with torch.no_grad():
        logits = forward_fused(model.spec, model.params(), img[None, ..., None],
                               compute_dtype=torch.float32, level0_only=True)[0][0].numpy()
    voxels, wrong = Q.host_counts(logits, lab.numpy(), 4)
    np.testing.assert_array_equal(counts[0, :4], voxels)
    np.testing.assert_array_equal(counts[1, :4], wrong)
    assert counts[0].sum() == 16 ** 3 and counts[1, 4] == 0
    merged = Q.qc_counts(model, img, lab, 3, torch.float32).numpy()
    assert merged.shape == (2, 3) and merged[0].sum() == 16 ** 3


def test_qc_forward_error_ends_the_run(tmp_path, monkeypatch):
    """A pair's read error becomes a row; an error of the forward (a
    kernel or the card) ends the run with that error, writing no report."""
    root = _bids(str(tmp_path / "bids"))
    images, labels = get_bids_pairs(root)
    model = load_model(_model(str(tmp_path / "m.nz"), 4), device="cpu")

    def broken(*args, **kwargs):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(Q, "forward_fused", broken)
    report = str(tmp_path / "r.tsv")
    with pytest.raises(RuntimeError, match="injected kernel failure"):
        Q.run_qc(model, images, labels, report, compute_dtype=torch.float32, device="cpu")
    assert not os.path.exists(report)


def _assets(root, n=16):
    """<root>/atlas/human/human_tissue.nii.gz (tissues 1-2, a CSF label 5)
    and an atlas of 3 regions on a shifted 1.1 mm grid beside it."""
    d = os.path.join(root, "atlas", "human")
    os.makedirs(d)
    tissue = np.zeros((n, n, n), np.int16)
    tissue[2:14, 2:14, 2:8] = 1
    tissue[2:14, 2:14, 8:14] = 2
    tissue[0, 0, :3] = 5
    write_nifti(os.path.join(d, "human_tissue.nii.gz"), tissue, is_mni=True)
    m = 14
    atlas = np.zeros((m, m, m), np.int16)
    atlas[1:13, 1:7, 1:7] = 1
    atlas[1:13, 7:13, 1:7] = 2
    atlas[1:13, 1:13, 7:13] = 3
    aff = np.diag([1.1, 1.1, 1.1, 1.0])
    aff[:3, 3] = [0.7, 0.4, 0.3]
    path = os.path.join(d, "regions_atlas.nii.gz")
    write_nifti(path, atlas, (1.1, 1.1, 1.1), aff, is_mni=True)
    return path


def test_cli_qc_evaluate_mosaic_and_atlas(tmp_path, capsys, monkeypatch):
    """--action qc, then --action evaluate with --mosaic and a
    --template/--atlas parcellation, all with --device cpu; a --template
    index past the templates returns 1 with error: (the JAX package raises
    IndexError there: the C++ original's error is kept in the port)."""
    monkeypatch.chdir(tmp_path)  # corrected_atlas/ is written to the CWD
    img, lab = _phantom()
    src = str(tmp_path / "sub-01_T1w.nii.gz")
    write_nifti(src, img, is_mni=True)
    write_nifti(str(tmp_path / "sub-01_dseg.nii.gz"), lab, is_mni=True)
    mp = _model(str(tmp_path / "model.nz"), 3)

    # qc first: evaluate's result file would be picked up as another pair
    rc = cli.main(["--action", "qc", "--model", mp, "--bids", str(tmp_path),
                   "--compute_dtype", "float32", "--device", "cpu"])
    assert rc == 0
    report = tmp_path / "model.error_report.tsv"
    rows = _rows(str(report))
    assert len(rows) == 2 and rows[0][:3] == ["image", "ground_truth", "wrong_ratio"]
    assert len(rows[1]) == 6 and not rows[1][2].startswith("error")
    assert "QC report saved to" in capsys.readouterr().out

    atlas = _assets(str(tmp_path / "assets"))
    png = str(tmp_path / "mosaic.png")
    rc = cli.main(["--action", "evaluate", "--model", mp, "--source", src,
                   "--compute_dtype", "float32", "--device", "cpu", "--mosaic", png,
                   "--template", "0", "--atlas", atlas, "--asset_root", str(tmp_path / "assets")])
    out = capsys.readouterr().out
    assert rc == 0 and "atlas loaded: 3 regions" in out
    assert (tmp_path / "corrected_atlas" / "regions_atlas.corrected.nii.gz").exists()
    with open(png, "rb") as f:
        blob = f.read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, color = struct.unpack(">IIBB", blob[16:26])
    shape = make_mosaic(img, np.zeros_like(lab)).shape
    assert (h, w, depth, color) == (shape[0], shape[1], 8, 2)

    argv = ["--action", "evaluate", "--model", mp, "--source", src, "--template", "7",
            "--atlas", atlas, "--asset_root", str(tmp_path / "assets")]
    assert cli.main(argv + ["--device", "cpu"]) == 1
    assert "error: --template 7" in capsys.readouterr().err
    with pytest.raises(IndexError):
        jcli.main(argv)
