"""The port's template/atlas parcellation (engine/atlas.py, the region-grow
fill of ops/morphology.py, utils/assets.py) against the JAX package's on
the CPU: reclassification, the corrected atlas built and read back from
its cache (bitwise), the region grow, the load errors and the template
scan (tests/test_atlas.py's cases, and an atlas on a shifted 1.1 mm grid
so the majority resample does work)."""

import os

import numpy as np
import pytest

from unet_studio_tpu.engine import atlas as JA
from unet_studio_tpu.io.nifti import write_nifti
from unet_studio_tpu.ops import morphology as JM
from unet_studio_tpu.utils import assets as JS
from unet_studio_tpu_torch.engine import atlas as TA
from unet_studio_tpu_torch.io.nifti import read_nifti
from unet_studio_tpu_torch.ops import morphology as TM
from unet_studio_tpu_torch.utils import assets as TS


def test_reclassify_matches_jax():
    template = np.zeros((4, 4, 4), np.uint8)
    template[:, :, :2] = 1
    template[:, :, 2:] = 2
    atlas = np.zeros((4, 4, 4), np.uint16)
    atlas[0, :, :2] = 1
    atlas[0, 0, 2:] = 1
    atlas[1, :, 2:] = 2
    out, erased = TA.reclassify_labels_by_template(template, atlas)
    ref, ref_erased = JA.reclassify_labels_by_template(template, atlas)
    np.testing.assert_array_equal(out, ref)
    assert erased == ref_erased == [2, 0]
    assert (out[0, 0, 2:] == 0).all() and (out[0, :, :2] == 1).all()

    rng = np.random.default_rng(0)
    template = rng.integers(0, 5, (12, 10, 8)).astype(np.uint8)
    atlas = rng.integers(0, 9, (12, 10, 8)).astype(np.uint16)
    out, erased = TA.reclassify_labels_by_template(template, atlas)
    ref, ref_erased = JA.reclassify_labels_by_template(template, atlas)
    np.testing.assert_array_equal(out, ref)
    assert erased == ref_erased and sum(erased) > 0
    empty = np.zeros_like(atlas)
    assert TA.reclassify_labels_by_template(template, empty)[1] == []


def _assets(tmp_path, shifted: bool, n=16):
    """A tissue template (label 7 must be dropped) and an atlas of three
    regions, on the template's grid or on a shifted 1.1 mm grid."""
    template = np.zeros((n, n, n), np.int16)
    template[2:14, 2:14, 2:8] = 1
    template[2:14, 2:14, 8:14] = 2
    template[0, 0, 0] = 7
    m = 14 if shifted else n
    atlas = np.zeros((m, m, m), np.int16)
    atlas[2:m - 2, 2:m // 2, 2:m // 2] = 1
    atlas[2:m - 2, m // 2:m - 2, 2:m // 2] = 2
    atlas[2:m - 2, 2:m - 2, m // 2:m - 2] = 3
    tpl = str(tmp_path / "tissue.nii.gz")
    atl = str(tmp_path / ("shifted.nii.gz" if shifted else "regions.nii.gz"))
    write_nifti(tpl, template, is_mni=True)
    if shifted:
        aff = np.diag([1.1, 1.1, 1.1, 1.0])
        aff[:3, 3] = [0.7, -0.4, 0.3]
        write_nifti(atl, atlas, (1.1, 1.1, 1.1), aff, is_mni=True)
    else:
        write_nifti(atl, atlas, is_mni=True)
    return tpl, atl, template


@pytest.mark.parametrize("shifted", [False, True])
def test_corrected_atlas_built_and_cached_matches_jax(tmp_path, shifted):
    tpl, atl, template = _assets(tmp_path, shifted)
    name = os.path.basename(atl)[: -len(".nii.gz")] + ".corrected.nii.gz"
    ours = TA.AtlasParcellation(cache_dir=str(tmp_path / "port"), device="cpu")
    theirs = JA.AtlasParcellation(cache_dir=str(tmp_path / "jax"))
    for parc in (ours, theirs):
        assert parc.load_template(tpl), parc.error_msg
        assert parc.load_atlas(atl), parc.error_msg
    np.testing.assert_array_equal(ours.template, theirs.template)
    assert ours.template.max() == 2
    np.testing.assert_array_equal(ours.atlas, theirs.atlas)
    assert ours.atlas_region_count == theirs.atlas_region_count == 3
    assert (ours.atlas[template == 0] == 0).all()
    assert set(ours.seconds) == {"resample_s", "fill_s"}
    cached = read_nifti(str(tmp_path / "port" / name)).data
    np.testing.assert_array_equal(cached, read_nifti(str(tmp_path / "jax" / name)).data)
    # the second load reads the cache and gives the same atlas
    again = TA.AtlasParcellation(cache_dir=str(tmp_path / "port"), device="cpu")
    assert again.load_template(tpl) and again.load_atlas(atl)
    np.testing.assert_array_equal(again.atlas, ours.atlas)
    assert set(again.seconds) == {"resample_s"}


def test_region_grow_and_fill_match_jax(tmp_path):
    """A tissue covered over 75% is filled by region growing
    (evaluate.cpp:162-175); fill_and_smooth_labels and the majority
    filter at 24^3 equal the JAX package's."""
    n = 16
    template = np.zeros((n, n, n), np.int16)
    template[2:14, 2:14, 2:10] = 1
    atlas = np.zeros((n, n, n), np.int16)
    atlas[2:14, 2:14, 2:9] = 1
    write_nifti(str(tmp_path / "t.nii.gz"), template, is_mni=True)
    write_nifti(str(tmp_path / "a.nii.gz"), atlas, is_mni=True)
    parc = TA.AtlasParcellation(cache_dir=str(tmp_path / "c"), device="cpu")
    assert parc.load_template(str(tmp_path / "t.nii.gz"))
    assert parc.load_atlas(str(tmp_path / "a.nii.gz")), parc.error_msg
    assert (parc.atlas[template == 1] == 1).all()

    rng = np.random.default_rng(1)
    mask = rng.random((24, 24, 24)) < 0.6
    labels = np.where(rng.random((24, 24, 24)) < 0.3, rng.integers(1, 6, (24, 24, 24)), 0)
    labels = labels.astype(np.uint16)
    out = TM.fill_and_smooth_labels(mask, labels)
    np.testing.assert_array_equal(out, JM.fill_and_smooth_labels(mask, labels))
    assert (out[mask] > 0).mean() > 0.8 > (labels[mask] > 0).mean()
    np.testing.assert_array_equal(TM._majority_filter(labels), JM._majority_filter(labels))
    flat = np.full((4, 4, 4), 3, np.uint16)
    assert TM._majority_filter(flat) is flat


def test_load_errors(tmp_path):
    parc = TA.AtlasParcellation(cache_dir=str(tmp_path / "c"), device="cpu")
    assert not parc.load_template(str(tmp_path / "missing.nii.gz"))
    assert parc.error_msg
    tpl, atl, _ = _assets(tmp_path, False)
    parc = TA.AtlasParcellation(cache_dir=str(tmp_path / "c"), device="cpu")
    assert parc.load_template(tpl)
    assert not parc.load_atlas(str(tmp_path / "missing.nii.gz"))
    assert parc.error_msg
    jparc = JA.AtlasParcellation(cache_dir=str(tmp_path / "c"))
    assert jparc.load_template(tpl) and not jparc.load_atlas(str(tmp_path / "missing.nii.gz"))


def test_scan_templates_matches_jax(tmp_path):
    """Species rank (human first, unknown last), templates without a
    ``<name>_tissue.nii.gz`` skipped, the template's own files not listed
    as atlases; the model zoo."""
    vol = np.zeros((2, 2, 2), np.int16)
    for name, files in (("mouse", ["mouse_tissue.nii.gz", "mouse_x.nii.gz", "allen.nii.gz"]),
                        ("zebra", ["zebra_tissue.nii.gz"]),
                        ("human", ["human_tissue.nii.gz", "aal.nii.gz", "brodmann.nii"]),
                        ("rat", ["whs.nii.gz"])):
        os.makedirs(tmp_path / "atlas" / name)
        for f in files:
            write_nifti(str(tmp_path / "atlas" / name / f), vol)
    os.makedirs(tmp_path / "unet")
    for f in ("b.nz", "a.nz", "notes.txt"):
        (tmp_path / "unet" / f).write_bytes(b"")
    root = TS.find_asset_root(str(tmp_path))
    assert root == JS.find_asset_root(str(tmp_path)) == str(tmp_path)
    seg, atlases = TS.scan_templates(root)
    assert (seg, atlases) == JS.scan_templates(root)
    assert [os.path.basename(s) for s in seg] == ["human_tissue.nii.gz", "mouse_tissue.nii.gz",
                                                  "zebra_tissue.nii.gz"]
    assert [os.path.basename(a) for a in atlases[0]] == ["aal.nii.gz", "brodmann.nii"]
    assert [os.path.basename(a) for a in atlases[1]] == ["allen.nii.gz"]
    assert TS.zoo_models(root) == JS.zoo_models(root) and len(TS.zoo_models(root)) == 2
    assert TS.scan_templates(None) == ([], []) and TS.zoo_models(None) == []
    assert [TS._rank(k) for k in ("rhesus_x", "mouse", "yak")] == [2, 5, 6]
