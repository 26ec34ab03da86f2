"""The port's training engine on the CPU: the BIDS reader and the sample
stream against the JAX package's, ``TrainEngine`` (epochs, validation,
autosave, the ``.opt`` file both packages read, resume), the item
synthesis of ``TrainStep``, and the CLI's ``train`` -> ``evaluate`` round
trip, on 16^3 phantoms with a small architecture.
"""

import os

import numpy as np
import pytest
import torch

from unet_studio_tpu.data import bids as JB
from unet_studio_tpu.models.unet3d import init_params as jax_init_params
from unet_studio_tpu_torch import cli
from unet_studio_tpu_torch.data import bids as TB
from unet_studio_tpu_torch.engine.optimizer import init_opt_state
from unet_studio_tpu_torch.engine.train import TrainEngine, TrainParam, build_train_step
from unet_studio_tpu_torch.io.nifti import write_nifti
from unet_studio_tpu_torch.models.dsl import parse_architecture
from unet_studio_tpu_torch.models.serialize import from_jax_opt_state, load_model, to_jax_opt_state
from unet_studio_tpu_torch.models.unet3d import UNet3d
from unet_studio_tpu_torch.ops.augment import AugOptions


def _arch(out: int) -> str:
    return "\n".join(
        [
            "conv8,ks3,stride1+norm,leaky_relu",
            "conv16,ks3,stride2+norm,leaky_relu",
            "conv16,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
            f"conv16,ks3,stride1+norm,leaky_relu+conv{out},ks1,stride1+conv_trans8,ks2,stride2",
            f"conv8,ks3,stride1+norm,leaky_relu+conv{out},ks1,stride1",
        ]
    )


ARCH = _arch(3)


def _phantom(n, shift=0.0):
    z, y, x = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((x - n / 2 - shift) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    label = (r < n / 3).astype(np.int16)
    label[r < n / 6] = 2
    img = (np.clip(1.0 - r / (n / 2), 0, 1) * (label > 0)).astype(np.float32)
    return img, label


def _bids(root, n=16, subjects=0):
    """One 16^3 template (MNI-flagged) and ``subjects`` subject pairs whose
    labels stop at 1."""
    os.makedirs(root, exist_ok=True)
    img, lab = _phantom(n)
    write_nifti(os.path.join(root, "tpl-A_T1w.nii.gz"), img, is_mni=True)
    write_nifti(os.path.join(root, "tpl-A_dseg.nii.gz"), lab, is_mni=True)
    for i in range(subjects):
        si, sl = _phantom(n, shift=1.0 + i)
        sub = os.path.join(root, f"sub-{i:02d}", "anat")
        os.makedirs(sub, exist_ok=True)
        write_nifti(os.path.join(sub, f"sub-{i:02d}_T1w.nii.gz"), si)
        write_nifti(os.path.join(sub, f"sub-{i:02d}_dseg.nii.gz"), (sl > 0).astype(np.int16))
    return root


def test_bids_pairs_scan_and_sample_stream(tmp_path):
    root = _bids(str(tmp_path / "bids"), subjects=2)
    images, labels = TB.get_bids_pairs(root)
    assert (images, labels) == JB.get_bids_pairs(root)
    ours = TB.TrainingDataset.scan(images, labels, 4)
    theirs = JB.TrainingDataset.scan(images, labels, 4)
    for name in ("is_template", "need_shift", "max_template_label", "template_indices",
                 "subject_indices", "test_indices"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.has_subject_data and any(ours.need_shift)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    assert [ours.sample_index(ra, s % 4, 4) for s in range(40)] == \
        [theirs.sample_index(rb, s % 4, 4) for s in range(40)]
    img = np.random.default_rng(0).random((4, 4, 4)).astype(np.float32)
    lab = (img > 0.5).astype(np.float32)
    np.testing.assert_array_equal(TB.shift_subject_label(img, lab, 2),
                                  JB.shift_subject_label(img, lab, 2))
    with pytest.raises(FileNotFoundError):
        TB.get_bids_pairs(str(tmp_path / "missing"))


def test_load_pair_on_model_grid_matches_jax(tmp_path):
    root = _bids(str(tmp_path / "bids"))
    images, labels = TB.get_bids_pairs(root)
    oi, ol = TB.load_pair_on_model_grid(images[0], labels[0], (20, 18, 16), (0.9, 1.0, 1.1),
                                        device="cpu")
    ji, jl = JB.load_pair_on_model_grid(images[0], labels[0], (20, 18, 16), (0.9, 1.0, 1.1))
    np.testing.assert_allclose(oi, ji, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ol, jl)


def _engine(tmp_path, epochs, model=None, **kw):
    root = _bids(str(tmp_path / "bids"), subjects=1)
    images, labels = TB.get_bids_pairs(root)
    if model is None:
        model = UNet3d.create(1, 4, _arch(4), seed=0, device="cpu")
        model.dim = (16, 16, 16)
    param = TrainParam(image_file_name=images, label_file_name=labels, batch_size=2,
                       epoch=epochs, learning_rate=0.01, compute_dtype="float32", **kw)
    return TrainEngine(model, param, model_path=str(tmp_path / "m.nz"), device="cpu")


def test_engine_epochs_autosave_opt_and_resume(tmp_path):
    """Two epochs ending on epoch 100 (the autosave), the .opt file in the
    JAX package's format, then a resume that continues the sample stream."""
    eng = _engine(tmp_path, 102)
    eng.model.testing_errors = [0.5] * (3 * 98)  # resume at epoch 98
    eng.start()
    assert not eng.error_msg and eng.cur_epoch == 98
    assert eng._step.has_subjects and eng._step.any_shift
    draws_98_99 = eng._epoch_draws(98) + eng._epoch_draws(99)
    for _ in range(2):
        info = eng.run_epoch()
        assert np.isfinite(info["test"]).all() and len(info["test"]) == 3
    assert eng.cur_epoch == 100 and "epoch 100/102" in eng.get_status()
    assert len(eng.model.testing_errors) == 3 * 100
    path = str(tmp_path / "m.nz")
    assert os.path.exists(path) and os.path.exists(path + ".opt")
    eng.stop()

    # the .opt file: JAX names and layouts (DHWIO convs), the step count
    spec = eng.model.spec
    data = np.load(path + ".opt")
    jax_shapes = {k: v.shape for k, v in jax_init_params(spec, 0).items()}
    assert {k[len("momentum/"):]: v.shape for k, v in data.items()
            if k.startswith("momentum/")} == jax_shapes
    assert int(data["step"]) == 2
    back = from_jax_opt_state(spec, {"momentum": {k[9:]: v for k, v in data.items()
                                                   if k.startswith("momentum/")},
                                     "step": data["step"]})
    for k, v in eng.opt_state["momentum"].items():
        assert torch.equal(back["momentum"][k], v), k

    # resume from the saved files: the epoch from the error history, the
    # momentum from .opt, the same sample stream
    again = _engine(tmp_path, 102, model=load_model(path, device="cpu"))
    again.start()
    assert again.cur_epoch == 100 and again.opt_state["step"] == 2
    for k, v in eng.opt_state["momentum"].items():
        assert torch.allclose(again.opt_state["momentum"][k], v), k
    fresh = _engine(tmp_path, 102)
    fresh.start()
    assert fresh._epoch_draws(98) + fresh._epoch_draws(99) == draws_98_99


def test_opt_file_round_trip_with_the_jax_engine(tmp_path):
    """The ``.opt`` file the JAX package's engine writes loads into the
    port's state, and the one the port writes loads back into the JAX
    engine unchanged (both through the engines' own save/load code)."""
    import jax.numpy as jnp

    from unet_studio_tpu.engine.train import TrainEngine as JaxEngine
    from unet_studio_tpu.parallel.mesh import make_mesh

    spec = parse_architecture(1, 3, ARCH)
    rng = np.random.default_rng(1)
    jax_mom = {k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in jax_init_params(spec, 0).items()}
    path = str(tmp_path / "m.nz")
    jax_eng = JaxEngine.__new__(JaxEngine)
    jax_eng.model_path, jax_eng.mesh = path, make_mesh(n_data=1)
    jax_eng.opt_state = {"momentum": {k: jnp.asarray(v) for k, v in jax_mom.items()},
                         "step": jnp.asarray(7, jnp.int32)}
    jax_eng._save_optimizer()

    model = UNet3d.create(1, 3, ARCH, seed=0, device="cpu")
    eng = TrainEngine(model, TrainParam(), model_path=path, device="cpu")
    eng.opt_state = init_opt_state(model.params())
    eng._maybe_load_optimizer()
    want = from_jax_opt_state(spec, {"momentum": jax_mom, "step": 7})
    assert eng.opt_state["step"] == 7
    for k, v in want["momentum"].items():
        assert torch.equal(eng.opt_state["momentum"][k], v), k
    os.remove(path + ".opt")
    eng._save_optimizer()
    jax_eng.opt_state = None
    jax_eng._maybe_load_optimizer()
    assert int(jax_eng.opt_state["step"]) == 7
    for k, v in jax_mom.items():
        np.testing.assert_array_equal(np.asarray(jax_eng.opt_state["momentum"][k]), v)
    back = to_jax_opt_state(spec, eng.opt_state)
    for k, v in jax_mom.items():
        np.testing.assert_array_equal(back["momentum"][k], v)


def test_train_step_synthesis():
    """The step's synthesis is deterministic per (seed, seed_id) and the
    same through the wrappers and through ``plain``; it picks the subject
    simulation for subject items and records only their metrics where
    there is subject data."""
    model = UNet3d.create(1, 3, ARCH, seed=0, device="cpu")
    img, lab = _phantom(16)
    images = torch.from_numpy(np.stack([img, img])[..., None])
    labels = torch.from_numpy(np.stack([lab, lab]).astype(np.float32))
    step, _ = build_train_step(model, TrainParam(batch_size=2, compute_dtype="float32",
                                                 options=AugOptions()),
                               has_subjects=True, device="cpu")
    seeds = [(0, 0), (0, 1)]
    tmpl = [True, False]
    timings = {}
    g1, m1, l1 = step.grads(images, labels, is_template=tmpl, seeds=seeds, timings=timings)
    g2, m2, l2 = step.grads(images, labels, is_template=tmpl, seeds=seeds, plain=True)
    assert float(l1) == float(l2) and torch.equal(m1, m2)
    assert float(m1[3]) == 1.0  # only the subject item is recorded
    assert set(timings) == {"synth_s", "forward_s", "backward_s"}
    a, _ = step.synthesize(images[0], labels[0], True, np.random.default_rng([0, 0]))
    b, _ = step.synthesize(images[0], labels[0], False, np.random.default_rng([0, 0]))
    assert not torch.equal(a, b)
    opt = init_opt_state(model.params())
    opt, metrics, loss = step(opt, images, labels, None, 0.01, is_template=tmpl, seeds=seeds)
    assert opt["step"] == 1 and torch.isfinite(loss)


def test_cli_train_resume_and_evaluate(tmp_path, capsys):
    root = _bids(str(tmp_path / "bids"))
    model = str(tmp_path / "m.nz")
    quiet = ["--downsample_x", "0", "--downsample_y", "0", "--downsample_z", "0", "--noise", "0",
             "--ambient", "0", "--diffuse", "0", "--specular", "0", "--rubber_stamping", "0",
             "--perlin_texture", "0", "--zero_background", "4"]
    rc = cli.main(["--action", "train", "--model", model, "--bids", root, "--batch_size", "2",
                   "--epoch", "2", "--device", "cpu", "--architecture", ARCH,
                   "--compute_dtype", "float32", "--save_session", str(tmp_path / "s.json"),
                   *quiet])
    out = capsys.readouterr().out
    assert rc == 0 and "starting epoch: 0" in out
    assert f"save model to {model}.final.nz" in out
    rc = cli.main(["--action", "train", "--model", model + ".final.nz", "--bids", root,
                   "--batch_size", "2", "--epoch", "3", "--device", "cpu", *quiet])
    assert rc == 0 and "starting epoch: 2" in capsys.readouterr().out
    final = load_model(model + ".final.nz.final.nz", device="cpu")
    assert len(final.testing_errors) == 9
    src = os.path.join(root, "tpl-A_T1w.nii.gz")
    rc = cli.main(["--action", "evaluate", "--model", model + ".final.nz.final.nz",
                   "--source", src, "--device", "cpu"])
    assert rc == 0 and os.path.exists(src + ".result.nii.gz")
    assert cli.main(["--action", "qc", "--model", model, "--bids", root, "--device", "cpu"]) == 1
