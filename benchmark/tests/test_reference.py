"""The reference against the port's plain route at 32^3 on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import TINY_ARCH

from benchmark import inputs
from benchmark.reference import train as ref_train
from benchmark.reference.dsl import parse_architecture
from benchmark.reference.losses import deep_supervision_loss as ref_loss
from benchmark.reference.net import forward as ref_forward


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    spec = parse_architecture(1, 3, TINY_ARCH)
    gen = torch.Generator().manual_seed(2**33 + 5)
    weights = inputs.make_weights(spec, gen, "cpu")
    image, label = inputs.template_pair((30, 34, 30), gen, "cpu")
    return spec, weights, image, label


def test_forward_and_loss(setup):
    from unet_studio_tpu_torch.models.dsl import parse_architecture as prog_parse
    from unet_studio_tpu_torch.models.unet3d import forward_train
    from unet_studio_tpu_torch.ops.losses import deep_supervision_loss

    spec, weights, image, label = setup
    img, lab = ref_train.template_on_model_grid(image, label, [1.0] * 3, [1.0] * 3,
                                                [32, 32, 32], [1.0] * 3, "cpu")
    x, t = ref_train.synthesize(img, lab, 3, 11, 0)
    ours = ref_forward(spec, weights, x[None])
    theirs = forward_train(prog_parse(1, 3, TINY_ARCH), weights, x[None],
                           compute_dtype=torch.float32, plain=True)
    lvl0 = theirs[0].planes[:, 0].permute(1, 2, 3, 0)
    # f32 rounding: the program's norm takes E[x^2] - mean^2 in one pass,
    # the reference two passes (1.6e-5 of logits up to 6 here)
    assert torch.allclose(ours[0][0], lvl0, atol=1e-4, rtol=1e-4)
    assert torch.allclose(ours[1], theirs[1], atol=1e-4, rtol=1e-4)
    a, _ = ref_loss(ours, t[None].long(), 3)
    b, _ = deep_supervision_loss(theirs, t[None].long(), 3)
    assert float(a) == pytest.approx(float(b), rel=1e-5)


def test_template_and_item_match_program(setup, tmp_path):
    from unet_studio_tpu_torch.data.bids import load_pair_on_model_grid
    from unet_studio_tpu_torch.engine.train import TrainParam, TrainStep
    from unet_studio_tpu_torch.models.dsl import parse_architecture as prog_parse
    from unet_studio_tpu_torch.models.unet3d import UNet3d

    spec, weights, image, label = setup
    inputs.write_nifti(str(tmp_path / "i.nii.gz"), image, is_mni=True)
    inputs.write_nifti(str(tmp_path / "l.nii.gz"), label, is_mni=True)
    p_img, p_lab = load_pair_on_model_grid(str(tmp_path / "i.nii.gz"), str(tmp_path / "l.nii.gz"),
                                           (32, 32, 32), np.ones(3, np.float32), device="cpu")
    img, lab = ref_train.template_on_model_grid(image, label, [1.0] * 3, [1.0] * 3,
                                                [32, 32, 32], [1.0] * 3, "cpu")
    assert np.array_equal(p_img, img.numpy()) and np.array_equal(p_lab, lab.float().numpy())
    model = UNet3d(prog_parse(1, 3, TINY_ARCH))
    step = TrainStep(model, TrainParam(batch_size=2), device="cpu")
    a = step.synthesize(img[..., None], lab, True, np.random.default_rng([11, 3]), plain=True)
    b = ref_train.synthesize(img, lab, 3, 11, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_train_steps_match_program(setup):
    """Two SGD steps of the reference against the program's TrainStep (its
    twins, f32) from the same weights and items."""
    from unet_studio_tpu_torch.engine.optimizer import init_opt_state, poly_lr
    from unet_studio_tpu_torch.engine.train import TrainParam, TrainStep
    from unet_studio_tpu_torch.models.dsl import parse_architecture as prog_parse
    from unet_studio_tpu_torch.models.unet3d import UNet3d

    spec, weights, image, label = setup
    img, lab = ref_train.template_on_model_grid(image, label, [1.0] * 3, [1.0] * 3,
                                                [32, 32, 32], [1.0] * 3, "cpu")
    ref = ref_train.train_steps(spec, weights, img, lab, seed=11, batch=2, steps=2,
                                base_lr=1e-3, total_epochs=100)
    model = UNet3d(prog_parse(1, 3, TINY_ARCH))
    model.load_params({k: v.numpy() for k, v in weights.items()})
    step = TrainStep(model, TrainParam(batch_size=2, seed=11, compute_dtype="float32"),
                     device="cpu")
    opt = init_opt_state(model.params())
    losses = []
    for e in range(2):
        seeds = [(11, e * 2 + s) for s in range(2)]
        opt, _, loss = step(opt, img[None, ..., None].expand(2, -1, -1, -1, -1),
                            lab[None].expand(2, -1, -1, -1), None, poly_lr(1e-3, e, 100),
                            seeds=seeds)
        losses.append(float(loss))
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for k, p in model.params().items():
        assert torch.allclose(p, ref["params"][k], atol=1e-6, rtol=1e-4), k
