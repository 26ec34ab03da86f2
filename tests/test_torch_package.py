"""Package rules of the port: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU
(with no card they raise instead of falling back)."""

import ast
import os

import pytest
import torch

from unet_studio_tpu_torch import cli
from unet_studio_tpu_torch.data.bids import load_pair_on_model_grid
from unet_studio_tpu_torch.engine.atlas import AtlasParcellation
from unet_studio_tpu_torch.engine.evaluate import EvaluateEngine
from unet_studio_tpu_torch.engine.qc import run_qc
from unet_studio_tpu_torch.engine.train import TrainEngine, TrainParam, build_train_step
from unet_studio_tpu_torch.models.serialize import load_model
from unet_studio_tpu_torch.models.unet3d import UNet3d
from unet_studio_tpu_torch.ops import conv as K
from unet_studio_tpu_torch.ops import norm as N
from unet_studio_tpu_torch.ops import warp as W
from unet_studio_tpu_torch.ops.reduce import (
    channel_sqdiff,
    channel_sum,
    channel_sum_sq,
    norm_bwd_sums,
    volume_max,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "tests", "fixtures", "golden", "model.nz")


def _port_files():
    pkg = os.path.join(ROOT, "unet_studio_tpu_torch")
    for d, _, names in os.walk(pkg):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "unet_studio_tpu"


def test_no_jax_imports():
    files = list(_port_files())
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append((path, node.module))
    assert not bad, bad


def test_entry_points_need_a_card_or_cpu_request(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(MODEL)
    with pytest.raises(RuntimeError):
        UNet3d.create(1, 3, "conv8+norm\nconv8,ks3,stride2\nconv8+conv3,ks1")
    model = load_model(MODEL, device="cpu")
    with pytest.raises(RuntimeError):
        EvaluateEngine(model)
    with pytest.raises(RuntimeError):
        cli.main(["--action", "evaluate", "--model", MODEL, "--source", MODEL])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(model, TrainParam())
    build_train_step(model, TrainParam(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainEngine(model, TrainParam())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--action", "train", "--model", MODEL, "--bids", ROOT])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_qc(model, [], [], str(tmp_path / "qc.tsv"))
    run_qc(model, [], [], str(tmp_path / "qc.tsv"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AtlasParcellation()
    AtlasParcellation(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_pair_on_model_grid(MODEL, MODEL, (16, 16, 16), (1.0, 1.0, 1.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--action", "qc", "--model", MODEL, "--bids", ROOT])


def test_wrappers_take_no_other_device():
    """A wrapper runs its twin only for CPU tensors; any other device
    goes to the kernel path, which refuses what it cannot launch."""
    x = torch.empty((4, 4, 4, 16), device="meta")
    w = torch.empty((16, 16, 3, 3, 3), device="meta")
    b = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        K.conv3x3x3_s1(x, w, b)
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        channel_sum_sq(x)
    x2 = torch.empty((2, 2, 2, 32), device="meta")
    calls = [
        (K.conv3x3x3_dx, (x, w)),
        (K.conv3x3x3_dw, (x, x)),
        (K.conv3x3x3_s2_dw, (torch.empty((4, 4, 4, 16), device="meta"), x2)),
        (K.conv3x3x3_s2_dx, (x2, torch.empty((32, 16, 3, 3, 3), device="meta"))),
        (K.conv_trans2x_dx, (x, torch.empty((32, 16, 2, 2, 2), device="meta"))),
        (K.conv_trans2x_dw, (x2, x)),
        (norm_bwd_sums, (x, x, b, b)),
        (N.norm_act_bwd_sums, (x, x, b, b, b, b)),
        (N.norm_act, (x, b, b, b, b, "leaky_relu")),
        (N.norm_act_dx, (x, x, b, b, b, b, torch.empty((2, 16), device="meta"), "leaky_relu")),
        (channel_sum, (x,)),
        (channel_sqdiff, (x, b)),
        (volume_max, (x,)),
        (W.warp_linear, (x[..., 0], x[..., :3], False)),
        (W.warp_image_label, (x[..., 0], x[..., 0], x[..., :3], True)),
    ]
    for fn, args in calls:
        with pytest.raises(ValueError, match="expected cuda or cpu"):
            fn(*args)
    assert all(fn.launches == 0 for fn in (*K.WRAPPERS, *N.WRAPPERS, *W.WRAPPERS))


def test_ui_needs_a_card_or_cpu_request(monkeypatch):
    """The UI server is an entry point like the CLI: ``AppState`` and
    ``python -m unet_studio_tpu_torch.ui`` take the card by default and
    raise without one; the rule above reads ``ui/server.py`` too."""
    from unet_studio_tpu_torch.ui import server

    assert os.path.join(ROOT, "unet_studio_tpu_torch", "ui", "server.py") in _port_files()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("UNET_TPU_SETTINGS", os.path.join(ROOT, "build", "no_such_settings.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.AppState()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--port", "0"])
    assert server.AppState(device="cpu").device == torch.device("cpu")
