"""The port's host modules against the JAX package's on the CPU: model
surgery, the option-file parser, Settings, match_files, log, the PNG
encoder and the mosaic, the FLOPs walker, and the profiling helpers
(tests/test_misc.py's cases)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from unet_studio_tpu.config import options as JO
from unet_studio_tpu.config import session as JSS
from unet_studio_tpu.models import surgery as JSU
from unet_studio_tpu.models.unet3d import UNet3d as JaxUNet3d
from unet_studio_tpu.ui import png as JP
from unet_studio_tpu.utils import flops as JF
from unet_studio_tpu.utils import log as JL
from unet_studio_tpu.utils import match as JMA
from unet_studio_tpu.utils import mosaic as JMO
from unet_studio_tpu_torch.config import options as TO
from unet_studio_tpu_torch.config import session as TSS
from unet_studio_tpu_torch.models import surgery as TSU
from unet_studio_tpu_torch.models.dsl import default_architecture, parse_architecture
from unet_studio_tpu_torch.models.serialize import from_jax_params
from unet_studio_tpu_torch.models.unet3d import UNet3d
from unet_studio_tpu_torch.ui import png as TP
from unet_studio_tpu_torch.utils import flops as TF
from unet_studio_tpu_torch.utils import log as TL
from unet_studio_tpu_torch.utils import match as TMA
from unet_studio_tpu_torch.utils import mosaic as TMO
from unet_studio_tpu_torch.utils import profiling as TPR

ARCH = "\n".join([
    "conv8,ks3,stride1+norm,leaky_relu",
    "conv16,ks3,stride2+norm,leaky_relu",
    "conv16,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
    "conv16,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1+conv_trans8,ks2,stride2",
    "conv8,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1",
])


def _port_of(jm) -> UNet3d:
    m = UNet3d(jm.spec)
    m.load_state_dict(from_jax_params(jm.spec, {k: np.asarray(v) for k, v in jm.params.items()}))
    m.dim, m.preproc, m.testing_errors = tuple(jm.dim), jm.preproc, list(jm.testing_errors)
    return m


def _assert_params_equal(port: UNet3d, jm):
    ref = from_jax_params(jm.spec, {k: np.asarray(v) for k, v in jm.params.items()})
    got = port.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_surgery_matches_jax():
    jm = JaxUNet3d.create(1, 3, ARCH, seed=0)
    jm.preproc, jm.testing_errors = "normalize", [0.5, 0.25]
    m = _port_of(jm)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 8, 8, 1), np.float32))
    base = m(x)[0]

    re = TSU.reorder_output_channels(m, [2, 0, 1])
    _assert_params_equal(re, JSU.reorder_output_channels(jm, [2, 0, 1]))
    out = re(x)[0]
    torch.testing.assert_close(out[..., 0], base[..., 2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[..., 1], base[..., 0], rtol=1e-5, atol=1e-6)
    assert re.preproc == "normalize" and re.testing_errors == [0.5, 0.25]
    assert re.device == m.device and re is not m
    with pytest.raises(ValueError):
        TSU.reorder_output_channels(m, [0, 0, 1])

    padded = TSU.pad_out_count(m, 5)
    _assert_params_equal(padded, JSU.pad_out_count(jm, 5))
    assert padded.out_count == 5 and padded.testing_errors == []
    torch.testing.assert_close(padded(x)[0][..., :3], base, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TSU.pad_out_count(m, 2)


def test_surgery_on_a_transposed_head():
    """A head that is a transposed conv: the class dimension is dim 1 of
    its (I, O, 2, 2, 2) weight in the port's layout, the last axis of
    (I, 2, 2, 2, O) in the JAX package's."""
    arch = "\n".join([
        "conv8,ks3,stride1+norm,leaky_relu",
        "conv8,ks3,stride2+norm,leaky_relu+conv_trans8,ks2,stride2",
        "conv8,ks3,stride1+norm,leaky_relu+conv_trans3,ks2,stride2",
    ])
    jm = JaxUNet3d.create(1, 3, arch, seed=2)
    assert [layer.kind for layer in jm.spec.heads[0]] == ["conv_trans"]
    _assert_params_equal(TSU.reorder_output_channels(_port_of(jm), [1, 2, 0]),
                         JSU.reorder_output_channels(jm, [1, 2, 0]))


def test_parse_option_line_and_file(tmp_path):
    lines = [
        "Reduction/Noise/noise/Off:25%:50%:75%:On/2/add uniform noise",
        "Reduction/M/noise_mag/float:0.0:1.0:0.1:2/0.2/magnitude",
        "Reduction/M/noise_mag3/float:0.0:1.0:0.1/0.2f/three fields",
        "Camera/Foci/distortion_count/int:1:10:1/3/number of foci",
        "Post-processing/Defragment/defragment/button/0/zero background",
        "too/short",
    ]
    for line in lines:
        ours, theirs = TO.parse_option_line(line), JO.parse_option_line(line)
        if theirs is None:
            assert ours is None
            continue
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    item = TO.parse_option_line(lines[0])
    assert item.id == "noise" and item.kind == "prob" and item.default == 2
    item = TO.parse_option_line(lines[1])
    assert item.kind == "float" and item.maximum == 1.0 and item.decimals == 2
    assert TO.parse_option_line(lines[4]).kind == "button"
    path = tmp_path / "options.txt"
    path.write_text("\n".join(lines) + "\n")
    ours = [dataclasses.asdict(i) for i in TO.load_options_file(str(path))]
    assert ours == [dataclasses.asdict(i) for i in JO.load_options_file(str(path))]
    assert len(ours) == 5


def test_settings_round_trip(tmp_path, monkeypatch):
    p = str(tmp_path / "cfg" / "settings.json")
    cfg = TSS.Settings(path=p)
    assert cfg.value("last_network", "none") == "none"
    cfg.set("last_network", "human.t1w.seg5")
    cfg.set("options", {"noise": 4})
    cfg.save()
    assert TSS.Settings(path=p).value("last_network") == "human.t1w.seg5"
    # the same file and keys as the JAX package's
    assert JSS.Settings(path=p).value("options") == {"noise": 4}
    with open(p, "w") as f:
        f.write("{not json")
    assert TSS.Settings(path=p).value("options") is None
    monkeypatch.setenv("HOME", str(tmp_path))
    assert TSS.Settings().path == JSS.Settings().path == str(
        tmp_path / ".config" / "unet_studio_tpu.json")


def test_match_files_matches_jax():
    cases = [
        ("/d/sub-01_T1w.nii.gz", "/o/sub-01_mask.nii.gz", "/d/sub-02_T1w.nii.gz"),
        ("/d/a/T1w.nii.gz", "/d/a/a_out.nii.gz", "/d/b/T1w.nii.gz"),
        ("x.nii", "y.nii", "x.nii"),
        ("ab.nii", "out.nii", "ac.nii"),
        ("a.nii", "a.nii.out", "ab.nii"),
        ("s1.nii", "res/s1.nii", "s22.nii"),
    ]
    for case in cases:
        assert TMA.match_files(*case) == JMA.match_files(*case), case
    assert TMA.match_files(*cases[0]) == "/o/sub-02_mask.nii.gz"
    assert TMA.match_files(*cases[1]) == "/d/a/b_out.nii.gz"
    assert TMA.match_files(*cases[3]) is None


def test_log_output_matches_jax(capsys):
    def run(L):
        L.out("hello", 1)
        L.warning("careful")
        with L.progress("stage"):
            L.error("bad", 2)
        return capsys.readouterr().out

    ours, theirs = run(TL), run(JL)
    strip = [line for line in ours.splitlines() if "done" not in line]
    assert strip == [line for line in theirs.splitlines() if "done" not in line]
    assert "hello 1\nWARNING: careful\nstage...\n  ERROR: bad 2\n" in ours
    assert TL._depth == 0


def test_png_and_mosaic_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (7, 9)).astype(np.uint8)
    rgb = rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)
    assert TP.encode_png(gray) == JP.encode_png(gray)
    assert TP.encode_png(rgb) == JP.encode_png(rgb)
    with pytest.raises(ValueError):
        TP.encode_png(np.zeros((2, 2, 4), np.uint8))
    np.testing.assert_array_equal(TP.LABEL_COLORS, JP.LABEL_COLORS)
    img, lab = rng.random((6, 8)), rng.integers(0, 14, (6, 8))
    assert TP.render_slice(img, lab) == JP.render_slice(img, lab)
    assert TP.render_slice(img) == JP.render_slice(img)

    vol = rng.random((20, 12, 10)).astype(np.float32)
    label = rng.integers(0, 4, (20, 12, 10))
    for args in ((vol,), (vol, label), (vol, label, 1, 4), (vol, None, 2, 100)):
        np.testing.assert_array_equal(TMO.make_mosaic(*args), JMO.make_mosaic(*args))
    assert TMO.make_mosaic(vol, label).shape == (4 * 12, 5 * 10, 3)
    TMO.save_mosaic_png(str(tmp_path / "p.png"), vol, label)
    JMO.save_mosaic_png(str(tmp_path / "j.png"), vol, label)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()


@pytest.mark.parametrize("arch,dhw", [
    (default_architecture(3), (192, 224, 192)),
    (ARCH, (16, 24, 32)),
    ("conv8,ks3,stride1+bnorm,relu+max_pool\nconv16,ks3,stride1+norm,elu\n"
     "conv16,ks3,stride1+upsample+conv8,ks3,stride1+conv2,ks1,stride1", (8, 8, 8)),
])
def test_flops_match_jax(arch, dhw):
    from unet_studio_tpu.models.dsl import parse_architecture as jax_parse

    spec, jspec = parse_architecture(1, 3, arch), jax_parse(1, 3, arch)
    for bpe in (2, 4):
        assert TF.forward_cost(spec, dhw, bpe) == JF.forward_cost(jspec, dhw, bpe)
        assert TF.train_step_flops(spec, dhw, bpe) == JF.train_step_flops(jspec, dhw, bpe)
    flops, nbytes = TF.forward_cost(spec, dhw)
    assert isinstance(flops, int) and flops > 0 and nbytes > 0


def test_chip_peaks():
    assert TF.chip_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert TF.chip_peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    assert TF.chip_peaks("NVIDIA H100 NVL") == (989e12, 3.35e12)
    assert TF.chip_peaks("TPU v5 lite") is None and TF.chip_peaks("cpu") is None


def test_profiling_on_the_cpu(tmp_path, monkeypatch):
    calls = []
    x = torch.ones(64)

    def body(v):
        calls.append(1)
        return v * 2

    s = TPR.device_time(body, x, iters=3, device="cpu")
    assert s >= 0 and len(calls) == 4
    log_dir = tmp_path / "trace"
    with TPR.trace(str(log_dir), device="cpu"):
        (x @ x).item()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        assert "traceEvents" in json.load(f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPR.device_time(body, x)
