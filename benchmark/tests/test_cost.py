"""The frozen cost arithmetic against hand counts and the program's own."""

from __future__ import annotations

import json

import pytest

from benchmark.cost import backward_cost, chip_peaks, forward_cost, layer_cost, least_seconds
from benchmark.harness import ROOT
from benchmark.reference.dsl import LayerSpec, parse_architecture

CONFIGS = ("unet_studio_default", "nnunet_fullres_32_320")


def test_one_conv_by_hand():
    layer = LayerSpec("conv", 16, 32, ks=3, stride=2, act="leaky_relu")
    f, b, out = layer_cost(layer, [8, 10, 12], 2)
    assert out == [4, 5, 6]
    assert f == 2 * (4 * 5 * 6) * 27 * 16 * 32
    assert b == (8 * 10 * 12 * 16 + 4 * 5 * 6 * 32) * 2 + 27 * 16 * 32 * 2
    bf, bb = backward_cost(layer, [8, 10, 12], 2, need_dx=True)
    assert bf == 2 * f
    x, g, w = 8 * 10 * 12 * 16 * 2, 4 * 5 * 6 * 32 * 2, 27 * 16 * 32 * 2
    assert bb == (x + g + w) + (g + w + x)
    assert backward_cost(layer, [8, 10, 12], 2, need_dx=False) == (f, x + g + w)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_program(name):
    from unet_studio_tpu_torch.models.dsl import parse_architecture as prog_parse
    from unet_studio_tpu_torch.utils.flops import forward_cost as prog_cost

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    dhw = tuple(reversed(cfg["grid_xyz"]))
    ours = forward_cost(parse_architecture(1, 3, cfg["architecture"]), dhw)
    assert ours == prog_cost(prog_parse(1, 3, cfg["architecture"]), dhw)


@pytest.mark.parametrize("name,tflop,least_ms", [("unet_studio_default", 0.964, 7.66),
                                                 ("nnunet_fullres_32_320", 3.759, 19.93)])
def test_sizes(name, tflop, least_ms):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    spec = parse_architecture(1, 3, cfg["architecture"])
    dhw = tuple(reversed(cfg["grid_xyz"]))
    assert forward_cost(spec, dhw)[0] / 1e12 == pytest.approx(tflop, abs=5e-4)
    peaks = chip_peaks("NVIDIA H100 80GB HBM3")
    assert least_seconds(spec, dhw, peaks) * 1e3 == pytest.approx(least_ms, abs=5e-3)
    # inference skips the heads of levels 1..4
    assert forward_cost(spec, dhw, heads="level0")[0] < forward_cost(spec, dhw)[0]
    assert chip_peaks("Some other card") is None
