"""The entry conv's witness (``benchmark.entry_grad``) on the CPU at
32^3: the program's dW of the entry conv meets float64 from its own
inputs; in float32 the program meets the reference; in bfloat16 the
reference with the program's norm backward at the entry moves the leaf
as the program does, and rounding the conv's own incoming gradient does
not."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import entry_grad
from benchmark.harness import Bench
from conftest import tiny_root

SEED = 2**31 + 977


def _witness(tmp_path, dtype):
    torch.set_num_threads(2)
    b = Bench(tiny_root(tmp_path, dtype))
    w = b.cell("train.tiny")
    return entry_grad.witness(b.config(w), b.mix(w), SEED, torch.device("cpu"), True)


def test_float32_meets_reference(tmp_path):
    out = _witness(tmp_path, "float32")
    assert all(math.isfinite(v) for v in out.values() if isinstance(v, float))
    assert out["kernel_dist"] < 1e-5 and out["reference_self_dist"] < 1e-5
    assert out["program"] < 1e-3 and out["program_f32"] == pytest.approx(out["program"])


def test_bfloat16_norm_backward_moves_the_entry(tmp_path):
    out = _witness(tmp_path, "bfloat16")
    assert out["kernel_dist"] < 1e-5
    assert out["program_f32"] < 1e-3
    assert out["offset_program"] > 100 * out["offset_ref"]
    assert out["program"] > 5 * out["ref_g_bf16"]
    assert out["ref_norm_bf16"] > 5 * out["ref_g_bf16"]
