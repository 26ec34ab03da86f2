"""Which layers the port's two kernel forwards give the kernels, on the CPU.

``models/unet3d.py`` ``_route`` decides for both ``forward_train`` and
``forward_fused`` from ``ops/conv.py`` ``kernel_takes``.  These tests pin
the kernel wrapper calls each forward makes on the flagship network and on
nnU-Net's widths (32 to 320) at a 32^3 grid, and hold ``kernel_takes`` to
the tile tables of ``ops/tc_layout.py``.  The port alone builds the specs
and weights; no JAX.
"""

import pytest
import torch

from unet_studio_tpu_torch.models import unet3d as T
from unet_studio_tpu_torch.models.dsl import default_architecture, parse_architecture
from unet_studio_tpu_torch.ops import conv as K
from unet_studio_tpu_torch.ops import norm as N
from unet_studio_tpu_torch.ops import tc_layout as L
from torch_one_thread import one_thread  # noqa: F401  (autouse)

# nnU-Net v2 3d_fullres PlainConvUNet: 32 base features, at most 320
NNUNET_ARCH = "\n".join([
    "conv32,ks3,stride1+norm,leaky_relu+conv32,ks3,stride1+norm,leaky_relu",
    "conv64,ks3,stride2+norm,leaky_relu+conv64,ks3,stride1+norm,leaky_relu",
    "conv128,ks3,stride2+norm,leaky_relu+conv128,ks3,stride1+norm,leaky_relu",
    "conv256,ks3,stride2+norm,leaky_relu+conv256,ks3,stride1+norm,leaky_relu",
    "conv320,ks3,stride2+norm,leaky_relu+conv320,ks3,stride1+norm,leaky_relu",
    "conv320,ks3,stride2+norm,leaky_relu+conv320,ks3,stride1+norm,leaky_relu"
    "+conv_trans320,ks2,stride2",
    "conv320,ks3,stride1+norm,leaky_relu+conv320,ks3,stride1+norm,leaky_relu"
    "+conv3,ks1,stride1+conv_trans256,ks2,stride2",
    "conv256,ks3,stride1+norm,leaky_relu+conv256,ks3,stride1+norm,leaky_relu"
    "+conv3,ks1,stride1+conv_trans128,ks2,stride2",
    "conv128,ks3,stride1+norm,leaky_relu+conv128,ks3,stride1+norm,leaky_relu"
    "+conv3,ks1,stride1+conv_trans64,ks2,stride2",
    "conv64,ks3,stride1+norm,leaky_relu+conv64,ks3,stride1+norm,leaky_relu"
    "+conv3,ks1,stride1+conv_trans32,ks2,stride2",
    "conv32,ks3,stride1+norm,leaky_relu+conv32,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1",
])
ARCHS = {"default": default_architecture(3), "nnunet": NNUNET_ARCH}
CONVS = ("conv3x3x3_entry", "conv3x3x3_s1", "conv3x3x3_dual", "conv3x3x3_s2", "conv_trans2x")
# name: (calls of each of CONVS, K2 reads of the training norms, K2 reads of
# the inference forward's dual convs)
EXPECTED = {"default": ((1, 6, 3, 3, 2), 12, 3), "nnunet": ((1, 4, 2, 2, 1), 8, 2)}


def _setup(name):
    spec = parse_architecture(1, 3, ARCHS[name])
    params = {k: torch.from_numpy(v) for k, v in T.init_params(spec, 0).items()}
    x = torch.rand((1, 32, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    return spec, params, x


def _count(monkeypatch, calls, mod, name, key=None):
    fn = getattr(mod, name)

    def counted(*a, **k):
        calls[key or name] = calls.get(key or name, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(mod, name, counted)


@pytest.mark.parametrize("name", list(ARCHS))
def test_both_forwards_kernel_calls(monkeypatch, name):
    """forward_train and forward_fused(level0_only=True) make the same
    kernel conv calls; the training forward's norms read K2 for their
    statistics, the inference forward only after its dual convs (the
    other convs' epilogues give the stats)."""
    spec, params, x = _setup(name)
    calls = {}
    for conv in CONVS:
        _count(monkeypatch, calls, K, conv)
    _count(monkeypatch, calls, N, "channel_sum_sq", "k2_train")
    _count(monkeypatch, calls, T, "channel_sum_sq", "k2_fused")
    convs, k2_train, k2_fused = EXPECTED[name]
    with torch.no_grad():
        T.forward_train(spec, params, x, compute_dtype=torch.float32)
        assert calls == {**dict(zip(CONVS, convs)), "k2_train": k2_train}
        calls.clear()
        T.forward_fused(spec, params, x, compute_dtype=torch.float32, level0_only=True)
        assert calls == {**dict(zip(CONVS, convs)), "k2_fused": k2_fused}


@pytest.mark.parametrize("name", list(ARCHS))
def test_route_is_one_for_both_forwards(monkeypatch, name):
    """Both forwards ask ``_route`` about the same layers in the same order
    and get the same answers, and each kernel route is a shape
    ``kernel_takes`` accepts."""
    spec, params, x = _setup(name)
    seen = []
    route = T._route

    def recorded(layer, c, dhw, pair=False):
        r = route(layer, c, dhw, pair)
        seen.append((layer, c, tuple(dhw), pair, r))
        return r

    monkeypatch.setattr(T, "_route", recorded)
    with torch.no_grad():
        T.forward_train(spec, params, x, compute_dtype=torch.float32)
        train = list(seen)
        seen.clear()
        T.forward_fused(spec, params, x, compute_dtype=torch.float32)
    # the training forward's level-0 ks1 head is its matmul, asked nothing
    assert [s for s in seen if s[0] is not spec.heads[0][0]] == train
    routes = [(layer, c, r) for layer, c, _, _, r in train if r]
    assert {r for _, _, r in routes} == {"entry", "s1", "dual", "s2", "trans", "norm"}
    for layer, c, r in routes:
        assert K.kernel_takes(r, c, layer.out_c), (r, c, layer)


def test_kernel_takes_matches_tile_tables():
    """The stride-2 and transposed shapes ``kernel_takes`` accepts are
    exactly the tile tables the kernels are built for; K1's are the
    C -> C and 1 -> C of ``KERNEL_CHANNELS``."""
    chans = range(1, 321)

    def taken(op):
        return {(ci, co) for ci in chans for co in chans if K.kernel_takes(op, ci, co)}

    assert taken("s2") == set(L.S2_PAIRS)
    assert taken("trans") == set(L.TRANS_PAIRS)
    assert taken("s1") == taken("dual") == {(c, c) for c in K.KERNEL_CHANNELS}
    assert taken("entry") == {(1, c) for c in K.KERNEL_CHANNELS}
    assert {c for c in chans if K.kernel_takes("norm", c, c)} == set(K.KERNEL_CHANNELS)
