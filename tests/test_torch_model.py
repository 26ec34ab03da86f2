"""The port's U-Net forward against the JAX package's, on the CPU.

The same seeded weights (``init_params`` draws identically in both
packages) and the same numpy input go through the JAX forward (the XLA
route, ``compute_dtype=float32``, the exact oracle on the CPU) and
through the port's plain forward and its fused forward (deferred
instance norm, the kernels' twins on the CPU).  The JAX package's own
packed route is held to its XLA route by tests/test_norm_fusion.py, and
each twin to its Pallas kernel by tests/test_torch_kernels.py.  Tolerance: max-abs error
over the reference's max-abs < 1e-4 on every level (f32 throughout).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_studio_tpu.models import unet3d as J
from unet_studio_tpu_torch.models import unet3d as T
from unet_studio_tpu_torch.models.dsl import default_architecture, parse_architecture
from unet_studio_tpu_torch.models.serialize import from_jax_params
from torch_one_thread import one_thread  # noqa: F401  (autouse)

ARCH_PACKED = "\n".join(
    [
        "conv16,ks3,stride1+norm,leaky_relu+conv16,ks3,stride1+norm,leaky_relu",
        "conv32,ks3,stride2+norm,leaky_relu+conv32,ks3,stride1+norm,leaky_relu",
        "conv64,ks3,stride2+norm,leaky_relu+conv64,ks3,stride1+norm,leaky_relu"
        "+conv_trans32,ks2,stride2",
        "conv32,ks3,stride1+norm,leaky_relu+conv32,ks3,stride1+norm,leaky_relu"
        "+conv4,ks1,stride1+conv_trans16,ks2,stride2",
        "conv16,ks3,stride1+norm,leaky_relu+conv16,ks3,stride1+norm,leaky_relu"
        "+conv4,ks1,stride1",
    ]
)
SMALL_ARCH = "\n".join(
    [
        "conv8,ks3,stride1+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
        "conv16,ks3,stride1+norm,leaky_relu+conv4,ks1,stride1+conv_trans8,ks2,stride2",
        "conv8,ks3,stride1+norm,leaky_relu+conv4,ks1,stride1",
    ]
)
POOL_ARCH = "\n".join(
    [
        "conv8,ks3,stride1,relu",
        "max_pool+conv16,ks3,stride1+bnorm,elu",
        "max_pool+conv16,ks3,stride1+norm,leaky_relu+upsample+conv16,ks3,stride1",
        "conv16,ks3,stride1+norm,leaky_relu+conv4,ks1,stride1+upsample+conv8,ks3,stride1",
        "conv8,ks3,stride1+norm,leaky_relu+conv4,ks1,stride1",
    ]
)

CASES = {
    # name: (architecture, out_count, input (D, H, W))
    "packed": (ARCH_PACKED, 4, (8, 8, 64)),
    "small": (SMALL_ARCH, 4, (8, 8, 8)),
    "pool": (POOL_ARCH, 4, (8, 8, 8)),
    "flagship": (default_architecture(3), 3, (32, 32, 32)),
}


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-6))


def _setup(name, seed=3):
    arch, out_c, dhw = CASES[name]
    jm = J.UNet3d.create(1, out_c, arch, seed=seed)
    spec = parse_architecture(1, out_c, arch)
    params = {k: torch.from_numpy(v) for k, v in T.init_params(spec, seed).items()}
    x = np.random.default_rng(11).random((1, *dhw, 1), np.float32)
    return jm, spec, params, x


def test_init_params_match_jax_weights():
    """Both packages draw the same initial network from one seed."""
    jm, spec, params, _ = _setup("flagship")
    sd = from_jax_params(spec, jm.params)
    assert len(sd) == len(params)
    for name, _, which in T.param_order(spec):
        mod, i, _ = name.split(".")
        key = f"{mod}.{i}.{'weight' if which == 'w' else 'bias'}"
        np.testing.assert_array_equal(sd[key].numpy(), params[name].numpy(), err_msg=name)


def test_round_up_size_matches_jax():
    for shape in [(182, 218, 182), (1, 32, 33), (64, 64, 64)]:
        for multiple in (16, 32):
            assert T.round_up_size(shape, multiple) == J.round_up_size(shape, multiple)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    jm, spec, params, x = _setup(name)
    ref, _ = J.forward(jm.spec, jm.params, jnp.asarray(x), train=False,
                       state=jm.state, compute_dtype=jnp.float32)
    xt = torch.from_numpy(x)
    state = {k: torch.from_numpy(v) for k, v in T.init_state(spec).items()}
    with torch.no_grad():
        plain = T.forward(spec, params, xt, state=state, compute_dtype=torch.float32)
        fused = T.forward_fused(spec, params, xt, compute_dtype=torch.float32)
    assert len(plain) == len(fused) == len(ref)
    for lvl, r in enumerate(ref):
        if r is None:
            assert plain[lvl] is None and fused[lvl] is None
            continue
        assert plain[lvl].shape == r.shape == fused[lvl].shape
        assert _rel(plain[lvl].numpy(), r) < 1e-4, f"{name} plain level {lvl}"
        assert _rel(fused[lvl].numpy(), r) < 1e-4, f"{name} fused level {lvl}"


def test_level0_only_and_kernel_routing(monkeypatch):
    """The evaluate path's forward computes only the level-0 head, and on
    the flagship architecture routes every kernel-sized layer through a
    kernel wrapper: 1 entry, 3 stride-1 encoder + 3 decoder convs, 3 dual
    decoder entries, 3 stride-2 convs (64->128 included), 2 transposed
    convs and 3 K2 reductions (the dual convs' norm statistics)."""
    from unet_studio_tpu_torch.ops import conv as K
    from unet_studio_tpu_torch.ops import reduce as R

    _, spec, params, x = _setup("flagship")
    calls = {}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    for name in ("conv3x3x3_s1", "conv3x3x3_entry", "conv3x3x3_dual", "conv3x3x3_s2",
                 "conv_trans2x"):
        monkeypatch.setattr(K, name, counting(name, getattr(K, name)))
    monkeypatch.setattr(T, "channel_sum_sq", counting("channel_sum_sq", R.channel_sum_sq))
    with torch.no_grad():
        lvl0 = T.forward_fused(spec, params, torch.from_numpy(x),
                               compute_dtype=torch.float32, level0_only=True)
        full = T.forward_fused(spec, params, torch.from_numpy(x),
                               compute_dtype=torch.float32)
    assert all(r is None for r in lvl0[1:])
    torch.testing.assert_close(lvl0[0], full[0], rtol=0, atol=0)
    assert {k: v // 2 for k, v in calls.items()} == {
        "conv3x3x3_entry": 1, "conv3x3x3_s1": 6, "conv3x3x3_dual": 3,
        "conv3x3x3_s2": 3, "conv_trans2x": 2, "channel_sum_sq": 3,
    }
