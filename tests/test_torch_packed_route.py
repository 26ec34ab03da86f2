"""The port's fused forward (deferred instance norm, the kernels' twins on
the CPU) against the JAX package's packed route with norm fusion
(``UNET_TPU_FORCE_PACKED=1``: its Pallas kernels in interpret mode), on
ARCH_PACKED at the smallest grid every level of it packs (8x8x64).
Both dataflows defer each norm into the next kernel's prologue and take
the decoder entries' statistics from a separate reduction, so this holds
the port's routing to JAX's layer by layer.  Tolerance: max-abs error
over the reference's max-abs < 1e-4 on every level (f32 throughout).
"""

import numpy as np
import torch

import jax.numpy as jnp

from unet_studio_tpu.models import unet3d as J
from unet_studio_tpu_torch.models import unet3d as T
from unet_studio_tpu_torch.models.dsl import parse_architecture

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


def test_fused_matches_jax_packed_route(monkeypatch):
    jm = J.UNet3d.create(1, 4, ARCH_PACKED, seed=3)
    spec = parse_architecture(1, 4, ARCH_PACKED)
    params = {k: torch.from_numpy(v) for k, v in T.init_params(spec, 3).items()}
    x = np.random.default_rng(11).random((1, 8, 8, 64, 1), np.float32)
    monkeypatch.setenv("UNET_TPU_FORCE_PACKED", "1")
    monkeypatch.delenv("UNET_TPU_NO_NORM_FUSION", raising=False)
    ref, _ = J.forward(jm.spec, jm.params, jnp.asarray(x), train=False,
                       compute_dtype=jnp.float32)
    with torch.no_grad():
        got = T.forward_fused(spec, params, torch.from_numpy(x), compute_dtype=torch.float32)
    assert len(got) == len(ref)
    for lvl, r in enumerate(ref):
        if r is None:
            assert got[lvl] is None
            continue
        r = np.asarray(r)
        assert got[lvl].shape == r.shape
        err = np.abs(got[lvl].numpy() - r).max() / max(np.abs(r).max(), 1e-6)
        assert err < 1e-4, f"level {lvl}: {err}"
