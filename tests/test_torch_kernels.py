"""Each kernel twin of the port (K1-K4) against the JAX package's Pallas
function, run in interpret mode on the CPU, at tiny packable shapes.

The JAX functions take the lane-packed ``(D, H*nb, 128)`` view and
lane-tiled prologue vectors and return lane-wise statistics; the port
takes ``(D, H, W, C)`` with per-channel vectors and returns per-channel
statistics, so the test converts between the two.  Inputs come from a
seeded numpy generator.  Tolerance: max-abs error over the reference's
max-abs < 1e-4 (f32 throughout).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_studio_tpu.ops import packed as P
from unet_studio_tpu.ops import pallas_conv as PC
from unet_studio_tpu_torch.ops import conv as K
from unet_studio_tpu_torch.ops.reduce import channel_sum_sq


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-6))


def _fold(lane_vec, c):
    """(128,) lane-wise vector -> (C,) per channel."""
    return np.asarray(lane_vec).reshape(-1, c).sum(0)


def _case(seed, dims, ci, co, wshape="conv"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*dims, ci)).astype(np.float32)
    if wshape == "conv":
        w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)  # DHWIO
        wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    else:
        w = (rng.standard_normal((ci, 2, 2, 2, co)) * 0.2).astype(np.float32)
        wt = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 4, 1, 2, 3)))
    b = rng.standard_normal(co).astype(np.float32)
    a_p = (rng.random(ci) + 0.5).astype(np.float32)
    b_p = (rng.standard_normal(ci) * 0.5).astype(np.float32)
    return x, w, wt, b, a_p, b_p


def _jax_pro(a_p, b_p, act, c):
    bx = 128 // c
    return (jnp.asarray(np.tile(a_p, bx)), jnp.asarray(np.tile(b_p, bx)), act)


def _port_pro(a_p, b_p, act):
    return (torch.from_numpy(a_p), torch.from_numpy(b_p), act)


@pytest.mark.parametrize("act", [None, "leaky_relu"])
def test_k1_s1(act):
    """K1 C->C; ``act`` None runs without prologue and stats."""
    dims, c = (4, 8, 64), 16
    x, w, wt, b, a_p, b_p = _case(1, dims, c, c)
    pro = act is not None
    out = PC.conv_s1_packed(
        P.pack(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b), (*dims, c),
        prologue=_jax_pro(a_p, b_p, act, c) if pro else None, want_stats=pro,
    )
    got = K.conv3x3x3_s1(torch.from_numpy(x), wt, torch.from_numpy(b),
                         prologue=_port_pro(a_p, b_p, act) if pro else None, want_stats=pro)
    y_ref, y = (out[0], got[0]) if pro else (out, got)
    assert _rel(y.numpy(), P.unpack(y_ref, (*dims, c))) < 1e-4
    if pro:
        for r in range(2):
            assert _rel(got[1][r].numpy(), _fold(out[1][r], c)) < 1e-4


def test_k1_entry():
    dims, co = (4, 8, 64), 16
    x, w, wt, b, _, _ = _case(2, dims, 1, co)
    y3, st = P.conv_entry(jnp.asarray(x)[None], jnp.asarray(w), jnp.asarray(b), (*dims, 1),
                          want_stats=True)
    y, s = K.conv3x3x3_entry(torch.from_numpy(x), wt, torch.from_numpy(b), want_stats=True)
    assert _rel(y.numpy(), P.unpack(y3, (*dims, co))) < 1e-4
    for r in range(2):
        assert _rel(s[r].numpy(), _fold(st[r], co)) < 1e-4


def test_k1_dual():
    """The 2C->C decoder entry against JAX's two summed conv_s1_packed
    calls (the second with a zero bias), each half with its prologue."""
    dims, c = (4, 8, 64), 16
    xa, w, wt, b, a_p, b_p = _case(3, dims, 2 * c, c)
    xa, xb = np.ascontiguousarray(xa[..., :c]), np.ascontiguousarray(xa[..., c:])
    pa, pb = _jax_pro(a_p[:c], b_p[:c], "leaky_relu", c), _jax_pro(a_p[c:], b_p[c:], "relu", c)
    wj = jnp.asarray(w)
    ref = PC.conv_s1_packed(P.pack(jnp.asarray(xa)), wj[:, :, :, :c], jnp.asarray(b),
                            (*dims, c), prologue=pa)
    ref = ref + PC.conv_s1_packed(P.pack(jnp.asarray(xb)), wj[:, :, :, c:],
                                  jnp.zeros(c, jnp.float32), (*dims, c), prologue=pb)
    y = K.conv3x3x3_dual(torch.from_numpy(xa), torch.from_numpy(xb), wt, torch.from_numpy(b),
                         prologue_a=_port_pro(a_p[:c], b_p[:c], "leaky_relu"),
                         prologue_b=_port_pro(a_p[c:], b_p[c:], "relu"))
    assert _rel(y.numpy(), P.unpack(ref, (*dims, c))) < 1e-4


@pytest.mark.parametrize("dims,c", [((4, 8, 64), 16), ((4, 4, 16), 64)])
def test_k3_s2(dims, c):
    """K3 C->2C with prologue and stats; 64->128 is on the flagship path."""
    x, w, wt, b, a_p, b_p = _case(4, dims, c, 2 * c)
    y3, st = P.conv_s2_down(P.pack(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b), (*dims, c),
                            prologue=_jax_pro(a_p, b_p, "leaky_relu", c), want_stats=True)
    y, s = K.conv3x3x3_s2(torch.from_numpy(x), wt, torch.from_numpy(b),
                          prologue=_port_pro(a_p, b_p, "leaky_relu"), want_stats=True)
    odims = (dims[0] // 2, dims[1] // 2, dims[2] // 2, 2 * c)
    assert _rel(y.numpy(), P.unpack(y3, odims)) < 1e-4
    for r in range(2):
        assert _rel(s[r].numpy(), _fold(st[r], 2 * c)) < 1e-4


@pytest.mark.parametrize("ci,co", [(32, 16), (64, 32)])
def test_k4_trans(ci, co):
    dims = (2, 4, 32)
    x, w, wt, b, a_p, b_p = _case(5, dims, ci, co, wshape="trans")
    y3 = P.conv_trans2x_up(P.pack(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b), (*dims, ci),
                           prologue=_jax_pro(a_p, b_p, "leaky_relu", ci))
    y = K.conv_trans2x(torch.from_numpy(x), wt, torch.from_numpy(b),
                       prologue=_port_pro(a_p, b_p, "leaky_relu"))
    odims = (2 * dims[0], 2 * dims[1], 2 * dims[2], co)
    assert _rel(y.numpy(), P.unpack(y3, odims)) < 1e-4


def test_k2_sum_sq():
    c = 16
    x = np.random.default_rng(6).standard_normal((4, 8, 64, c)).astype(np.float32) + 0.3
    s, q = P.lane_sum_sq(P.pack(jnp.asarray(x)))
    got = channel_sum_sq(torch.from_numpy(x)).numpy()
    assert _rel(got[0], _fold(s, c)) < 1e-4
    assert _rel(got[1], _fold(q, c)) < 1e-4
