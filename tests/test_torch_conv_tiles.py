"""The operand layouts of the bf16 tensor-core conv kernels
(``unet_studio_tpu_torch/ops/tc_layout.py``), on the CPU in f32: what the
wrappers build before a launch, read back as ``mma.m16n8k16`` reads it,
through a plain im2col GEMM in the kernels' K order, against the convs'
twins.  The kernels themselves run in tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_studio_tpu_torch.ops import conv as K
from unet_studio_tpu_torch.ops import tc_layout as L

TOL = 1e-5  # f32 GEMM vs f32 conv: the order of the sums differs


def _t(rng, shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def fragment_matrix(packed: torch.Tensor) -> torch.Tensor:
    """(K, N) B as the kernels read ``pack_b``'s layout: lane l of k-step
    ks loads 8 values per pair of n-tiles, registers b0, b1 of n-tile 2p
    then of 2p+1; b0 holds B[2(l%4) + h][l//4], b1 B[2(l%4) + 8 + h][l//4]."""
    nks, npair = packed.shape[:2]
    out = torch.full((nks, 16, 16 * npair), float("nan"))  # (k-step, k in step, n)
    for p in range(npair):
        for lane in range(32):
            for reg in range(4):
                nt, row8 = 2 * p + reg // 2, 8 * (reg % 2)
                for h in range(2):
                    out[:, 2 * (lane % 4) + row8 + h, 8 * nt + lane // 4] = \
                        packed[:, p, lane, 2 * reg + h]
    return out.reshape(16 * nks, 16 * npair)


def im2col_s1(xs, prologues):
    """(voxels, K) of a pad-1 3^3 conv, K in the kernels' (source, tap,
    channel) order, each input after its prologue."""
    cols = []
    for x, p in zip(xs, prologues):
        d, h, w, _ = x.shape
        xp = F.pad(K.apply_prologue(x, p), (0, 0, 1, 1, 1, 1, 1, 1))
        for kz in range(3):
            for ky in range(3):
                for kx in range(3):
                    cols.append(xp[kz:kz + d, ky:ky + h, kx:kx + w].reshape(d * h * w, -1))
    return torch.cat(cols, 1)


@pytest.mark.parametrize("k,n", [(16, 16), (432, 32), (32, 64), (64, 128)])
def test_pack_b_is_the_mma_fragment_order(k, n):
    wm = _t(np.random.default_rng(k + n), (k, n))
    packed = L.pack_b(wm)
    assert packed.shape == (k // 16, n // 16, 32, 8) and packed.is_contiguous()
    assert torch.equal(fragment_matrix(packed), wm)


def test_pack_b_rejects_ragged():
    with pytest.raises(ValueError):
        L.pack_b(torch.zeros(27, 16))


@pytest.mark.parametrize("kind,c,act", [("s1", 16, "leaky_relu"), ("s1", 32, "relu"),
                                        ("s1", 64, None), ("dual", 16, "leaky_relu"),
                                        ("dual", 32, None), ("dx", 16, None), ("dx", 64, None)])
def test_k1_gemm_equals_the_twin(kind, c, act):
    """A GEMM over the packed weights in the (source, tap, channel) K
    order equals conv3_plain; dx packs the flipped, transposed weights."""
    rng = np.random.default_rng(c)
    dims = (3, 5, 6)
    nsrc = 2 if kind == "dual" else 1
    xs = [_t(rng, (*dims, c)) for _ in range(nsrc)]
    w = _t(rng, (c, nsrc * c, 3, 3, 3), 0.1)
    b = _t(rng, c)
    pros = [None if act is None else (_t(rng, c, 0.3) + 1.0, _t(rng, c, 0.3), act)
            for _ in xs]
    if kind == "dx":
        w, b = K.flip_transpose(w), torch.zeros(c)
    wm = L.k1_weight_matrix(w, nsrc)
    assert wm.shape == (nsrc * 27 * c, c)
    y = im2col_s1(xs, pros) @ fragment_matrix(L.pack_b(wm)) + b
    ref = K.conv3_plain(xs, pros, w, b, 1)
    assert _rel(y.reshape(ref.shape), ref) < TOL


def test_entry_gemm_equals_the_twin():
    """K = the 27 taps padded to 32 with zero rows."""
    rng = np.random.default_rng(1)
    x, w, b = _t(rng, (4, 5, 7, 1)), _t(rng, (16, 1, 3, 3, 3), 0.3), _t(rng, 16)
    wm = L.entry_weight_matrix(w)
    assert wm.shape == (32, 16) and not wm[27:].any()
    a = F.pad(im2col_s1([x], [None]), (0, 5))
    y = a @ fragment_matrix(L.pack_b(wm)) + b
    ref = K.conv3_plain([x], [None], w, b, 1)
    assert _rel(y.reshape(ref.shape), ref) < TOL


def test_s2dx_taps_partition_the_kernel():
    """8 classes of 1, 2, 2, 4, 2, 4, 4, 8 taps, each of the 27 taps once;
    an even dx coordinate reads tap 1 at offset 0, an odd one tap 2 at
    offset 0 and tap 0 at offset 1."""
    taps = L.s2dx_taps()
    counts = [sum(1 for p, _, _ in taps if p == q) for q in range(8)]
    assert counts == [1, 2, 2, 4, 2, 4, 4, 8]
    assert sorted(k for _, _, k in taps) == [(z, y, x) for z in range(3) for y in range(3)
                                             for x in range(3)]
    assert [p for p, _, _ in taps] == sorted(p for p, _, _ in taps)
    for p, off, k in taps:
        for axis, (o, kk) in enumerate(zip(off, k)):
            parity = (p >> (2 - axis)) & 1
            assert (o, kk) in (((0, 1),) if parity == 0 else ((0, 2), (1, 0)))


@pytest.mark.parametrize("ci,co,half", [(16, 32, (3, 4, 5)), (32, 64, (2, 3, 2)),
                                        (64, 128, (1, 2, 3))])
def test_s2dx_class_gemms_equal_the_twin(ci, co, half):
    """One GEMM per parity class over the packed weights, g past the high
    end read as 0, scattered to dx[2q + parity], equals conv3_s2_dx_plain."""
    rng = np.random.default_rng(ci)
    g, w = _t(rng, (*half, co)), _t(rng, (co, ci, 3, 3, 3), 0.1)
    wm = fragment_matrix(L.pack_b(L.s2dx_weight_matrix(w)))
    assert wm.shape == (27 * co, ci)
    od, oh, ow = half
    gp = F.pad(g, (0, 0, 0, 1, 0, 1, 0, 1))
    dx = torch.zeros((2 * od, 2 * oh, 2 * ow, ci))
    taps = L.s2dx_taps()
    for p in range(8):
        rows = [i for i, t in enumerate(taps) if t[0] == p]
        a = torch.cat([gp[oz:oz + od, oy:oy + oh, ox:ox + ow].reshape(-1, co)
                       for _, (oz, oy, ox), _ in (taps[i] for i in rows)], 1)
        bm = torch.cat([wm[i * co:(i + 1) * co] for i in rows])
        pz, py, px = p >> 2, (p >> 1) & 1, p & 1
        dx[pz::2, py::2, px::2] = (a @ bm).reshape(od, oh, ow, ci)
    assert _rel(dx, K.conv3_s2_dx_plain(g, w)) < TOL


@pytest.mark.parametrize("layout,shape", [("k1", (16, 16, 3, 3, 3)), ("k1", (64, 64, 3, 3, 3)),
                                          ("k1_dual", (32, 64, 3, 3, 3)),
                                          ("entry", (16, 1, 3, 3, 3)),
                                          ("s2dx", (32, 16, 3, 3, 3)),
                                          ("s2dx", (128, 64, 3, 3, 3))])
def test_pack_weights_is_one_gather_of_pack_b(layout, shape):
    """The wrappers' cached-index gather equals building B and packing it,
    bit for bit, on a strided view too (dx packs flip_transpose(w))."""
    w = _t(np.random.default_rng(len(shape)), shape).to(torch.bfloat16)
    assert torch.equal(L.pack_weights(w, layout), L.pack_b(L.LAYOUTS[layout](w)))
    if layout == "k1":
        wt = K.flip_transpose(w)
        assert torch.equal(L.pack_weights(wt, layout), L.pack_b(L.k1_weight_matrix(wt)))
