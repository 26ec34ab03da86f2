"""The operand layouts of the bf16 tensor-core conv kernels
(``unet_studio_tpu_torch/ops/tc_layout.py``), on the CPU in f32: what the
wrappers build before a launch, read back as ``mma.m16n8k16`` reads it,
through a plain im2col GEMM in the kernels' K order, against the convs'
twins; and K3's tile map (its parity-split halo, lane-level ldmatrix,
stats fold) replayed as the kernel runs it.  The kernels themselves run in
tests/test_torch_cuda_kernels.py.
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
                                          ("s2dx", (128, 64, 3, 3, 3)),
                                          ("k3", (32, 16, 3, 3, 3)),
                                          ("k3", (128, 64, 3, 3, 3))])
def test_pack_weights_is_one_gather_of_pack_b(layout, shape):
    """The wrappers' cached-index gather equals building B and packing it,
    bit for bit, on a strided view too (dx packs flip_transpose(w))."""
    w = _t(np.random.default_rng(len(shape)), shape).to(torch.bfloat16)
    assert torch.equal(L.pack_weights(w, layout), L.pack_b(L.LAYOUTS[layout](w)))
    if layout == "k1":
        wt = K.flip_transpose(w)
        assert torch.equal(L.pack_weights(wt, layout), L.pack_b(L.k1_weight_matrix(wt)))


# ---------------------------------------------------------------------------
# K3 (s2_tc_kernel): the stride-2 GEMM through the parity-split halo
# ---------------------------------------------------------------------------

LANE = torch.arange(32)


def k3_halo(xp: torch.Tensor, z0: int, y0: int, x0: int, ci: int) -> torch.Tensor:
    """(HV, Ci) halo of the K3 tile at output (z0, y0, x0), as the kernel
    stages it: row (hz, hy), slot sl holds input (2 z0 - 1 + hz, 2 y0 - 1 +
    hy, 2 x0 - 1 + s2_slot_x(sl)); ``xp`` is the input after its prologue,
    zero-padded by one voxel before and enough after."""
    tz, ty, _ = L.k3_tile(ci)
    hz, hy, hx = L.s2_halo(tz, ty)
    xs = torch.tensor([L.s2_slot_x(sl) for sl in range(hx)])
    rows = xp[2 * z0:2 * z0 + hz, 2 * y0:2 * y0 + hy]  # xp index = input index + 1
    return rows[:, :, 2 * x0 + xs].reshape(-1, xp.shape[-1])


def ldsm_a(phys: torch.Tensor, row: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """ldmatrix.x4 (not transposed) of one 16 x 16 A tile: lane l hands row
    ``row[l]``, logical chunk ``chunk[l]`` (read at its swizzled place);
    matrix j is lanes 8j..8j+7; a0..a3 = (rows 0-7, k 0-7), (rows 8-15, k
    0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)."""
    nc = phys.shape[1]
    lines = phys[row, L.swizzle(nc, row, chunk)]  # (32, 8)
    m = lines.reshape(4, 8, 8)
    return torch.cat([torch.cat([m[0], m[2]], 1), torch.cat([m[1], m[3]], 1)], 0)


def replay_k3(x, prologue, w, b, nblk: int = 3):
    """K3's output and stats as s2_tc_kernel computes them: per tile the
    parity-split halo stored swizzled, each row block's A gathered lane by
    lane at every (tap, chunk) k-step, B from ``pack_weights(w, "k3")`` in
    fragment order, per channel slice; the stats summed per warp over its
    valid rows in tile order, the warps in warp order, the blocks in
    order.  Returns (y f32, stats, per-block partial rows)."""
    d, h, wd, ci = x.shape
    co = w.shape[0]
    nb = L.k3_nb(co)
    tz, ty, tx = L.k3_tile(ci)
    mt_n = tz * ty // L.TC_WARPS
    od, oh, ow = d // 2, h // 2, wd // 2
    xp = F.pad(K.apply_prologue(x, prologue), (0, 0, 1, 2 * tx + 1, 1, 2 * ty + 1, 1, 2 * tz + 1))
    bm = fragment_matrix(L.pack_weights(w, "k3"))
    ksteps = 27 * (ci // 16)
    y = torch.zeros((od + tz, oh + ty, ow + tx, co))
    tiles = L.k3_tiles((od, oh, ow), ci)
    part = torch.zeros((nblk, 2, co))
    row16 = LANE & 15
    for blk in range(nblk):
        red = torch.zeros((L.TC_WARPS, 2, co))
        for z0, y0, x0 in tiles[blk::nblk]:
            phys = store_swizzled(k3_halo(xp, z0, y0, x0, ci).reshape(-1, ci // 8, 8))
            for warp in range(L.TC_WARPS):
                for mt in range(mt_n):
                    r = warp * mt_n + mt
                    acc = b.clone().expand(16, co).clone()
                    for ks in range(ksteps):
                        tap, chunk = divmod(ks, ci // 16)
                        rows = L.s2_row_base(r, tz, ty) + L.s2_tap_offset(tap, tz, ty) + row16
                        a = ldsm_a(phys, rows, chunk * 2 + (LANE >> 4))
                        for s in range(co // nb):
                            bs = bm[(s * ksteps + ks) * 16:(s * ksteps + ks + 1) * 16]
                            acc[:, s * nb:(s + 1) * nb] += a @ bs
                    oz, oy = z0 + r // ty, y0 + r % ty
                    y[oz, oy, x0:x0 + 16] = acc
                    ok = (oz < od) & (oy < oh) & (x0 + torch.arange(16) < ow)
                    v = acc[ok]
                    red[warp, 0] += v.sum(0)
                    red[warp, 1] += (v * v).sum(0)
        part[blk] = red[0] + red[1] + red[2] + red[3]  # warp order
    stats = part[0].clone()
    for blk in range(1, nblk):
        stats += part[blk]
    return y[:od, :oh, :ow], stats, part


def store_swizzled(rows: torch.Tensor) -> torch.Tensor:
    """(V, nc, 8) logical chunks -> shared memory as the kernel writes it:
    logical chunk c of row v at physical chunk swizzle(nc, v, c)."""
    v_n, nc, _ = rows.shape
    phys = torch.full_like(rows, float("nan"))
    v = torch.arange(v_n)[:, None]
    c = torch.arange(nc)[None, :]
    phys[v, L.swizzle(nc, v, c)] = rows
    return phys


@pytest.mark.parametrize("ci,co,dims,act", [(16, 32, (4, 10, 34), "leaky_relu"),
                                            (16, 32, (6, 8, 32), None),
                                            (32, 64, (2, 6, 6), "relu"),
                                            (64, 128, (4, 4, 18), "leaky_relu")])
def test_k3_gemm_through_the_map_equals_the_twin(ci, co, dims, act):
    """s2_tc_kernel's GEMM and stats through the tc_layout map (ragged
    tiles, prologue, Co = 128 in two slices) equal conv3_plain at stride 2."""
    rng = np.random.default_rng(ci + sum(dims))
    x, w, b = _t(rng, (*dims, ci)), _t(rng, (co, ci, 3, 3, 3), 0.1), _t(rng, co)
    pro = None if act is None else (_t(rng, ci, 0.3) + 1.0, _t(rng, ci, 0.3), act)
    y, stats, part = replay_k3(x, pro, w, b)
    ref, ref_stats = K.conv3_plain([x], [pro], w, b, 2, want_stats=True)
    assert y.shape == ref.shape == (dims[0] // 2, dims[1] // 2, dims[2] // 2, co)
    assert _rel(y, ref) < TOL
    assert _rel(stats, ref_stats) < TOL


def test_k3_stats_fold_equals_the_twin():
    """The block-ordered fold of the stats partials (any number of
    blocks; blocks without a tile give zero rows) equals _stats of the
    twin's f32 result, and each block's row is the sum over its tiles."""
    rng = np.random.default_rng(7)
    x, w, b = _t(rng, (6, 10, 36, 16)), _t(rng, (32, 16, 3, 3, 3), 0.1), _t(rng, 32)
    ref, ref_stats = K.conv3_plain([x], [None], w, b, 2, want_stats=True)
    n_tiles = len(L.k3_tiles(ref.shape[:3], 16))
    for nblk in (1, 4, n_tiles + 2):
        _, stats, part = replay_k3(x, None, w, b, nblk)
        assert _rel(stats, ref_stats) < TOL
        assert not part[n_tiles:].any()


@pytest.mark.parametrize("ci", [16, 32, 64])
def test_k3_ldmatrix_phases_hit_distinct_bank_groups(ci):
    """Each 8-lane phase of every A ldmatrix of s2_tc_kernel (every row
    block, tap and chunk) reads 8 distinct 16-byte bank groups: the
    parity-split halo makes a tap's rows consecutive slots."""
    tz, ty, _ = L.k3_tile(ci)
    nc = ci // 8
    row16 = LANE & 15
    for r in range(tz * ty):
        for tap in range(27):
            rows = L.s2_row_base(r, tz, ty) + L.s2_tap_offset(tap, tz, ty) + row16
            for chunk in range(ci // 16):
                c = chunk * 2 + (LANE >> 4)
                bank = ((rows * nc + L.swizzle(nc, rows, c)) % 8).tolist()
                for phase in range(4):
                    assert len(set(bank[8 * phase:8 * phase + 8])) == 8


def test_k3_halo_slots():
    """Slot m reads the even input x 2(x0 + m) (tap dx = 1); slots 16 + m
    and 17 + m the odd 2(x0 + m) - 1 and + 1 (taps 0 and 2): every output
    x of the tile reads input 2(x0 + m) + dx - 1 at tap dx."""
    for m in range(16):
        for dx in range(3):
            assert L.s2_slot_x(L.s2_slot(dx) + m) - 1 == 2 * m + dx - 1
    assert sorted(L.s2_slot_x(sl) for sl in range(L.S2_HX)) == list(range(L.S2_HX))
