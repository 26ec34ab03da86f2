"""The geometry of the bf16 tensor-core weight gradients K5 and K6
(``dw_tc_kernel`` and ``dw_s2_tc_kernel`` in
``unet_studio_tpu_torch/csrc/conv_tc.cu``), on the CPU in f32: the
tiles each block walks, the halo and a tap's voxel shift in it, the
chunk swizzle, the rows each lane hands ``ldmatrix.trans``,
the warps' jobs and the partial buffer, as ``ops/tc_layout.py`` gives
them, replayed as the kernel runs them (shared memory stored swizzled,
fragments gathered lane by lane and read back in the ``mma.m16n8k16``
layout), against ``conv_dw_plain``.  The kernel itself runs in
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_studio_tpu_torch.ops import conv as K
from unet_studio_tpu_torch.ops import tc_layout as L

TOL = 1e-5  # f32 sums in another order than the twin's matmuls


@pytest.fixture(autouse=True)
def _one_thread():
    """The replays run thousands of tiny matmuls: one intra-op thread each,
    so that a suite run with several workers does not oversubscribe the
    cores (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LANE = torch.arange(32)
GQ, TQ = LANE // 4, LANE % 4  # the mma's groupID and thread-in-group


def _t(rng, shape):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)


def store_swizzled(rows: torch.Tensor) -> torch.Tensor:
    """(V, nc, 8) logical chunks -> shared memory as the kernel writes it:
    logical chunk c of row v at physical chunk swizzle(nc, v, c)."""
    v_n, nc, _ = rows.shape
    phys = torch.full_like(rows, float("nan"))
    v = torch.arange(v_n)[:, None]
    c = torch.arange(nc)[None, :]
    phys[v, L.swizzle(nc, v, c)] = rows
    return phys


def ldsm_trans(phys: torch.Tensor, row: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """ldmatrix.x4.trans: lane l addresses row ``row[..., l]``, logical chunk
    ``chunk[..., l]`` (read at its swizzled place); matrix j is lanes 8j..8j+7;
    lane T receives, per matrix, elements (2(T%4), T//4) and (2(T%4)+1, T//4).
    Returns (..., 32 lanes, 4 registers, 2 values)."""
    nc = phys.shape[1]
    lines = phys[row, L.swizzle(nc, row, chunk)]  # (..., 32, 8)
    mats = lines.reshape(*lines.shape[:-2], 4, 8, 8)  # (..., matrix, row, col)
    out = torch.stack([mats[..., :, 2 * TQ + h, GQ] for h in range(2)], -1)  # (..., 4, 32, 2)
    return out.transpose(-3, -2)


def frag_a(regs: torch.Tensor) -> torch.Tensor:
    """(..., 32, 4, 2) A registers -> (..., 16 m, 16 k): a0 (g, 2t), a1
    (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8)."""
    a = torch.empty((*regs.shape[:-3], 16, 16))
    for reg, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for h in range(2):
            a[..., GQ + dm, 2 * TQ + dk + h] = regs[..., reg, h]
    return a


def frag_b(regs: torch.Tensor) -> torch.Tensor:
    """(32, 2, 2) b0, b1 of one n-tile -> (16 k, 8 n): b0 (2t, g), b1 (2t + 8, g)."""
    b = torch.empty((16, 8))
    for reg in range(2):
        for h in range(2):
            b[2 * TQ + 8 * reg + h, GQ] = regs[:, reg, h]
    return b


def replay_dw(x: torch.Tensor, g: torch.Tensor, n_sm: int = 2):
    """dW as the kernel computes it, per co slice and block, through the
    tc_layout map; returns (dW (27, Ci, Co), the partial buffer)."""
    dims, ci, co = tuple(x.shape[:3]), x.shape[-1], g.shape[-1]
    tz, ty, tx = L.dw_tile(ci)
    hz, hy, hx = L.dw_halo(ci)
    entry = ci == 1
    nblk = L.dw_blocks(dims, ci, co, n_sm)
    tiles = L.dw_tiles(dims, ci)
    assert len(tiles) == L.dw_ntiles(dims, ci)
    jobs = L.dw_jobs(ci)
    lanes = L.dw_lane_rows()
    # zero outside the volume, and past the ragged edge of the last tiles
    xp = F.pad(x, (0, 0, 1, tx + 1, 1, ty + 1, 1, tz + 1))
    gp = F.pad(g, (0, 0, 0, tx, 0, ty, 0, tz))
    part = torch.full(L.dw_partial_shape(nblk, ci, co), float("nan"))
    for s in range(co // L.DW_NB):
        for blk in range(nblk):
            acc = {w: torch.zeros((len(jobs), 16, 16)) for w in range(L.dw_warps(ci))}
            for z0, y0, x0 in tiles[blk::nblk]:
                halo = xp[z0:z0 + hz, y0:y0 + hy, x0:x0 + hx].reshape(-1, ci)
                gt = gp[z0:z0 + tz, y0:y0 + ty, x0:x0 + tx, s * 16:(s + 1) * 16]
                gs = store_swizzled(gt.reshape(-1, 2, 8))
                if entry:
                    # im2col: row m = the 27 taps of voxel m, then 5 zeros
                    m = torch.arange(tz * ty * tx)
                    base = torch.tensor([L.dw_krow_base(int(r), ci) for r in m // tx]) + m % tx
                    offs = torch.tensor([L.dw_tap_offset(t, ci) for t in range(27)])
                    cols = F.pad(halo[base[:, None] + offs[None, :], 0], (0, 5))
                    a_smem = store_swizzled(cols.reshape(-1, 4, 8))
                else:
                    a_smem = store_swizzled(halo.reshape(-1, ci // 8, 8))
                for w in range(L.dw_warps(ci)):
                    mine = L.dw_warp_jobs(ci, w)
                    for r in L.dw_warp_krows(ci, w):
                        vb = r * tx + lanes["b_row"]
                        breg = ldsm_trans(gs, vb, lanes["b_chunk"])
                        bm = torch.cat([frag_b(breg[:, 0:2]), frag_b(breg[:, 2:4])], 1)
                        jt = torch.tensor([jobs[j][0] for j in mine])[:, None]
                        jm = torch.tensor([jobs[j][1] for j in mine])[:, None]
                        if entry:
                            row = (r * tx + lanes["a_row"])[None].expand(len(mine), 32)
                        else:
                            off = torch.tensor([L.dw_tap_offset(int(t), ci) for t in jt[:, 0]])
                            row = L.dw_krow_base(r, ci) + off[:, None] + lanes["a_row"][None]
                        am = frag_a(ldsm_trans(a_smem, row, jm * 2 + lanes["a_chunk"][None]))
                        acc[w][mine] += am @ bm
            if entry:
                tot = sum(acc[w] for w in range(L.dw_warps(ci)))  # warp order
                part[blk, :, 0, s * 16:(s + 1) * 16] = torch.cat([tot[0], tot[1]])[:27]
            else:
                for w in range(L.dw_warps(ci)):
                    for j in L.dw_warp_jobs(ci, w):
                        tap, mt = jobs[j]
                        part[blk, tap, mt * 16:(mt + 1) * 16, s * 16:(s + 1) * 16] = acc[w][j]
    dw = part[0].clone()
    for blk in range(1, nblk):
        dw += part[blk]
    return dw, part


@pytest.mark.parametrize("ci,co", [(1, 16), (16, 16), (32, 32), (64, 64)])
@pytest.mark.parametrize("dims", [(5, 10, 14), (3, 5, 7), (2, 6, 17)])
def test_dw_gemm_through_the_map_equals_the_twin(ci, co, dims):
    rng = np.random.default_rng(ci + sum(dims))
    x, g = _t(rng, (*dims, ci)), _t(rng, (*dims, co))
    dw, part = replay_dw(x, g)
    assert not part.isnan().any()  # every block writes its whole slice
    ref = K.conv_dw_plain(x, g, 3, 1, 1)
    assert dw.shape == ref.shape == (27, ci, co)
    assert float((dw - ref).abs().max() / ref.abs().max()) < TOL


@pytest.mark.parametrize("ci", L.DW_CI)
def test_dw_warps_own_each_job_once(ci):
    """Each (job, k-row) of a tile falls to exactly one warp."""
    tz, ty, _ = L.dw_tile(ci)
    owned = sorted((j, r) for w in range(L.dw_warps(ci)) for j in L.dw_warp_jobs(ci, w)
                   for r in L.dw_warp_krows(ci, w))
    assert owned == [(j, r) for j in range(len(L.dw_jobs(ci))) for r in range(tz * ty)]
    if ci > 1:
        assert sorted(set(L.dw_jobs(ci))) == [(t, m) for t in range(27) for m in range(ci // 16)]


@pytest.mark.parametrize("ci", L.DW_CI)
def test_dw_ldmatrix_phases_hit_distinct_bank_groups(ci):
    """Each 8-lane phase of every ldmatrix (A at every tap's shift, B)
    reads 8 distinct 16-byte bank groups of a 128-byte line."""
    lanes = L.dw_lane_rows()
    tz, ty, tx = L.dw_tile(ci)

    def groups(row, chunk, nc):
        addr = row * nc * 16 + L.swizzle(nc, row, chunk) * 16
        return (addr // 16) % 8

    for r in range(tz * ty):
        for role, nc, taps in (("b", 2, [None]), ("a", 4 if ci == 1 else ci // 8,
                                                 [None] if ci == 1 else range(27))):
            for tap in taps:
                for mt in range(max(1, nc // 2)):
                    if role == "b":
                        row, chunk = r * tx + lanes["b_row"], lanes["b_chunk"]
                    elif tap is None:
                        row, chunk = r * tx + lanes["a_row"], 2 * mt + lanes["a_chunk"]
                    else:
                        row = L.dw_krow_base(r, ci) + L.dw_tap_offset(tap, ci) + lanes["a_row"]
                        chunk = 2 * mt + lanes["a_chunk"]
                    bank = groups(row, chunk, nc)
                    for phase in range(4):
                        assert len(set(bank[8 * phase:8 * phase + 8].tolist())) == 8


def test_dw_grid_and_partials():
    """One wave over the card, no more blocks than tiles; the partials are
    (nblk, 27, Ci, Co)."""
    dims = (192, 224, 192)
    assert L.dw_ntiles(dims, 16) == 96 * 28 * 12
    assert L.dw_blocks(dims, 16, 16, 132) == 3 * 132
    assert L.dw_blocks(dims, 64, 64, 132) == 132 // 4
    assert L.dw_blocks((2, 6, 17), 16, 16, 132) == 2
    assert L.dw_partial_shape(5, 32, 32) == (5, 27, 32, 32)


# ---------------------------------------------------------------------------
# K6 (dw_s2_tc_kernel): the stride-2 weight gradient through the same map
# ---------------------------------------------------------------------------


def s2_halo(xp: torch.Tensor, tile, tz: int, ty: int) -> torch.Tensor:
    """(HV, Ci) halo of the tile of g at (z0, y0, x0) as the kernel stages
    it, split by x parity: row (hz, hy), slot sl holds x at (2 z0 - 1 + hz,
    2 y0 - 1 + hy, 2 x0 - 1 + s2_slot_x(sl)); ``xp`` is x zero-padded by one
    voxel before and enough after."""
    z0, y0, x0 = tile
    hz, hy, hx = L.s2_halo(tz, ty)
    xs = torch.tensor([L.s2_slot_x(sl) for sl in range(hx)])
    return xp[2 * z0:2 * z0 + hz, 2 * y0:2 * y0 + hy][:, :, 2 * x0 + xs].reshape(-1, xp.shape[-1])


def replay_dw_s2(x: torch.Tensor, g: torch.Tensor, n_sm: int = 2):
    """K6's dW as dw_s2_tc_kernel computes it, per co slice of
    ``dw_nb(Ci, 2)`` channels and block, through the tc_layout map with
    stride 2; returns (dW (27, Ci, Co), the partial buffer)."""
    dims, ci, co = tuple(g.shape[:3]), x.shape[-1], g.shape[-1]
    nb = L.dw_nb(ci, 2)
    tz, ty, tx = L.dw_tile(ci, 2)
    nblk = L.dw_blocks(dims, ci, co, n_sm, 2)
    tiles = L.dw_tiles(dims, ci, 2)
    assert len(tiles) == L.dw_ntiles(dims, ci, 2)
    jobs = L.dw_jobs(ci)
    lanes = L.dw_lane_rows()
    xp = F.pad(x, (0, 0, 1, 2 * tx + 1, 1, 2 * ty + 1, 1, 2 * tz + 1))
    gp = F.pad(g, (0, 0, 0, tx, 0, ty, 0, tz))
    part = torch.full(L.dw_partial_shape(nblk, ci, co), float("nan"))
    for s in range(co // nb):
        for blk in range(nblk):
            acc = {w: torch.zeros((len(jobs), 16, nb)) for w in range(L.DW_WARPS)}
            for z0, y0, x0 in tiles[blk::nblk]:
                a_smem = store_swizzled(s2_halo(xp, (z0, y0, x0), tz, ty).reshape(-1, ci // 8, 8))
                gt = gp[z0:z0 + tz, y0:y0 + ty, x0:x0 + tx, s * nb:(s + 1) * nb]
                gs = store_swizzled(gt.reshape(-1, nb // 8, 8))
                for w in range(L.DW_WARPS):
                    mine = L.dw_warp_jobs(ci, w)
                    for r in L.dw_warp_krows(ci, w, 2):
                        vb = r * tx + lanes["b_row"]
                        bm = []
                        for q in range(nb // 16):  # one ldmatrix.x4.trans per two n-tiles
                            breg = ldsm_trans(gs, vb, 2 * q + lanes["b_chunk"])
                            bm += [frag_b(breg[:, 0:2]), frag_b(breg[:, 2:4])]
                        bm = torch.cat(bm, 1)
                        jt = torch.tensor([jobs[j][0] for j in mine])
                        jm = torch.tensor([jobs[j][1] for j in mine])[:, None]
                        off = torch.tensor([L.dw_tap_offset(int(t), ci, 2) for t in jt])
                        row = L.dw_krow_base(r, ci, 2) + off[:, None] + lanes["a_row"][None]
                        am = frag_a(ldsm_trans(a_smem, row, jm * 2 + lanes["a_chunk"][None]))
                        acc[w][mine] += am @ bm
            for w in range(L.DW_WARPS):
                for j in L.dw_warp_jobs(ci, w):
                    tap, mt = jobs[j]
                    part[blk, tap, mt * 16:(mt + 1) * 16, s * nb:(s + 1) * nb] = acc[w][j]
    dw = part[0].clone()
    for blk in range(1, nblk):
        dw += part[blk]
    return dw, part


@pytest.mark.parametrize("ci,co", [(16, 32), (32, 64), (64, 128)])
@pytest.mark.parametrize("half", [(3, 5, 7), (2, 6, 17), (1, 4, 16)])
def test_dw_s2_gemm_through_the_map_equals_the_twin(ci, co, half):
    rng = np.random.default_rng(ci + sum(half))
    x = _t(rng, (2 * half[0], 2 * half[1], 2 * half[2], ci))
    g = _t(rng, (*half, co))
    dw, part = replay_dw_s2(x, g)
    assert not part.isnan().any()  # every block writes its whole slice
    ref = K.conv_dw_plain(x, g, 3, 2, 1)
    assert dw.shape == ref.shape == (27, ci, co)
    assert float((dw - ref).abs().max() / ref.abs().max()) < TOL


@pytest.mark.parametrize("ci", [16, 32, 64])
def test_dw_s2_warps_own_each_job_once(ci):
    """Each (job, k-row) of a stride-2 tile falls to exactly one warp."""
    tz, ty, _ = L.dw_tile(ci, 2)
    owned = sorted((j, r) for w in range(L.DW_WARPS) for j in L.dw_warp_jobs(ci, w)
                   for r in L.dw_warp_krows(ci, w, 2))
    assert owned == [(j, r) for j in range(len(L.dw_jobs(ci))) for r in range(tz * ty)]


@pytest.mark.parametrize("ci", [16, 32, 64])
def test_dw_s2_ldmatrix_phases_hit_distinct_bank_groups(ci):
    """Each 8-lane phase of every ldmatrix of dw_s2_tc_kernel (A at every
    tap's slot in the parity-split halo, B over the slice's chunks) reads
    8 distinct 16-byte bank groups."""
    lanes = L.dw_lane_rows()
    tz, ty, tx = L.dw_tile(ci, 2)
    nb = L.dw_nb(ci, 2)

    def groups(row, chunk, nc):
        return ((row * nc + L.swizzle(nc, row, chunk)) % 8).tolist()

    for r in range(tz * ty):
        reads = [(r * tx + lanes["b_row"], 2 * q + lanes["b_chunk"], nb // 8)
                 for q in range(nb // 16)]
        for tap in range(27):
            for mt in range(ci // 16):
                row = L.dw_krow_base(r, ci, 2) + L.dw_tap_offset(tap, ci, 2) + lanes["a_row"]
                reads.append((row, 2 * mt + lanes["a_chunk"], ci // 8))
        for row, chunk, nc in reads:
            bank = groups(row, chunk, nc)
            for phase in range(4):
                assert len(set(bank[8 * phase:8 * phase + 8])) == 8


def test_dw_s2_grid_and_partials():
    """One wave over the card (32-channel slices, 16 at Ci = 64), no more
    blocks than tiles, and at level 2 few enough that the (nblk, 27, Ci,
    Co) partials stay within half the bytes of x and g."""
    n_sm = 132
    assert L.dw_nb(16, 2) == L.dw_nb(32, 2) == 32 and L.dw_nb(64, 2) == 16
    assert L.dw_ntiles((96, 112, 96), 16, 2) == 48 * 28 * 6
    assert L.dw_blocks((96, 112, 96), 16, 32, n_sm, 2) == 2 * n_sm
    assert L.dw_blocks((48, 56, 48), 32, 64, n_sm, 2) == n_sm // 2
    lvl2 = L.dw_blocks((24, 28, 24), 64, 128, n_sm, 2)
    in_bytes = 2 * (8 * 64 + 128) * 24 * 28 * 24
    assert 1 <= lvl2 <= n_sm // 8 and lvl2 * 27 * 64 * 128 * 4 <= in_bytes // 2
    assert L.dw_partial_shape(lvl2, 64, 128) == (lvl2, 27, 64, 128)
    assert L.dw_blocks((1, 4, 16), 32, 64, n_sm, 2) == 1
