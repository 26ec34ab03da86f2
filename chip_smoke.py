#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``unet_studio_tpu_torch``) on one NVIDIA
GPU and check it, phase by phase.  Any failed phase exits non-zero.

1. Device, ``nvidia-smi`` name and power limit, and the kernels' build
   from ``unet_studio_tpu_torch/csrc`` (nvcc, sm_90a), with ptxas's
   registers, shared memory and spills of the tensor-core kernels.
2. Each kernel wrapper against its plain PyTorch twin on the card at the
   flagship U-Net's shapes (``default_architecture(3)`` on the 192x224x192
   grid), in bf16 and in f32, with its time, the twin's, one PyTorch
   library call's and the least time the card could take.  bf16 K1, K3
   and K4 run on the tensor cores (``csrc/conv_tc.cu``,
   ``csrc/trans_tc.cu``); their uses are also timed at every kernel level
   (``tc_ms_c*``; K3 and K4 beside ``bound_ms_c*`` and their own device
   time ``device_ms_c*``) and in f32 on the FMA kernels (``f32_fma_ms``).
   Every wrapper that returns stats (K1 s1, the entry, K3) gives the same
   (y, stats) bits over two calls, in bf16 and in f32, and so does K4 its
   y.
3. The full-width forward through the kernels against the all-twin
   forward and the plain unfused forward (f32), and in bf16; its time,
   and its device time by kernel from ``torch.profiler``.
4. The evaluate engine on the repo's golden fixtures (f32), then the
   normal entry point: ``cli.main --action evaluate`` on a synthetic
   182x218x182 1 mm volume in bf16, with every forward kernel's launch
   count read around it; then three volumes through
   ``EvaluateEngine.run``, each stage timed alone, and the device's busy
   share of ``infer``.
5. Each backward kernel (K1 as dx, K5-K9, K2 ``norm_bwd``) against its
   twin at the flagship shapes, in bf16 and in f32, with its times and
   bound as in phase 2 (K1 dx, K5, K6, K7, K8 and K9 in bf16 on the
   tensor cores; K5, K6, K8 and K9 also per level (and K5 at the entry),
   ``tc_ms_c*``, ``tc_ms_entry``, beside ``bound_ms_*``, their own device
   time ``device_ms_*`` and their f32 FMA route, ``f32_fma_ms``, and
   bitwise over two launches).
6. The train step (``build_train_step``) at full width on two items it
   synthesizes from synthetic phantoms (contrast simulation and the
   default augmentation, with rubber stamps): every gradient of an f32
   step through the kernels against the same step through the twins, on
   the same draws, read twice (a second run of the kernels' step must
   give the same gradients, bit for bit, so the same reading: the kernels
   sum in a fixed order, and cuDNN, which serves the C >= 128 levels, is
   asked for its deterministic algorithms there); the bf16
   step against the f32 one; three bf16 steps with the loss falling;
   the host syncs of one item's synthesis by source line (the warp
   wrappers make none: the step's labels are uint8, as TrainEngine hands
   them over); each kernel's launches in one step (counts set to 0 just
   before it; every bf16 K1, K3, K4, K5, K6, K7, K8 and K9 launch on the
   tensor cores, ``tc_launches``), the step's synthesis / forward /
   backward / optimizer split, its device busy share and top kernels, and
   its peak memory.
7. The augmentation's kernels against their twins at the flagship grid:
   the warp (K10-K12) in its image + label (uint8 and float labels) and
   linear modes, with and without the supercell window, over one
   default-options coordinate field, the linear warp at the stamp grid
   48x56x48, each with its own device time (``device_ms``) and the stamp
   grid's bound; K2's max, sum and sqdiff; one augmentation and one
   contrast simulation per item, timed.
   Every K2 row (phases 2, 5, 7) also gives ``device_ms``, the kernel's own
   time from ``torch.profiler``, and ``host_ms``, the wrapper's host time
   per call, beside the event-timed ``ms``, and checks that two calls
   give the same bits; K2's modes launched on two streams at once give
   the bits of one stream.
   (It runs before phase 6, so that the step's counted run covers these
   kernels.)
8. The CLI on the card: ``--action train`` on a synthetic BIDS directory
   with one 182x218x182 1 mm template (3 epochs of 2 items, the default
   augmentation, launches counted around it, every bf16 K1, K3, K4, K5,
   K6, K7, K8 and K9 launch on the tensor cores), its resume at epoch 3,
   ``--action evaluate`` with the final model; then the convergence
   check of tests/test_convergence.py (validation dice error down by more
   than 40 %, template dice above 0.8).
9. QC and the atlas through the CLI on the card, with phase 8's trained
   model and BIDS directory: ``--action qc`` in bf16 (K1-K4 launches
   counted around it, every bf16 launch on the tensor cores) and in f32,
   under cuDNN's deterministic algorithms; each run's voxel counts equal
   a host bincount of the loaded label, its wrong counts a host recount
   from the level-0 logits of the same pair, and bf16 is held to f32;
   then ``--action evaluate --template 0 --atlas ... --mosaic ...`` on a
   synthetic 182x218x182 tissue template with a 6-region atlas on a
   shifted 1.1 mm grid (the corrected atlas is written, the PNG's size is
   the mosaic's), and ``--template 7`` returns 1.  Prints ``cli_qc``
   (seconds per pair, split into load and device; the wrong ratios) and
   ``cli_atlas`` (resample, fill, mosaic seconds).

TF32 is switched off for cuDNN and matmuls, so every f32 comparison is
f32 (cuDNN runs f32 convolutions in TF32 by default).

    python3 chip_smoke.py

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds one JSON object with every kernel's numbers (``launches``: per
train step of two items; ``launches_evaluate``: in the CLI evaluate
run, forward kernels; ``launches_cli_train``: in the CLI train run;
``launches_cli_qc``: in the CLI bf16 QC run).  The card's peaks come from
``unet_studio_tpu_torch/utils/flops.chip_peaks``; a card it does not know
fails the run.
K2's sum and sqdiff modes have no caller on any path, as in the JAX
package: their launches read 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# the card's published HBM bytes/s and dense bf16 tensor-core FLOP/s, set
# in main() from unet_studio_tpu_torch/utils/flops.chip_peaks
HBM_BYTES_PER_S = None
BF16_TENSOR_FLOPS = None
F32_FLOPS = 67e12  # f32 outside the tensor cores

# bf16 output of kernel vs twin on the same bf16 inputs: both accumulate in
# f32 and round once, so they differ by at most about one bf16 ulp (2^-8
# relative) of the largest value, plus f32 summation order
BF16_TOL = 8e-3
# f32 with TF32 off: the two sides differ only in the order of f32 sums
F32_TOL = 1e-4
# stats epilogue: atomics change the summation order run to run; mean and
# rms per channel must agree to this fraction of the largest rms
STATS_TOL = 1e-4
# full-width forward: f32 kernel path vs f32 twin/plain references after
# 25 layers and 10 instance norms, whose E[x^2]-mean^2 statistics from
# 8M-voxel sums magnify the order-of-summation differences
FWD_F32_TOL = 1e-3
# bf16 kernel path vs the f32 reference: the JAX package's bf16 packed
# forward sits at 0.0179 from its XLA forward on the same flagship
# network (BENCH_r05.json, under bench.py's gate of 0.05); this bound
# leaves the port less room than that gate
FWD_BF16_TOL = 0.03
LABEL_AGREE = 0.99
# f32 weight gradients and K2 norm_bwd sums (any input dtype): the kernel
# and the twin sum over up to 8M voxels in f32 in different orders
SUM_TOL = 1e-4
# full-width train step, f32, kernels vs twins, over every gradient of the
# network: the L2 error relative to the twins' gradient, and each
# tensor's max error over the network's largest gradient.  The forward
# alone sits near 3e-5 (phase 3); the backward adds 26 weight
# gradients summed over up to 8M voxels and the instance norms' backward
STEP_F32_TOL = 1e-3
# bf16 step vs f32 step: the loss (relative), and the gradient's L2 error
# relative to the f32 one.  bf16 rounds every activation and cotangent to
# 8 mantissa bits through some 50 layers, and the small gradients of the
# deep levels and of the biases ahead of each norm (zero in exact
# arithmetic) are mostly that rounding; the gate asks that the gradient
# point the same way (L2 0.2 is a cosine above 0.98) and that the loss,
# which training reads, agree closely
STEP_BF16_LOSS_TOL = 2e-2
STEP_BF16_GRAD_TOL = 0.2
# K2 modes the JAX package defines and never calls: ported, timed and
# checked, but no path launches them
OFF_PATH = ("channel_sum", "channel_sqdiff")
# QC in bf16 against QC in f32 on the same pair: the overall wrong ratio
# (absolute), and each class's wrong count over that class's voxels
QC_RATIO_TOL = 0.01
QC_CLASS_TOL = 0.01


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:.1f}s] {msg}", flush=True)


T0 = time.perf_counter()


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 5):
    """Mean device time per call of the kernels whose name holds
    ``kernel`` ("": every kernel ``fn`` launches) over ``reps`` calls after
    a warm-up (torch.profiler, CUPTI): the kernels' own time, without the
    host time between launches that ``timed_ms`` also sees."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key)
    return total / 1e3 / reps if total > 0 else "not measured (no device time)"


def host_ms(fn, reps: int = 20) -> float:
    """Host time per call: the wall clock over back-to-back calls that do
    not wait for the card (their launches queue), a warm-up first."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e3


def host_syncs(fn) -> dict:
    """The operations of one call of ``fn`` that make the host wait for the
    card, counted by the source line that called them (torch's sync debug
    mode warns at each: an item, a copy to the host, a copy from pageable
    host memory, a data-dependent shape)."""
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            path = os.path.relpath(w.filename, root) if w.filename.startswith(root) else w.filename
            key = f"{path}:{w.lineno}"
            out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def repeatable(fn) -> bool:
    """Two calls give the same bits (K2, the dW kernels and the convs'
    stats sum in a fixed order); ``fn`` returns a tensor or a tuple."""
    import torch

    a, b = fn(), fn()
    if isinstance(a, tuple):
        return all(bool(torch.equal(u, v)) for u, v in zip(a, b))
    return bool(torch.equal(a, b))


def rel_err(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def abs_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def stats_err(st, ref, n: int) -> float:
    """Largest per-channel error of mean and rms, over the largest rms."""
    mean, rms = st[0] / n, (st[1] / n).clamp_min(0).sqrt()
    rmean, rrms = ref[0] / n, (ref[1] / n).clamp_min(0).sqrt()
    scale = float(rrms.max().clamp_min(1e-12))
    return max(float((mean - rmean).abs().max()), float((rms - rrms).abs().max())) / scale


def profile_forward(fn, top: int = 12, grad: bool = False, watch=()) -> dict:
    """Device time by kernel name over one call of ``fn`` (torch.profiler,
    CUPTI), and the device's busy share of the call's wall time.  Under
    ``no_grad`` unless ``grad``.  ``watch``: kernel template names whose
    device time and launches are summed over all their instances
    (``watch_ms``), in the list or not."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ctx = contextlib.nullcontext() if grad else torch.no_grad()
    with ctx, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the host ops that
        # launched them report the same time again
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key[:80]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        return {"device_time": "not measured (the profiler saw no device time)"}
    def base(k):  # "void name<...>(...)" -> "name"
        return k.split("(")[0].split("<")[0].split()[-1]

    watched = {w: [sum(ms for ms, _, k in rows if base(k) == w),
                   sum(n for _, n, k in rows if base(k) == w)] for w in watch}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "watch_ms_launches": watched,
            "top": [{"ms": ms, "count": n, "name": k} for ms, n, k in rows[:top]]}


class Failed(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def grad_errs(got: dict, ref: dict) -> tuple[float, float, str]:
    """(L2 error over the whole network relative to ``ref``'s L2 norm,
    the worst tensor's max error over ``ref``'s largest gradient, its
    name)."""
    largest = max(float(v.abs().max()) for v in ref.values())
    diff2 = sum(float((got[k].float() - r.float()).square().sum()) for k, r in ref.items())
    ref2 = sum(float(r.float().square().sum()) for r in ref.values())
    worst, name = max((float((got[k] - r).abs().max()) / largest, k) for k, r in ref.items())
    return (diff2 / ref2) ** 0.5, worst, name


def phantom_batch(dhw, n: int, gen, dev):
    """``n`` smooth synthetic heads on the (D, H, W) grid: (n, D, H, W, 1)
    f32 images and (n, D, H, W) labels (0 outside, 1 the shell, 2 the
    core), ellipsoids of random centre and radii, drawn from ``gen``."""
    import torch

    z, y, x = torch.meshgrid(*[torch.linspace(-1, 1, s, device=dev) for s in dhw],
                             indexing="ij")
    images, labels = [], []
    for _ in range(n):
        c = (torch.rand(3, generator=gen, device=dev) - 0.5) * 0.2
        r = torch.rand(3, generator=gen, device=dev) * 0.2 + 0.6
        f = torch.rand(3, generator=gen, device=dev) * 4 + 2
        d = ((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((x - c[2]) / r[2]) ** 2
        lab = (d < 1).long() + (d < 0.35).long()
        img = 0.3 * lab + 0.15 * torch.sin(f[0] * x + f[1] * y) * torch.cos(f[2] * z)
        images.append(img)
        labels.append(lab)
    return torch.stack(images)[..., None], torch.stack(labels)


def phase5_backward_kernels(records, record, rnd, nvox, shapes) -> None:
    """Each backward kernel against its twin at the flagship shapes (bf16
    and f32), timed at level 0/1 in bf16 beside its twin, one PyTorch
    library call and its bound."""
    import torch
    import torch.nn.functional as F

    from unet_studio_tpu_torch.ops import conv as K
    from unet_studio_tpu_torch.ops import reduce as R

    S0, S1, S2 = shapes
    S3 = tuple(s // 2 for s in S2)
    bwd_src = "unet_studio_tpu_torch/csrc/conv_bwd.cu"
    conv_bwd = torch.ops.aten.convolution_backward
    dtypes = ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32"))

    def lib_bwd(g, x, w, stride, pad, transposed, mask):
        """One cuDNN convolution_backward on NCDHW views of the volumes."""
        return lambda: conv_bwd(K.ncdhw(g), K.ncdhw(x), w, None, [stride] * 3, [pad] * 3,
                                [1] * 3, transposed, [0] * 3, 1, mask)

    # K1 as the stride-1 conv's input gradient (flipped, transposed weights)
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, tol, tag in dtypes:
            g, w = rnd((*dims, c), dtype), rnd((c, c, 3, 3, 3), scale=(27 * c) ** -0.5)
            zero = torch.zeros(c, device=g.device)
            dx = K.conv3x3x3_dx(g, w)
            e = rel_err(dx, K.conv3_plain([g], [None], K.flip_transpose(w), zero, 1))
            require(e < tol, f"conv3x3x3_dx C={c} {tag}: err {e}")
            errs[f"{tag}_rel_c{c}"] = e
            if dtype == torch.bfloat16:
                errs[f"tc_ms_c{c}"] = timed_ms(lambda: K.conv3x3x3_dx(g, w))
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(dx, K.conv3_plain([g], [None], K.flip_transpose(w),
                                                             zero, 1))
                ms = timed_ms(lambda: K.conv3x3x3_dx(g, w))
                g32 = g.float()
                fma = {"f32_fma_ms": timed_ms(lambda: K.conv3x3x3_dx(g32, w))}
                del g32
                plain_ms = timed_ms(lambda: K.conv3_plain([g], [None], K.flip_transpose(w),
                                                          zero, 1))
                lib_ms = timed_ms(lib_bwd(g, g, w.to(dtype), 1, 1, False, [True, False, False]))
                timing = (ms, plain_ms, lib_ms, 4 * c * nvox(dims), 2 * 27 * c * c * nvox(dims))
            del g, dx
    record("conv3x3x3_dx", "unet_studio_tpu_torch/csrc/conv_tc.cu",
           "unet_studio_tpu/ops/pallas_conv.py:766", K.conv3x3x3_dx, errs, *timing,
           BF16_TENSOR_FLOPS, fma)

    def dw_phase(name, wrapper, plain_fn, cases, replaces, lib_call, nbytes, ops, src=bwd_src,
                 tc=None):
        """dW kernel vs twin on each (A dims, CA, B dims, CB) case; the
        first case, in bf16, is the timed one.  ``tc``: the tensor-core
        kernel's name; bf16 runs on it, timed per case (``tc_ms_c*``,
        ``tc_ms_entry``, beside ``bound_ms_*``, and its own device time
        ``device_ms_*``, the ordered reduction apart) and checked bitwise
        over two launches; f32 runs on the FMA kernel, timed per case too
        (``f32_fma_ms_*``; the first case's is the row's ``f32_fma_ms``)."""
        errs, fma = {}, {}
        for i, (a_dims, ca, b_dims, cb) in enumerate(cases):
            for dtype, _, tag in dtypes:
                x, g = rnd((*a_dims, ca), dtype), rnd((*b_dims, cb), dtype)
                got, ref = wrapper(x, g), plain_fn(x, g)
                e = rel_err(got, ref)
                require(e < SUM_TOL, f"{name} {ca}->{cb} {tag}: err {e}")
                errs[f"{tag}_rel_{ca}_{cb}"] = e
                if tc:
                    # each level timed on its route (bf16: tensor cores, f32:
                    # FMA), beside its own bound
                    lvl = "entry" if ca == 1 else f"c{ca}"
                    key = "tc_ms_" if dtype == torch.bfloat16 else "f32_fma_ms_"
                    errs[key + lvl] = timed_ms(lambda: wrapper(x, g))
                if tc and dtype == torch.bfloat16:
                    require(repeatable(lambda: wrapper(x, g)), f"{name} {ca}->{cb} repeat")
                    errs["device_ms_" + lvl] = device_ms(lambda: wrapper(x, g), tc)
                    # ks^3 taps, each a GEMM over the voxels of the smaller
                    # volume (g's at stride 2, x's for the transposed conv)
                    nx, ng, taps = x.numel() // ca, g.numel() // cb, got[0, 0].numel()
                    errs["bound_ms_" + lvl] = max(
                        2 * (ca * nx + cb * ng) / HBM_BYTES_PER_S,
                        2 * taps * ca * cb * min(nx, ng) / BF16_TENSOR_FLOPS) * 1e3
                if i == 0 and dtype == torch.bfloat16:
                    errs["bf16_abs"] = abs_err(got, ref)
                    timing = (timed_ms(lambda: wrapper(x, g)), timed_ms(lambda: plain_fn(x, g)),
                              timed_ms(lib_call(x, g)), nbytes, ops)
                del x, g, got, ref
        if tc:
            fma["f32_fma_ms"] = errs["f32_fma_ms_c%d" % cases[0][1]]
        record(name, src, replaces, wrapper, errs, *timing, BF16_TENSOR_FLOPS, fma)

    def dw_plain(ks, stride, pad, swap=False):
        def fn(x, g):
            a, b = (g, x) if swap else (x, g)
            out = K.conv_dw_plain(a, b, ks, stride, pad)
            # (tap, CA, CB) -> (CB, CA, k, k, k): (Co, Ci, ...) for K5/K6,
            # and for K9 (A = g, B = x) the transposed conv's (Ci, Co, ...)
            return out.reshape(ks, ks, ks, a.shape[-1], b.shape[-1]).permute(4, 3, 0, 1, 2)
        return fn

    def weight(shape, like):
        return torch.empty(shape, device=like.device, dtype=like.dtype)

    # K5: stride 1, C->C at every kernel level and the entry's 1->16
    dw_phase("conv3x3x3_dw", K.conv3x3x3_dw, dw_plain(3, 1, 1),
             ((S0, 16, S0, 16), (S1, 32, S1, 32), (S2, 64, S2, 64), (S0, 1, S0, 16)),
             "unet_studio_tpu/ops/pallas_conv.py:583",
             lambda x, g: lib_bwd(g, x, weight((16, 16, 3, 3, 3), x), 1, 1, False,
                                  [False, True, False]),
             4 * 16 * nvox(S0), 2 * 27 * 16 * 16 * nvox(S0),
             src="unet_studio_tpu_torch/csrc/conv_tc.cu", tc="tc_kernel")
    # K6: stride 2, C -> 2C (64 -> 128 included)
    dw_phase("conv3x3x3_s2_dw", K.conv3x3x3_s2_dw, dw_plain(3, 2, 1),
             ((S0, 16, S1, 32), (S1, 32, S2, 64), (S2, 64, S3, 128)),
             "unet_studio_tpu/ops/packed.py:897",
             lambda x, g: lib_bwd(g, x, weight((32, 16, 3, 3, 3), x), 2, 1, False,
                                  [False, True, False]),
             2 * 16 * nvox(S0) + 2 * 32 * nvox(S1), 2 * 27 * 16 * 32 * nvox(S1),
             src="unet_studio_tpu_torch/csrc/conv_tc.cu", tc="dw_s2_tc_kernel")
    # K9: the transposed conv's dW, x at level l+1 (2C), g at level l (C);
    # its twin is the dW twin with A = g and B = x
    dw_phase("conv_trans2x_dw", K.conv_trans2x_dw, dw_plain(2, 2, 0, swap=True),
             ((S1, 32, S0, 16), (S2, 64, S1, 32)), "unet_studio_tpu/ops/packed.py:782",
             lambda x, g: lib_bwd(g, x, weight((32, 16, 2, 2, 2), x), 2, 0, True,
                                  [False, True, False]),
             2 * 16 * nvox(S0) + 2 * 32 * nvox(S1), 2 * 8 * 16 * 32 * nvox(S1),
             src="unet_studio_tpu_torch/csrc/trans_tc.cu", tc="dw_trans_tc_kernel")

    # K7: the stride-2 conv's dx, g at level l+1 (2C) -> dx at level l (C)
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        half = tuple(s // 2 for s in dims)
        for dtype, tol, tag in dtypes:
            g, w = rnd((*half, 2 * c), dtype), rnd((2 * c, c, 3, 3, 3), scale=(27 * c) ** -0.5)
            dx, ref = K.conv3x3x3_s2_dx(g, w), K.conv3_s2_dx_plain(g, w)
            e = rel_err(dx, ref)
            require(e < tol and dx.shape == (*dims, c), f"conv3x3x3_s2_dx C={c} {tag}: err {e}")
            errs[f"{tag}_rel_c{c}"] = e
            if dtype == torch.bfloat16:
                errs[f"tc_ms_c{c}"] = timed_ms(lambda: K.conv3x3x3_s2_dx(g, w))
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(dx, ref)
                ms = timed_ms(lambda: K.conv3x3x3_s2_dx(g, w))
                g32 = g.float()
                fma = {"f32_fma_ms": timed_ms(lambda: K.conv3x3x3_s2_dx(g32, w))}
                del g32
                plain_ms = timed_ms(lambda: K.conv3_s2_dx_plain(g, w))
                x = torch.empty((*dims, c), device=g.device, dtype=dtype)
                lib_ms = timed_ms(lib_bwd(g, x, w.to(dtype), 2, 1, False, [True, False, False]))
                timing = (ms, plain_ms, lib_ms, 2 * c * nvox(dims) + 2 * 2 * c * nvox(half),
                          2 * 27 * c * 2 * c * nvox(half))
                del x
            del g, dx, ref
    record("conv3x3x3_s2_dx", "unet_studio_tpu_torch/csrc/conv_tc.cu",
           "unet_studio_tpu/ops/packed.py:1008", K.conv3x3x3_s2_dx, errs, *timing,
           BF16_TENSOR_FLOPS, fma)

    # K8: the transposed conv's dx, g at level l (Co) -> dx at level l+1 (Ci =
    # 2 Co), 32 <- 16 and 64 <- 32; bf16 on the tensor cores, each pair timed
    # beside its bound and its own device time and checked bitwise over two
    # calls, f32 on the FMA kernel (``f32_fma_ms_c*``)
    errs = {}
    for dims, co in ((S0, 16), (S1, 32)):
        half, ci = tuple(s // 2 for s in dims), 2 * co
        nbytes, ops = 2 * co * nvox(dims) + 2 * ci * nvox(half), 2 * 8 * ci * co * nvox(half)
        for dtype, tol, tag in dtypes:
            g, w = rnd((*dims, co), dtype), rnd((ci, co, 2, 2, 2), scale=(8 * co) ** -0.5)
            dx, ref = K.conv_trans2x_dx(g, w), K.conv_trans2x_dx_plain(g, w)
            e = rel_err(dx, ref)
            require(e < tol and dx.shape == (*half, ci), f"conv_trans2x_dx Co={co} {tag}: {e}")
            errs[f"{tag}_rel_co{co}"] = e
            if dtype == torch.bfloat16:
                require(repeatable(lambda: K.conv_trans2x_dx(g, w)),
                        f"conv_trans2x_dx Co={co} bf16: dx differs over two calls")
                errs[f"tc_ms_c{ci}"] = timed_ms(lambda: K.conv_trans2x_dx(g, w))
                errs[f"device_ms_c{ci}"] = device_ms(lambda: K.conv_trans2x_dx(g, w),
                                                     "trans2x_dx_tc_kernel")
                errs[f"bound_ms_c{ci}"] = max(nbytes / HBM_BYTES_PER_S,
                                              ops / BF16_TENSOR_FLOPS) * 1e3
            else:
                errs[f"f32_fma_ms_c{ci}"] = timed_ms(lambda: K.conv_trans2x_dx(g, w))
            if co == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(dx, ref)
                plain_ms = timed_ms(lambda: K.conv_trans2x_dx_plain(g, w))
                gl, wl = K.ncdhw(g), w.to(dtype)
                lib_ms = timed_ms(lambda: F.conv3d(gl, wl, stride=2))
                timing = (errs["tc_ms_c32"], plain_ms, lib_ms, nbytes, ops)
            del g, dx, ref
    record("conv_trans2x_dx", "unet_studio_tpu_torch/csrc/trans_tc.cu",
           "unet_studio_tpu/ops/packed.py:768", K.conv_trans2x_dx, errs, *timing,
           BF16_TENSOR_FLOPS, {"f32_fma_ms": errs["f32_fma_ms_c32"]})

    # K2 norm_bwd: inputs of nonzero mean with g correlated with x, so
    # neither sum cancels and the gate measures the kernel's sums
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, _, tag in dtypes:
            x = rnd((*dims, c), dtype) + 0.25
            g = (0.5 * x.float() + rnd((*dims, c)) + 0.25).to(dtype)
            st, n = R.channel_sum_sq_plain(x), nvox(dims)
            mean = st[0] / n
            inv = torch.rsqrt((st[1] / n - mean * mean).clamp_min(0) + 1e-5)
            got, ref = R.norm_bwd_sums(g, x, mean, inv), R.norm_bwd_sums_plain(g, x, mean, inv)
            e = rel_err(got, ref)
            require(e < SUM_TOL, f"norm_bwd_sums C={c} {tag}: err {e}")
            require(repeatable(lambda: R.norm_bwd_sums(g, x, mean, inv)),
                    f"norm_bwd_sums C={c} {tag} repeat")
            errs[f"{tag}_rel_c{c}"] = e
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(got, ref)
                errs["device_ms"] = device_ms(lambda: R.norm_bwd_sums(g, x, mean, inv),
                                              "channel_reduce_kernel")
                errs["host_ms"] = host_ms(lambda: R.norm_bwd_sums(g, x, mean, inv))
                ms = timed_ms(lambda: R.norm_bwd_sums(g, x, mean, inv))
                plain_ms = timed_ms(lambda: R.norm_bwd_sums_plain(g, x, mean, inv))
                timing = (ms, plain_ms, None, 2 * 2 * c * n, 5 * c * n)
            del x, g
    record("norm_bwd_sums", "unet_studio_tpu_torch/csrc/reduce.cu",
           "unet_studio_tpu/ops/packed.py:1292", R.norm_bwd_sums, errs, *timing, F32_FLOPS)
    torch.cuda.empty_cache()


def stamp_seeds(options, seed: int, n: int) -> list:
    """``n`` (seed, seed_id) pairs whose items synthesize their background
    (rubber stamps, so the linear warp runs) under ``options``: the draws
    come from numpy generators, so the host finds them without the card."""
    from unet_studio_tpu_torch.engine.train import item_rng
    from unet_studio_tpu_torch.ops.augment import draw_augmentation
    from unet_studio_tpu_torch.ops.simulate import draw_simulation

    out = []
    for seed_id in range(1000):
        rng = item_rng(seed, seed_id)
        draw_simulation(rng, 3)
        d = draw_augmentation(options, (8, 8, 8), rng)
        if d.stamp and not d.zero_background:
            out.append((seed, seed_id))
            if len(out) == n:
                return out
    raise Failed("no item with rubber stamps in 1000 draws")


def phase6_train_step(records, arch: str, dev, card: str, dhw=None) -> None:
    """The train step at full width (the model's grid unless ``dhw``) on
    items it synthesizes from two phantoms (contrast simulation and the
    default augmentation, whose draws give both items rubber stamps):
    kernels vs twins (f32, the same draws on both sides), bf16 vs f32,
    three bf16 steps, launches, time split, busy share, peak memory."""
    import torch

    from unet_studio_tpu_torch.engine.optimizer import init_opt_state
    from unet_studio_tpu_torch.engine.train import TrainParam, build_train_step, item_rng
    from unet_studio_tpu_torch.models import unet3d as U
    from unet_studio_tpu_torch.ops import conv as K
    from unet_studio_tpu_torch.ops.augment import AugOptions

    model = U.UNet3d.create(1, 3, arch, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    images, labels = phantom_batch(dhw or model.dim_dhw, 2, gen, dev)
    # integer labels as uint8, as TrainEngine hands a batch to the step
    images, labels = images.clamp_min(0.0), labels.to(torch.uint8)
    opt = AugOptions()
    seeds = stamp_seeds(opt, 7, 2)
    step32, _ = build_train_step(model, TrainParam(batch_size=2, compute_dtype="float32",
                                                   options=opt), device=dev)
    step16, valid16 = build_train_step(model, TrainParam(batch_size=2, options=opt), device=dev)

    # (a) f32: the kernels' step against the twins' step, the synthesis's
    # warp kernels against their twins included.  The levels with C >= 128
    # run cuDNN on both sides, whose default backward algorithms sum with
    # atomics; asked for deterministic ones here, the reading depends only
    # on the inputs, and a second run must repeat it
    torch.backends.cudnn.deterministic = True
    g_k, m_k, loss_k = step32.grads(images, labels, seeds=seeds)
    g_t, m_t, loss_t = step32.grads(images, labels, seeds=seeds, plain=True)
    l2_a, worst_a, name_a = grad_errs(g_k, g_t)
    loss_a = abs(float(loss_k) - float(loss_t)) / abs(float(loss_t))
    # the reading again from a second run of the kernels' step: the same
    # number, since every kernel on the path sums in a fixed order
    g_k2, _, loss_k2 = step32.grads(images, labels, seeds=seeds)
    l2_again = grad_errs(g_k2, g_t)[0]
    same_grads = all(bool(torch.equal(g_k[k], g_k2[k])) for k in g_k)
    del g_t, g_k2
    torch.backends.cudnn.deterministic = False
    log(f"f32 step parity reading (gradient L2 vs twins): {l2_a!r}, again {l2_again!r}; "
        f"gradients bitwise equal: {same_grads}")
    # (b) bf16 against f32, both through the kernels
    g_b, m_b, loss_b = step16.grads(images, labels, seeds=seeds)
    l2_b, worst_b, name_b = grad_errs(g_b, g_k)
    loss_rel_b = abs(float(loss_b) - float(loss_k)) / abs(float(loss_k))
    del g_k, g_b
    parity = {"f32_kernels_vs_twins": {"grad_l2": l2_a, "grad_worst": worst_a,
                                       "worst_tensor": name_a, "loss_rel": loss_a,
                                       "grad_l2_second_run": l2_again,
                                       "grads_bitwise_equal": same_grads},
              "bf16_vs_f32": {"grad_l2": l2_b, "grad_worst": worst_b, "worst_tensor": name_b,
                              "loss_rel": loss_rel_b},
              "loss_f32": float(loss_k), "loss_bf16": float(loss_b), "item_seeds": seeds}
    print(json.dumps({"train_parity": parity}), flush=True)
    require(l2_a < STEP_F32_TOL and worst_a < STEP_F32_TOL and loss_a < STEP_F32_TOL,
            f"f32 train step, kernels vs twins: {parity['f32_kernels_vs_twins']}")
    require(loss_rel_b < STEP_BF16_LOSS_TOL and l2_b < STEP_BF16_GRAD_TOL,
            f"bf16 train step vs f32: {parity['bf16_vs_f32']}")
    require(l2_again == l2_a and same_grads and float(loss_k2) == float(loss_k),
            f"the f32 step's parity reading changed between two runs: {l2_a!r}, {l2_again!r}")
    torch.cuda.empty_cache()

    # the host syncs of one item's synthesis, by source line: the warp
    # wrapper must make none (its uint8 label needs no range check)
    syncs = host_syncs(lambda: step16.synthesize(images[0], labels[0], True,
                                                 item_rng(*seeds[0])))
    warp_syncs = sum(v for k, v in syncs.items() if k.startswith("unet_studio_tpu_torch/ops/warp"))
    print(json.dumps({"synthesize_host_syncs": {"count": sum(syncs.values()),
                                                "warp_wrappers": warp_syncs,
                                                "by_line": syncs}}), flush=True)
    require(warp_syncs == 0, f"the warp wrappers made {warp_syncs} host syncs in one item")

    # (c, d) three bf16 steps at lr 1e-2 on the same items; the first is
    # the counted run
    opt_state = init_opt_state(model.params())
    for _, w in records.values():
        w.launches = 0
        w.tc_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    split = {}
    t = time.perf_counter()
    opt_state, metrics, loss1 = step16(opt_state, images, labels, None, 1e-2, seeds=seeds,
                                       timings=split)
    torch.cuda.synchronize()
    split["step_s"] = time.perf_counter() - t
    for rec, w in records.values():
        rec["launches"] = w.launches
        if w in K.TC_WRAPPERS:
            rec["tc_launches"] = w.tc_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_item = {k: r["launches"] / images.shape[0] for k, (r, _) in records.items()}
    log("launches per train-step item: " + json.dumps(per_item))
    require(all(r["launches"] > 0 for k, (r, _) in records.items() if k not in OFF_PATH),
            "a kernel of the train step was not launched")
    tc = {k: r["tc_launches"] for k, (r, w) in records.items() if w in K.TC_WRAPPERS}
    log("tensor-core launches in the bf16 step: " + json.dumps(tc))
    require(all(v > 0 for v in tc.values())
            and all(tc[k] == records[k][0]["launches"] for k in tc),
            "a bf16 K1, K3, K4, K5, K6, K7, K8 or K9 launch of the train step missed the "
            "tensor cores")
    losses = [float(loss1)]
    step_profile = {}

    def second():
        nonlocal opt_state
        opt_state, _, loss = step16(opt_state, images, labels, None, 1e-2, seeds=seeds)
        losses.append(float(loss))

    step_profile = profile_forward(second, top=30, grad=True, watch=(
        "s2_tc_kernel", "dw_s2_tc_kernel", "conv3_tc_kernel", "entry_tc_kernel", "dw_tc_kernel",
        "dw_entry_tc_kernel", "s2dx_tc_kernel", "trans2x_tc_kernel", "dw_trans_tc_kernel",
        "dw_reduce_kernel", "channel_reduce_kernel", "trans2x_dx_tc_kernel", "warp_kernel",
        "warp_pack_kernel", "max_kernel"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    opt_state, _, loss3 = step16(opt_state, images, labels, None, 1e-2, seeds=seeds)
    torch.cuda.synchronize()
    step3_s = time.perf_counter() - t
    losses.append(float(loss3))
    _, _, loss_after = step16.grads(images, labels, seeds=seeds)
    losses.append(float(loss_after))
    val = valid16(images, labels)
    require(all(bool(torch.isfinite(v).all()) for v in (metrics, val)) and metrics.shape == (4,)
            and val.shape == (3,), "train metrics or validation losses")
    train = {"losses": losses, "level0_metrics_step1": metrics.tolist(),
             "valid_ce_dice_mse": val.tolist(), "step1_split_s": split, "step3_s": step3_s,
             "synth_share_step1": split["synth_s"] / split["step_s"],
             "peak_mem_gib": peak_gib, "card": card}
    print(json.dumps({"train_step": train}), flush=True)
    print(json.dumps({"train_profile": step_profile}), flush=True)
    require(all(np.isfinite(losses)), f"train losses {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall over three steps: {losses}")


def phase7_augmentation_kernels(record, rnd, dev, card: str, shape=(192, 224, 192)) -> None:
    """The augmentation's kernels at the flagship grid against their twins:
    the warp (K10-K12) in both modes and both semantics over the
    coordinate field of one default-options draw, the linear warp at the
    stamp grid too, and K2's max, sum and sqdiff; then one augmentation and
    one contrast simulation per item, timed, and the augmentation's device
    time by kernel."""
    import torch
    import torch.nn.functional as F

    from unet_studio_tpu_torch.ops import augment as A
    from unet_studio_tpu_torch.ops import reduce as R
    from unet_studio_tpu_torch.ops import resample as RS
    from unet_studio_tpu_torch.ops import simulate as SIM
    from unet_studio_tpu_torch.ops import warp as W

    n = shape[0] * shape[1] * shape[2]
    warp_src, red_src = "unet_studio_tpu_torch/csrc/warp.cu", "unet_studio_tpu_torch/csrc/reduce.cu"
    gen = torch.Generator(device=dev).manual_seed(11)
    images, labels = phantom_batch(shape, 1, gen, dev)
    img, lab = images[0, ..., 0].clamp_min(0.0).contiguous(), labels[0].float().contiguous()
    lab8 = labels[0].to(torch.uint8)  # the train path's label type (TrainEngine, synthesize)
    opt = A.AugOptions()
    draws = A.draw_augmentation(opt, shape, np.random.default_rng(3), device=dev)
    coords = A.warp_coords(draws, opt, shape, dev)
    require(A._supercell_warp_ok(opt, shape), "default options take the window")

    def lib_grid_sample(vol, c):
        """F.grid_sample, trilinear, align_corners: the coordinates
        normalized to [-1, 1] outside the timing."""
        scale = torch.tensor([2.0 / (s - 1) for s in vol.shape[::-1]], device=dev)
        grid = (c * scale - 1.0)[None]
        v = vol[None, None]
        return lambda: F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=True)

    # the fused image + label warp on the uint8 label: labels exactly, the
    # image to 1e-6 of its peak; the float label gives the same bits.  Timed
    # as the train path calls it (K2 max for the peak included); bytes: 12 of
    # coordinates, 4 of image, 1 of label and 8 of output per voxel
    errs, timing = {}, None
    for window in (True, False):
        ki, kl = W.warp_image_label(img, lab8, coords, window)
        ti, tl = W.warp_image_label_plain(img, lab, coords, window)
        fi, fl = W.warp_image_label(img, lab, coords, window)
        e = float((ki - ti).abs().max()) / float(ti.abs().max())
        tag = "window" if window else "cells"
        require(torch.equal(kl, tl) and e <= 1e-6, f"warp_image_label {tag}: labels equal "
                f"{torch.equal(kl, tl)}, image err {e}")
        require(torch.equal(fi, ki) and torch.equal(fl, kl),
                f"warp_image_label {tag}: the float label warps otherwise than the uint8 one")
        errs[f"{tag}_rel"] = e
        errs[f"{tag}_label_mismatch"] = int((kl != tl).sum())
        if window:
            errs["max_abs"] = float((ki - ti).abs().max())
            # the gathers alone, the packing pass alone, and every kernel
            # of the call (K2 max for the peak included)
            for key, kern in (("device_ms", "warp_kernel"),
                              ("device_ms_pack", "warp_pack_kernel"), ("device_ms_all", "")):
                errs[key] = device_ms(lambda: W.warp_image_label(img, lab8, coords, True), kern)
            timing = (timed_ms(lambda: W.warp_image_label(img, lab8, coords, True)),
                      timed_ms(lambda: W.warp_image_label_plain(img, lab, coords, True)), None,
                      25 * n, 200 * n)
        del ki, kl, ti, tl, fi, fl
    record("warp_image_label", warp_src, "unet_studio_tpu/ops/pallas_warp.py:415",
           W.warp_image_label, errs, *timing, F32_FLOPS)

    # the linear warp at the flagship grid (both semantics) and at the
    # stamp grid (48, 56, 48), with the window as the stamps take it; bytes:
    # 12 of coordinates, 4 of source and 4 of output per voxel
    errs, timing = {}, None
    low = tuple(s // 4 for s in shape)
    vol_low = img.reshape(low[0], 4, low[1], 4, low[2], 4).mean(dim=(1, 3, 5)).contiguous()
    stamp = A.affine_matrix(_f32v([10.0, -7.0, 4.0]), _f32v([1.0, -2.0, 0.5]),
                            _f32v([1.1, 0.9, 1.2]), shape)
    low_coords = (RS.apply_affine(RS.meshgrid_xyz(low, dev) * 4.0, stamp) * 0.25).contiguous()
    for tag, vol, c, window in (("window", img, coords, True), ("cells", img, coords, False),
                                ("stamp_grid", vol_low, low_coords, True)):
        kv, tv = W.warp_linear(vol, c, window), W.warp_linear_plain(vol, c, window)
        e = float((kv - tv).abs().max()) / float(tv.abs().max().clamp_min(1e-12))
        require(e <= 1e-6, f"warp_linear {tag}: err {e}")
        errs[f"{tag}_rel"] = e
        if tag == "window":
            errs["max_abs"] = float((kv - tv).abs().max())
            errs["device_ms"] = device_ms(lambda: W.warp_linear(img, coords, True), "warp_kernel")
            timing = (timed_ms(lambda: W.warp_linear(img, coords, True)),
                      timed_ms(lambda: W.warp_linear_plain(img, coords, True)),
                      timed_ms(lib_grid_sample(img, coords)), 20 * n, 45 * n)
        if tag == "stamp_grid":
            n_low = low[0] * low[1] * low[2]
            errs["stamp_grid_ms"] = timed_ms(lambda: W.warp_linear(vol_low, low_coords, True))
            errs["stamp_grid_device_ms"] = device_ms(
                lambda: W.warp_linear(vol_low, low_coords, True), "warp_kernel")
            errs["stamp_grid_bound_ms"] = max(20 * n_low / HBM_BYTES_PER_S,
                                              45 * n_low / F32_FLOPS) * 1e3
        del kv, tv
    record("warp_linear", warp_src, "unet_studio_tpu/ops/pallas_warp.py:415 (the linear "
           "tail of resample.py:576)", W.warp_linear, errs, *timing, F32_FLOPS)

    # K2 max over the image (exact, an all-negative volume gives 0)
    got, want = R.volume_max(img), R.volume_max_plain(img)
    neg = -img - 1.0
    require(float(got) == float(want) and float(R.volume_max(neg)) == 0.0,
            f"volume_max {float(got)} vs {float(want)}, all-negative {float(R.volume_max(neg))}")
    require(repeatable(lambda: R.volume_max(img)), "volume_max repeat")
    record("volume_max", red_src, "unet_studio_tpu/ops/packed.py:1364", R.volume_max,
           {"max_abs": abs(float(got) - float(want)), "all_negative": float(R.volume_max(neg)),
            "device_ms": device_ms(lambda: R.volume_max(img), "max_kernel"),
            "host_ms": host_ms(lambda: R.volume_max(img)),
            "library_device_ms": device_ms(lambda: torch.amax(img), ""),
            "library_host_ms": host_ms(lambda: torch.amax(img))},
           timed_ms(lambda: R.volume_max(img)), timed_ms(lambda: R.volume_max_plain(img)),
           timed_ms(lambda: torch.amax(img)), 4 * n, n, F32_FLOPS)
    del neg

    # K2 sum and sqdiff at level 0 (C = 16), bf16 and f32
    for name, wrapper, plain, lib, ops in (
            ("channel_sum", R.channel_sum, R.channel_sum_plain,
             lambda x, m: torch.sum(x, dim=(0, 1, 2)), 1),
            ("channel_sqdiff", R.channel_sqdiff, R.channel_sqdiff_plain, None, 3)):
        errs, timing = {}, None
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = rnd((*shape, 16), dtype) + 0.25
            m = R.channel_sum_plain(x) / n
            args = (x,) if name == "channel_sum" else (x, m)
            got, want = wrapper(*args), plain(*args)
            e = rel_err(got, want)
            require(e < SUM_TOL, f"{name} {tag}: err {e}")
            require(repeatable(lambda: wrapper(*args)), f"{name} {tag} repeat")
            errs[f"{tag}_rel"] = e
            if dtype == torch.bfloat16:
                errs["max_abs"] = abs_err(got, want)
                errs["device_ms"] = device_ms(lambda: wrapper(*args), "channel_reduce_kernel")
                errs["host_ms"] = host_ms(lambda: wrapper(*args))
                if lib is not None:
                    errs["library_device_ms"] = device_ms(lambda: lib(x, m), "")
                    errs["library_host_ms"] = host_ms(lambda: lib(x, m))
                timing = (timed_ms(lambda: wrapper(*args)), timed_ms(lambda: plain(*args)),
                          None if lib is None else timed_ms(lambda: lib(x, m)),
                          2 * 16 * n, ops * 16 * n)
            del x
        record(name, red_src, "unet_studio_tpu/ops/packed.py:1360" if name == "channel_sum"
               else "unet_studio_tpu/ops/packed.py:1378", wrapper, errs, *timing, F32_FLOPS)

    # K2 on two streams at once: each stream's results are the bits of the
    # same calls on one stream (every launch has its stream's ticket and
    # partials); level 0 in bf16, the image's max
    x = rnd((*shape, 16), torch.bfloat16) + 0.25
    gx = (0.5 * x.float() + rnd((*shape, 16)) + 0.25).to(torch.bfloat16)
    st = R.channel_sum_sq_plain(x)
    mean = st[0] / n
    inv = torch.rsqrt((st[1] / n - mean * mean).clamp_min(0) + 1e-5)

    def k2_calls(i):
        v = x if i == 0 else gx
        return [R.channel_sum_sq(v), R.channel_sum(v), R.channel_sqdiff(v, mean),
                R.norm_bwd_sums(gx if i == 0 else x, v, mean, inv), R.volume_max(img)]

    want = [k2_calls(i) for i in range(2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    for s_ in streams:
        s_.wait_stream(torch.cuda.current_stream(dev))
    got = [[], []]
    for _ in range(4):  # interleaved, so the two streams' launches overlap
        for i, s_ in enumerate(streams):
            with torch.cuda.stream(s_):
                got[i].append(k2_calls(i))
    torch.cuda.synchronize()
    mismatch = sum(not torch.equal(a, b) for i in range(2) for calls in got[i]
                   for a, b in zip(calls, want[i]))
    print(json.dumps({"k2_two_streams": {"calls_per_stream": 4 * len(want[0]),
                                         "mismatches": int(mismatch)}}), flush=True)
    require(mismatch == 0, f"K2 on two streams: {mismatch} results differ from one stream's")
    del x, gx, got, want

    # one augmentation and one contrast simulation of an item, host clock
    def wall_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    sim = SIM.draw_simulation(np.random.default_rng(4), 3)
    item = {"aug_ms": wall_ms(lambda: A.visual_perception_augmentation(
                img[..., None], lab8, draws, opt)),
            "sim_ms": wall_ms(lambda: SIM.simulate_modality_template(img, lab, 3, sim)),
            "card": card}
    print(json.dumps({"synthesis_per_item": item}), flush=True)
    print(json.dumps({"augmentation_profile": profile_forward(
        lambda: A.visual_perception_augmentation(img[..., None], lab8, draws, opt))}), flush=True)
    del images, labels, coords
    torch.cuda.empty_cache()


def run_cli(argv):
    """``cli.main(argv)`` with its standard output and error captured (and
    echoed): (rc, both outputs, seconds to the card's last result)."""
    import contextlib
    import io

    import torch

    from unet_studio_tpu_torch import cli

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    out = buf.getvalue()
    print(out, end="", flush=True)
    return rc, out, time.perf_counter() - t


def _f32v(v):
    import torch

    return torch.tensor(np.asarray(v, np.float32))


def phase8_cli(records, work: str, card: str, native=(182, 218, 182), dev="cuda") -> None:
    """The CLI on the card: --action train on a synthetic BIDS directory
    with one 182x218x182 1 mm template (3 epochs of 2 items, the default
    augmentation; launches counted around it), the resume, evaluate with
    the final model; then the convergence acceptance check of
    tests/test_convergence.py (16^3, its architecture and options, 45
    epochs)."""
    import torch

    from unet_studio_tpu_torch.data.bids import get_bids_pairs
    from unet_studio_tpu_torch.engine.evaluate import EvaluateEngine
    from unet_studio_tpu_torch.engine.train import TrainEngine, TrainParam
    from unet_studio_tpu_torch.io.nifti import canonicalize_lps, read_nifti, write_nifti
    from unet_studio_tpu_torch.models.unet3d import UNet3d
    from unet_studio_tpu_torch.ops import conv as K
    from unet_studio_tpu_torch.ops.augment import AugOptions

    bids = os.path.join(work, "bids")
    os.makedirs(bids, exist_ok=True)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, k, dtype=np.float32) for k in native],
                          indexing="ij")
    d = (z / 0.8) ** 2 + (y / 0.9) ** 2 + (x / 0.75) ** 2
    lab = (d < 1.0).astype(np.int16) + (d < 0.35).astype(np.int16)
    img = (lab > 0) * (0.5 + 0.2 * lab + 0.1 * np.sin(6 * x + 3 * y)).astype(np.float32)
    write_nifti(os.path.join(bids, "tpl-A_T1w.nii.gz"), img.astype(np.float32), is_mni=True)
    write_nifti(os.path.join(bids, "tpl-A_dseg.nii.gz"), lab, is_mni=True)
    model = os.path.join(work, "trained.nz")
    for f in (model, model + ".opt", model + ".final.nz", model + ".final.nz.final.nz"):
        if os.path.exists(f):
            os.remove(f)

    for _, w in records.values():
        w.launches = 0
        w.tc_launches = 0
    rc, out, train_s = run_cli(["--action", "train", "--model", model, "--bids", bids,
                                "--batch_size", "2", "--epoch", "3", "--device", dev])
    launches = {k: w.launches for k, (_, w) in records.items()}
    log(f"cli train rc={rc} in {train_s:.1f}s; launches: {json.dumps(launches)}")
    require(rc == 0 and f"save model to {model}.final.nz" in out, "cli train")
    require(all(v > 0 for k, v in launches.items() if k not in OFF_PATH),
            "a kernel of the CLI train path was not launched")
    for k, (rec, w) in records.items():
        rec["launches_cli_train"] = launches[k]
        if w in K.TC_WRAPPERS:
            rec["tc_launches_cli_train"] = w.tc_launches
    require(all(w.tc_launches == w.launches for _, w in records.values() if w in K.TC_WRAPPERS),
            "a bf16 K1, K3, K4, K5, K6, K7, K8 or K9 launch of the CLI train run missed the "
            "tensor cores")
    rc, out, resume_s = run_cli(["--action", "train", "--model", model + ".final.nz",
                                 "--bids", bids, "--batch_size", "2", "--epoch", "4",
                                 "--device", dev])
    require(rc == 0 and "starting epoch: 3" in out, "cli train resume at epoch 3")
    final = model + ".final.nz.final.nz"
    src = os.path.join(bids, "tpl-A_T1w.nii.gz")
    rc, out, eval_s = run_cli(["--action", "evaluate", "--model", final, "--source", src,
                               "--device", dev])
    require(rc == 0 and read_nifti(src + ".result.nii.gz").data.shape == native,
            "cli evaluate of the trained model")

    # convergence: tests/test_convergence.py on the card
    n = 16
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((xx - n / 2) ** 2 + (yy - n / 2) ** 2 + (zz - n / 2) ** 2)
    label = (r < n / 3).astype(np.float32)
    image = np.clip(1.0 - r / (n / 2), 0, 1).astype(np.float32) * (label > 0)
    cdir = os.path.join(work, "converge")
    os.makedirs(cdir, exist_ok=True)
    write_nifti(os.path.join(cdir, "tpl-A_T1w.nii.gz"), image, is_mni=True)
    write_nifti(os.path.join(cdir, "tpl-A_dseg.nii.gz"), label.astype(np.int16), is_mni=True)
    arch = "\n".join([
        "conv8,ks3,stride1+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
        "conv16,ks3,stride1+norm,leaky_relu+conv2,ks1,stride1+conv_trans8,ks2,stride2",
        "conv8,ks3,stride1+norm,leaky_relu+conv2,ks1,stride1",
    ])
    opts = AugOptions(cropping=0, truncation_z=0, downsample_x=0, downsample_y=0,
                      downsample_z=0, noise=0, ambient=0, diffuse=0, specular=0,
                      perspective=0.0, lens_distortion=0.0, distortion=0, zero_background=4,
                      rubber_stamping=0, perlin_texture=0)
    images, labels = get_bids_pairs(cdir)
    m = UNet3d.create(1, 2, arch, seed=0, device=dev)
    m.dim = (16, 16, 16)
    eng = TrainEngine(m, TrainParam(image_file_name=images, label_file_name=labels,
                                    batch_size=4, epoch=45, learning_rate=0.02, options=opts,
                                    compute_dtype="float32"), device=dev)
    eng.start()
    require(not eng.error_msg, f"convergence engine: {eng.error_msg}")
    t = time.perf_counter()
    for _ in range(45):
        eng.run_epoch()
    conv_s = time.perf_counter() - t
    eng.stop()
    dice_first, dice_last = m.testing_errors[1], m.testing_errors[-2]
    drop = 1.0 - dice_last / dice_first
    m.postproc = "softmax+argmax"
    case = next(iter(EvaluateEngine(m, compute_dtype=torch.float32, device=dev).run(
        [os.path.join(cdir, "tpl-A_T1w.nii.gz")])))
    gt = canonicalize_lps(read_nifti(os.path.join(cdir, "tpl-A_dseg.nii.gz"))).data > 0
    pred = case.label > 0
    dice = 2.0 * np.sum(pred & gt) / max(pred.sum() + gt.sum(), 1)
    cli_rec = {"train_3_epochs_s": train_s, "resume_1_epoch_s": resume_s, "evaluate_s": eval_s,
               "convergence": {"dice_error_first": dice_first, "dice_error_last": dice_last,
                               "drop": drop, "template_dice": float(dice),
                               "epochs_s": conv_s}, "card": card}
    print(json.dumps({"cli_train": cli_rec}), flush=True)
    require(drop > 0.4, f"validation dice error drop {drop}")
    require(dice > 0.8, f"trained-model template dice {dice}")


def _write_assets(work: str, native):
    """``<work>/atlas/human/human_tissue.nii.gz``: a synthetic 1 mm tissue
    template (tissues 1-4 and a CSF label 5 inside an ellipsoidal head) on
    the native grid; beside it ``regions_atlas.nii.gz``, 6 angular regions
    on a 1.1 mm grid shifted by a fraction of a voxel, so that the
    majority resample does work.  Returns the atlas path."""
    from unet_studio_tpu_torch.io.nifti import write_nifti

    d = os.path.join(work, "atlas", "human")
    os.makedirs(d, exist_ok=True)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, k, dtype=np.float32) for k in native],
                          indexing="ij")
    r = (z / 0.8) ** 2 + (y / 0.9) ** 2 + (x / 0.75) ** 2
    tissue = np.where(r < 1.0, 2, 0).astype(np.int16)  # gray matter
    tissue[r < 0.5] = 1  # white matter
    tissue[(r < 1.0) & (z < -0.45)] = 3  # cerebellar gray matter
    tissue[(x ** 2 + y ** 2 + z ** 2) < 0.02] = 4  # subcortical
    tissue[(r >= 0.9) & (r < 1.0) & (z >= -0.45)] = 5  # CSF, dropped on load
    write_nifti(os.path.join(d, "human_tissue.nii.gz"), tissue, (1.0, 1.0, 1.0), is_mni=True)
    shape = tuple(int(k / 1.1) for k in native)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, k, dtype=np.float32) for k in shape],
                          indexing="ij")
    inside = ((z / 0.8) ** 2 + (y / 0.9) ** 2 + (x / 0.75) ** 2) < 1.05
    sector = np.floor((np.arctan2(y, x) + np.pi) / (2 * np.pi / 6)).clip(0, 5)
    atlas = np.where(inside, 1 + sector, 0).astype(np.int16)
    aff = np.diag([1.1, 1.1, 1.1, 1.0])
    aff[:3, 3] = [-0.35, 0.45, 0.2]
    path = os.path.join(d, "regions_atlas.nii.gz")
    write_nifti(path, atlas, (1.1, 1.1, 1.1), aff, is_mni=True)
    return path


def phase9_qc_atlas(records, work: str, card: str, native=(182, 218, 182), dev="cuda") -> None:
    """QC and the atlas through the CLI on the card, with phase 8's trained
    model and BIDS directory (one 182x218x182 template): ``--action qc`` in
    bf16 (launches counted) and f32, each checked against host recounts and
    bf16 against f32; ``--action evaluate`` with ``--template 0 --atlas
    --mosaic``; ``--template 7`` refused."""
    import shutil
    import struct

    import torch

    from unet_studio_tpu_torch.data.bids import get_bids_pairs, load_pair_on_model_grid
    from unet_studio_tpu_torch.engine.atlas import AtlasParcellation
    from unet_studio_tpu_torch.engine.qc import host_counts, run_qc
    from unet_studio_tpu_torch.io.nifti import canonicalize_lps, read_nifti
    from unet_studio_tpu_torch.models.serialize import load_model
    from unet_studio_tpu_torch.models.unet3d import forward_fused
    from unet_studio_tpu_torch.ops import conv as K
    from unet_studio_tpu_torch.utils.mosaic import make_mosaic, save_mosaic_png

    bids = os.path.join(work, "bids")
    final = os.path.join(work, "trained.nz.final.nz.final.nz")
    src = os.path.join(bids, "tpl-A_T1w.nii.gz")
    # phase 8's evaluate wrote its result beside the template, where the
    # BIDS matching would take it for a second pair (as in the reference)
    if os.path.exists(src + ".result.nii.gz"):
        os.remove(src + ".result.nii.gz")
    images, labels = get_bids_pairs(bids)
    require(len(images) == 1, f"QC pairs {images}")
    report = final[: -len(".nz")] + ".error_report.tsv"
    forward_kernels = [k for k, (r, _) in records.items() if r.get("launches_evaluate")]
    model = load_model(final, device=dev)
    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the C >= 128 levels run cuDNN
    try:
        qc = {}
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            for _, w in records.values():
                w.launches = 0
                w.tc_launches = 0
            rc, out, cli_s = run_cli(["--action", "qc", "--model", final, "--bids", bids,
                                      "--device", dev, "--compute_dtype", dtype_name])
            require(rc == 0 and "QC report saved to" in out, f"cli qc {dtype_name}")
            with open(report) as f:
                rows = [line.rstrip("\n").split("\t") for line in f]
            require(len(rows) == 2 and rows[0] == ["image", "ground_truth", "wrong_ratio",
                                                   "wrong_ratio0", "wrong_ratio1",
                                                   "wrong_ratio2"]
                    and len(rows[1]) == 6 and not rows[1][2].startswith("error"),
                    f"cli qc {dtype_name} report {rows}")
            if dtype == torch.bfloat16:
                launches = {k: w.launches for k, (_, w) in records.items()}
                log(f"cli qc launches: {json.dumps(launches)}")
                require(all(launches[k] > 0 for k in forward_kernels),
                        "a K1-K4 kernel of the QC path was not launched")
                require(all(w.tc_launches == w.launches for _, w in records.values()
                            if w in K.TC_WRAPPERS),
                        "a bf16 K1, K3 or K4 launch of the CLI QC run missed the tensor cores")
                for k, (rec, w) in records.items():
                    rec["launches_cli_qc"] = launches[k]
                    if w in K.TC_WRAPPERS:
                        rec["tc_launches_cli_qc"] = w.tc_launches
            # the same pair once more through run_qc, for its counts and
            # times: its report must be the CLI's, row for row
            t = time.perf_counter()
            cases = run_qc(model, images, labels, report + ".direct", compute_dtype=dtype,
                           device=dev)
            qc_s = time.perf_counter() - t
            with open(report + ".direct") as f:
                require([line.rstrip("\n").split("\t") for line in f] == rows,
                         f"run_qc {dtype_name} report differs from the CLI's")
            case = cases[0]
            img, lab = load_pair_on_model_grid(images[0], labels[0], model.dim,
                                               model.voxel_size, device=dev)
            with torch.no_grad():
                logits = forward_fused(model.spec, model.params(),
                                       torch.from_numpy(img).to(dev)[None, ..., None],
                                       compute_dtype=dtype, level0_only=True)[0][0]
            voxels, wrong = host_counts(logits.cpu().numpy(), lab, model.out_count)
            require(voxels.tolist() == np.bincount(lab.astype(np.int64).ravel(),
                                                   minlength=3).tolist()
                    == [s.voxels for s in case.stats],
                    f"QC {dtype_name} voxel counts {[s.voxels for s in case.stats]} vs host "
                    f"{voxels.tolist()}")
            require(wrong.tolist() == [s.wrong for s in case.stats],
                    f"QC {dtype_name} wrong counts {[s.wrong for s in case.stats]} vs host "
                    f"{wrong.tolist()}")
            qc[dtype_name] = {"cli_s": cli_s, "qc_s": qc_s, "load_s": case.load_s,
                              "device_s": case.device_s, "wrong_ratio": case.overall.ratio(),
                              "wrong": [s.wrong for s in case.stats],
                              "voxels": [s.voxels for s in case.stats]}
        del logits
        bf, f32 = qc["bfloat16"], qc["float32"]
        ratio_gap = abs(bf["wrong_ratio"] - f32["wrong_ratio"])
        class_gap = max(abs(a - b) / max(v, 1)
                        for a, b, v in zip(bf["wrong"], f32["wrong"], f32["voxels"]))
        print(json.dumps({"cli_qc": {**qc, "ratio_gap": ratio_gap, "class_gap": class_gap,
                                     "card": card}}), flush=True)
        require(ratio_gap < QC_RATIO_TOL, f"QC bf16 vs f32 wrong ratio gap {ratio_gap}")
        require(class_gap < QC_CLASS_TOL, f"QC bf16 vs f32 class wrong gap {class_gap}")
    finally:
        torch.backends.cudnn.deterministic = was_deterministic

    # the atlas and the mosaic through the CLI's evaluate
    atlas = _write_assets(work, native)
    png = os.path.join(work, "mosaic.png")
    cwd = os.getcwd()
    os.chdir(work)  # the corrected atlas goes to corrected_atlas/ in the CWD
    try:
        shutil.rmtree("corrected_atlas", ignore_errors=True)
        rc, out, eval_s = run_cli(["--action", "evaluate", "--model", final, "--source", src,
                                   "--template", "0", "--atlas", atlas, "--asset_root", work,
                                   "--mosaic", png, "--device", dev])
        require(rc == 0 and "atlas loaded: 6 regions" in out, "cli evaluate with the atlas")
        corrected = os.path.join(work, "corrected_atlas", "regions_atlas.corrected.nii.gz")
        require(os.path.exists(corrected), "the corrected atlas was not written")
        rc, out, _ = run_cli(["--action", "evaluate", "--model", final, "--source", src,
                              "--template", "7", "--atlas", atlas, "--asset_root", work,
                              "--device", dev])
        require(rc == 1 and "error:" in out, "--template 7 must return 1 with error:")
    finally:
        os.chdir(cwd)
    vol = canonicalize_lps(read_nifti(src)).data.astype(float)
    shape = make_mosaic(vol, np.zeros(vol.shape, np.int32)).shape
    with open(png, "rb") as f:
        head = f.read(26)
    width, height, depth, color = struct.unpack(">IIBB", head[16:26])
    require(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
            and (height, width, depth, color) == (shape[0], shape[1], 8, 2),
            f"mosaic PNG {(height, width, depth, color)} vs {shape}")

    # the same parcellation built again (a fresh cache), timed by part; it
    # must give the corrected atlas the CLI wrote
    parc = AtlasParcellation(cache_dir=os.path.join(work, "corrected_atlas_timed"), device=dev)
    shutil.rmtree(parc.cache_dir, ignore_errors=True)
    t = time.perf_counter()
    require(parc.load_template(os.path.join(work, "atlas", "human", "human_tissue.nii.gz"))
            and parc.load_atlas(atlas), f"atlas: {parc.error_msg}")
    atlas_s = time.perf_counter() - t
    require(np.array_equal(parc.atlas, read_nifti(corrected).data),
            "the timed parcellation differs from the CLI's corrected atlas")
    label = canonicalize_lps(read_nifti(src + ".result.nii.gz")).data
    t = time.perf_counter()
    save_mosaic_png(os.path.join(work, "mosaic_timed.png"), vol, label)
    mosaic_s = time.perf_counter() - t
    print(json.dumps({"cli_atlas": {"atlas_s": atlas_s, **parc.seconds, "mosaic_s": mosaic_s,
                                    "cli_evaluate_s": eval_s,
                                    "regions": parc.atlas_region_count,
                                    "mosaic_shape": list(shape), "card": card}}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from unet_studio_tpu_torch import cli
        from unet_studio_tpu_torch.engine.evaluate import EvaluateEngine
        from unet_studio_tpu_torch.io.nifti import read_nifti, write_nifti
        from unet_studio_tpu_torch.models import unet3d as U
        from unet_studio_tpu_torch.models.dsl import default_architecture
        from unet_studio_tpu_torch.models.serialize import load_model, save_model
        from unet_studio_tpu_torch.ops import _cuda
        from unet_studio_tpu_torch.ops import conv as K
        from unet_studio_tpu_torch.ops import reduce as R
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 3
    from unet_studio_tpu_torch.utils.flops import chip_peaks, forward_cost

    global HBM_BYTES_PER_S, BF16_TENSOR_FLOPS
    peaks = chip_peaks(torch.cuda.get_device_name(0))
    if peaks is None:
        raise Failed(f"no published peaks for {torch.cuda.get_device_name(0)!r} in "
                     "unet_studio_tpu_torch/utils/flops.py")
    BF16_TENSOR_FLOPS, HBM_BYTES_PER_S = peaks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t = time.perf_counter()
    _cuda.lib()
    log(f"kernels built/loaded in {time.perf_counter() - t:.1f}s "
        f"(nvcc seconds: {_cuda.last_build_seconds})")
    # registers, shared memory and spills of the tensor-core kernels
    report = _cuda.ptxas_report()
    print(json.dumps({"ptxas": report}), flush=True)
    for k in report:
        if any(n in k["kernel"] for n in ("s2_tc_kernel", "trans2x_tc_kernel",
                                          "trans2x_dx_tc_kernel", "dw_trans_tc_kernel",
                                          "warp_kernel")):  # K3, K6, K4, K8, K9, K10-K12
            log(f"ptxas {k['kernel']}: {'; '.join(k['info'])}")

    # ---- 2. kernels vs twins at the flagship shapes -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    S0, S1, S2 = (192, 224, 192), (96, 112, 96), (48, 56, 48)

    def rnd(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def pro(c, act="leaky_relu"):
        return (rnd(c, scale=0.3) + 1.0, rnd(c, scale=0.3), act)

    def nvox(dims):
        return dims[0] * dims[1] * dims[2]

    def conv_case(dims, ci, co, dtype, stride=1, dual=False, with_pro=True):
        xs = [rnd((*dims, ci), dtype) for _ in range(2 if dual else 1)]
        w = rnd((co, ci * len(xs), 3, 3, 3), scale=(27 * ci * len(xs)) ** -0.5)
        b = rnd(co, scale=0.1)
        pros = [pro(ci) if with_pro else None for _ in xs]
        return xs, w, b, pros

    records = {}

    def record(name, route_src, replaces, wrapper, errs, ms, plain_ms, library_ms, nbytes, ops,
               peak, extra=None):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        rec = {
            "name": name, "route": "cuda", "source": route_src, "replaces": replaces,
            "launches": None, "max_abs_err": errs.get("max_abs", errs.get("bf16_abs")), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, **(extra or {}),
        }
        records[name] = (rec, wrapper)
        print(json.dumps({"kernel": name, **errs, **(extra or {}), "kernel_ms": ms,
                          "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": rec["bound_ms"],
                          "bound_by": rec["bound_by"]}), flush=True)

    # bf16 K1, K3 and K7 run on the tensor cores (K4 and K9 too, in
    # trans_tc.cu); ``f32_fma_ms`` times the f32 call of the same shapes on
    # the FMA kernels beside them
    tc_src = "unet_studio_tpu_torch/csrc/conv_tc.cu"

    # K1, C -> C
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
            (x,), w, b, (p,) = conv_case(dims, c, c, dtype)
            y, st = K.conv3x3x3_s1(x, w, b, prologue=p, want_stats=True)
            yr, sr = K.conv3_plain([x], [p], w, b, 1, want_stats=True)
            e, es = rel_err(y, yr), stats_err(st, sr, nvox(dims))
            require(e < tol and es < STATS_TOL, f"conv3x3x3_s1 C={c} {tag}: err {e} stats {es}")
            require(repeatable(lambda: K.conv3x3x3_s1(x, w, b, prologue=p, want_stats=True)),
                    f"conv3x3x3_s1 C={c} {tag}: (y, stats) differ over two calls")
            errs[f"{tag}_rel_c{c}"] = e
            if dtype == torch.bfloat16:
                errs[f"tc_ms_c{c}"] = timed_ms(
                    lambda: K.conv3x3x3_s1(x, w, b, prologue=p, want_stats=True))
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(y, yr)
                y0 = K.conv3x3x3_s1(x, w, b)  # without prologue and stats
                require(rel_err(y0, K.conv3_plain([x], [None], w, b, 1)) < tol,
                        "conv3x3x3_s1 without prologue")
                ms = timed_ms(lambda: K.conv3x3x3_s1(x, w, b, prologue=p, want_stats=True))
                x32 = x.float()
                fma = {"f32_fma_ms": timed_ms(
                    lambda: K.conv3x3x3_s1(x32, w, b, prologue=p, want_stats=True))}
                del x32
                plain_ms = timed_ms(lambda: K.conv3_plain([x], [p], w, b, 1, want_stats=True))
                xl, wl = K.ncdhw(x), w.to(dtype)
                lib_ms = timed_ms(lambda: torch.nn.functional.conv3d(xl, wl, b.to(dtype),
                                                                     padding=1))
                timing = (ms, plain_ms, lib_ms, 4 * c * nvox(dims), 2 * 27 * c * c * nvox(dims))
            del x, y, yr
    record("conv3x3x3_s1", tc_src, "unet_studio_tpu/ops/pallas_conv.py:355",
           K.conv3x3x3_s1, errs, *timing, BF16_TENSOR_FLOPS, fma)

    # K1, 1 -> 16 entry conv
    errs = {}
    for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
        (x,), w, b, _ = conv_case(S0, 1, 16, dtype, with_pro=False)
        y, st = K.conv3x3x3_entry(x, w, b, want_stats=True)
        yr, sr = K.conv3_plain([x], [None], w, b, 1, want_stats=True)
        e, es = rel_err(y, yr), stats_err(st, sr, nvox(S0))
        require(e < tol and es < STATS_TOL, f"conv3x3x3_entry {tag}: err {e} stats {es}")
        require(repeatable(lambda: K.conv3x3x3_entry(x, w, b, want_stats=True)),
                f"conv3x3x3_entry {tag}: (y, stats) differ over two calls")
        errs[f"{tag}_rel"] = e
        if dtype == torch.bfloat16:
            errs["bf16_abs"] = abs_err(y, yr)
            ms = timed_ms(lambda: K.conv3x3x3_entry(x, w, b, want_stats=True))
            x32 = x.float()
            fma = {"f32_fma_ms": timed_ms(lambda: K.conv3x3x3_entry(x32, w, b, want_stats=True))}
            del x32
            plain_ms = timed_ms(lambda: K.conv3_plain([x], [None], w, b, 1, want_stats=True))
            xl = K.ncdhw(x)
            lib_ms = timed_ms(lambda: torch.nn.functional.conv3d(xl, w.to(dtype), b.to(dtype),
                                                                 padding=1))
            timing = (ms, plain_ms, lib_ms, (1 + 16) * 2 * nvox(S0), 2 * 27 * 16 * nvox(S0))
        del x, y, yr
    record("conv3x3x3_entry", tc_src, "unet_studio_tpu/ops/packed.py:736",
           K.conv3x3x3_entry, errs, *timing, BF16_TENSOR_FLOPS, fma)

    # K1, 2C -> C decoder entry (skip, up)
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
            (xa, xb), w, b, (pa, pb) = conv_case(dims, c, c, dtype, dual=True)
            y = K.conv3x3x3_dual(xa, xb, w, b, prologue_a=pa, prologue_b=pb)
            yr = K.conv3_plain([xa, xb], [pa, pb], w, b, 1)
            e = rel_err(y, yr)
            require(e < tol, f"conv3x3x3_dual C={c} {tag}: err {e}")
            errs[f"{tag}_rel_c{c}"] = e
            if dtype == torch.bfloat16:
                errs[f"tc_ms_c{c}"] = timed_ms(
                    lambda: K.conv3x3x3_dual(xa, xb, w, b, prologue_a=pa, prologue_b=pb))
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(y, yr)
                ms = timed_ms(lambda: K.conv3x3x3_dual(xa, xb, w, b, prologue_a=pa, prologue_b=pb))
                xa32, xb32 = xa.float(), xb.float()
                fma = {"f32_fma_ms": timed_ms(lambda: K.conv3x3x3_dual(
                    xa32, xb32, w, b, prologue_a=pa, prologue_b=pb))}
                del xa32, xb32
                plain_ms = timed_ms(lambda: K.conv3_plain([xa, xb], [pa, pb], w, b, 1))
                # library yardstick: one cuDNN conv of the concatenation
                # (the concatenation itself is not timed)
                xl = K.ncdhw(torch.cat([xa, xb], -1))
                lib_ms = timed_ms(lambda: torch.nn.functional.conv3d(xl, w.to(dtype), b.to(dtype),
                                                                     padding=1))
                del xl
                timing = (ms, plain_ms, lib_ms, 6 * c * nvox(dims),
                          2 * 27 * 2 * c * c * nvox(dims))
            del xa, xb, y, yr
    record("conv3x3x3_dual", tc_src, "unet_studio_tpu/ops/pallas_conv.py:355",
           K.conv3x3x3_dual, errs, *timing, BF16_TENSOR_FLOPS, fma)

    # K3, C -> 2C stride 2 (64 -> 128 included); bf16 on the tensor cores,
    # each level timed beside its bound, f32 on the FMA kernel
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
            (x,), w, b, (p,) = conv_case(dims, c, 2 * c, dtype, stride=2)
            y, st = K.conv3x3x3_s2(x, w, b, prologue=p, want_stats=True)
            yr, sr = K.conv3_plain([x], [p], w, b, 2, want_stats=True)
            e, es = rel_err(y, yr), stats_err(st, sr, nvox(dims) // 8)
            require(e < tol and es < STATS_TOL, f"conv3x3x3_s2 C={c} {tag}: err {e} stats {es}")
            require(repeatable(lambda: K.conv3x3x3_s2(x, w, b, prologue=p, want_stats=True)),
                    f"conv3x3x3_s2 C={c} {tag}: (y, stats) differ over two calls")
            errs[f"{tag}_rel_c{c}"] = e
            errs[f"{tag}_stats_c{c}"] = es
            n_out = nvox(dims) // 8
            nbytes, ops = 2 * c * nvox(dims) + 2 * 2 * c * n_out, 2 * 27 * c * 2 * c * n_out
            if dtype == torch.bfloat16:
                errs[f"tc_ms_c{c}"] = timed_ms(
                    lambda: K.conv3x3x3_s2(x, w, b, prologue=p, want_stats=True))
                # the kernel's own time, without the wrapper's host time
                errs[f"device_ms_c{c}"] = device_ms(
                    lambda: K.conv3x3x3_s2(x, w, b, prologue=p, want_stats=True), "s2_tc_kernel")
                errs[f"bound_ms_c{c}"] = max(nbytes / HBM_BYTES_PER_S,
                                             ops / BF16_TENSOR_FLOPS) * 1e3
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(y, yr)
                ms = timed_ms(lambda: K.conv3x3x3_s2(x, w, b, prologue=p, want_stats=True))
                x32 = x.float()
                fma = {"f32_fma_ms": timed_ms(
                    lambda: K.conv3x3x3_s2(x32, w, b, prologue=p, want_stats=True))}
                del x32
                plain_ms = timed_ms(lambda: K.conv3_plain([x], [p], w, b, 2, want_stats=True))
                xl = K.ncdhw(x)
                lib_ms = timed_ms(lambda: torch.nn.functional.conv3d(
                    xl, w.to(dtype), b.to(dtype), stride=2, padding=1))
                timing = (ms, plain_ms, lib_ms, nbytes, ops)
            del x, y, yr
    record("conv3x3x3_s2", tc_src, "unet_studio_tpu/ops/packed.py:227",
           K.conv3x3x3_s2, errs, *timing, BF16_TENSOR_FLOPS, fma)

    # K4, 2C -> C transposed conv: 64 -> 32 (level 2 -> 1) and 32 -> 16
    # (level 1 -> 0); bf16 on the tensor cores, each pair timed beside its
    # bound and its own device time, f32 on the FMA kernel (``f32_fma_ms_c*``)
    errs = {}
    for dims, co in ((S2, 32), (S1, 16)):
        ci, n_in = 2 * co, nvox(dims)
        nbytes, ops = 2 * ci * n_in + 2 * co * 8 * n_in, 2 * ci * co * 8 * n_in
        for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
            x = rnd((*dims, ci), dtype)
            w = rnd((ci, co, 2, 2, 2), scale=ci ** -0.5)
            b, p = rnd(co, scale=0.1), pro(ci)
            y = K.conv_trans2x(x, w, b, prologue=p)
            yr = K.conv_trans2x_plain(x, w, b, p)
            e = rel_err(y, yr)
            require(e < tol, f"conv_trans2x Co={co} {tag}: err {e}")
            require(rel_err(K.conv_trans2x(x, w, b), K.conv_trans2x_plain(x, w, b)) < tol,
                    f"conv_trans2x Co={co} {tag} without prologue")
            require(repeatable(lambda: K.conv_trans2x(x, w, b, prologue=p)),
                    f"conv_trans2x Co={co} {tag}: y differs over two calls")
            errs[f"{tag}_rel_co{co}"] = e
            if dtype == torch.bfloat16:
                errs[f"tc_ms_c{ci}"] = timed_ms(lambda: K.conv_trans2x(x, w, b, prologue=p))
                errs[f"device_ms_c{ci}"] = device_ms(
                    lambda: K.conv_trans2x(x, w, b, prologue=p), "trans2x_tc_kernel")
                errs[f"bound_ms_c{ci}"] = max(nbytes / HBM_BYTES_PER_S,
                                              ops / BF16_TENSOR_FLOPS) * 1e3
            else:
                errs[f"f32_fma_ms_c{ci}"] = timed_ms(lambda: K.conv_trans2x(x, w, b, prologue=p))
            if co == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(y, yr)
                plain_ms = timed_ms(lambda: K.conv_trans2x_plain(x, w, b, p))
                xl = K.ncdhw(x)
                lib_ms = timed_ms(lambda: torch.nn.functional.conv_transpose3d(
                    xl, w.to(dtype), b.to(dtype), stride=2))
                timing = (errs["tc_ms_c32"], plain_ms, lib_ms, nbytes, ops)
            del x, y, yr
    record("conv_trans2x", "unet_studio_tpu_torch/csrc/trans_tc.cu",
           "unet_studio_tpu/ops/packed.py:439", K.conv_trans2x, errs, *timing,
           BF16_TENSOR_FLOPS, {"f32_fma_ms": errs["f32_fma_ms_c32"]})

    # K2 sum_sq
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = rnd((*dims, c), dtype) + 0.25
            st, sr = R.channel_sum_sq(x), R.channel_sum_sq_plain(x)
            e = stats_err(st, sr, nvox(dims))
            require(e < STATS_TOL, f"channel_sum_sq C={c} {tag}: err {e}")
            errs[f"{tag}_stats_c{c}"] = e
            require(repeatable(lambda: R.channel_sum_sq(x)), f"channel_sum_sq C={c} {tag} repeat")
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(st, sr)
                errs["device_ms"] = device_ms(lambda: R.channel_sum_sq(x), "channel_reduce_kernel")
                errs["host_ms"] = host_ms(lambda: R.channel_sum_sq(x))
                errs["library_device_ms"] = device_ms(
                    lambda: torch.var_mean(x, dim=(0, 1, 2), correction=0), "")
                errs["library_host_ms"] = host_ms(
                    lambda: torch.var_mean(x, dim=(0, 1, 2), correction=0))
                ms = timed_ms(lambda: R.channel_sum_sq(x))
                plain_ms = timed_ms(lambda: R.channel_sum_sq_plain(x))
                # library yardstick: the same statistics in one call
                lib_ms = timed_ms(lambda: torch.var_mean(x, dim=(0, 1, 2), correction=0))
                timing = (ms, plain_ms, lib_ms, 2 * c * nvox(dims), 3 * c * nvox(dims))
            del x
    record("channel_sum_sq", "unet_studio_tpu_torch/csrc/reduce.cu",
           "unet_studio_tpu/ops/packed.py:1292", R.channel_sum_sq, errs, *timing, F32_FLOPS)
    torch.cuda.empty_cache()

    # ---- 3. full-width forward parity ---------------------------------------
    spec_arch = default_architecture(3)
    model = U.UNet3d.create(1, 3, spec_arch, seed=0, device=dev)
    spec, params = model.spec, model.params()
    x = torch.from_numpy(
        np.random.default_rng(1).random((1, *model.dim_dhw, 1), np.float32)).to(dev)
    with torch.no_grad():
        ref = U.forward_fused(spec, params, x, compute_dtype=torch.float32, plain=True,
                              level0_only=True)[0]
        k32 = U.forward_fused(spec, params, x, compute_dtype=torch.float32, level0_only=True)[0]
        e_twin = rel_err(k32, ref)
        del k32
        unfused = U.forward(spec, params, x, compute_dtype=torch.float32)[0]
        kb16 = U.forward_fused(spec, params, x, compute_dtype=torch.bfloat16,
                               level0_only=True)[0]
        e_unfused = rel_err(ref, unfused)
        e_bf16 = rel_err(kb16, ref)
        agree = float((kb16.argmax(-1) == ref.argmax(-1)).float().mean())
        del unfused
    log(f"forward parity: f32 kernels vs twins {e_twin:.3g}, twins vs plain unfused "
        f"{e_unfused:.3g}, bf16 kernels vs f32 {e_bf16:.3g}, label agreement {agree:.5f}")
    require(e_twin < FWD_F32_TOL, f"f32 forward vs twins {e_twin}")
    require(e_unfused < FWD_F32_TOL, f"fused twins vs unfused forward {e_unfused}")
    require(e_bf16 < FWD_BF16_TOL, f"bf16 forward vs f32 {e_bf16}")
    require(agree > LABEL_AGREE, f"label agreement {agree}")
    require(bool(torch.isfinite(kb16).all()) and kb16.shape == (1, *model.dim_dhw, 3),
            "forward output shape or finiteness")
    with torch.no_grad():
        forward_ms = timed_ms(lambda: U.forward_fused(
            spec, params, x, compute_dtype=torch.bfloat16, level0_only=True), reps=3)
    log(f"forward_ms (bf16, level 0, kernel path): {forward_ms:.3f}")
    # the flagship forward's FLOPs and bytes (utils/flops.forward_cost, which
    # also counts the heads above level 0) against the card's peaks
    fl, nb = forward_cost(spec, model.dim_dhw)
    t_fl, t_nb = fl / BF16_TENSOR_FLOPS * 1e3, nb / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"forward_roofline": {
        "flops": fl, "bytes": nb, "forward_ms": forward_ms, "flops_share": t_fl / forward_ms,
        "bytes_share": t_nb / forward_ms, "bound_ms": max(t_fl, t_nb),
        "bound_by": "bytes" if t_nb >= t_fl else "operations", "card": card}}), flush=True)
    print(json.dumps({"forward_profile": profile_forward(
        lambda: U.forward_fused(spec, params, x, compute_dtype=torch.bfloat16,
                                level0_only=True),
        watch=("s2_tc_kernel", "conv3_tc_kernel", "entry_tc_kernel", "trans2x_tc_kernel",
               "channel_reduce_kernel", "dw_reduce_kernel"))}), flush=True)
    del ref, kb16, x
    torch.cuda.empty_cache()

    # ---- 4. the normal entry point ------------------------------------------
    # the repo's golden fixtures (16^3 models; their C=16 decoder entries
    # and norms run K1 dual and K2) to tests/test_golden.py's tolerances
    root = os.path.dirname(os.path.abspath(__file__))
    for name in ("golden", "golden_bmu", "golden_mc", "golden_pp"):
        d = os.path.join(root, "tests", "fixtures", name)
        exp = np.load(os.path.join(d, "expected.npz"))
        gm = load_model(os.path.join(d, "model.nz"), device=dev)
        gm.prepare_for_inference()
        case = next(iter(EvaluateEngine(gm, compute_dtype=torch.float32, device=dev)
                         .run([os.path.join(d, "input.nii.gz")])))
        match = float(np.mean(case.label == exp["label"]))
        fg_err = float(np.abs(case.fg_prob - exp["fg_prob"]).max())
        log(f"golden {name}: label match {match:.5f}, fg max err {fg_err:.4g}")
        require(not case.error_msg and match > 0.999 and fg_err <= 8e-3, f"golden {name}")

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    model_path = os.path.join(work, "flagship.nz")
    save_model(model_path, model)
    del model
    native = (182, 218, 182)  # (z, y, x): a 1 mm MNI-sized T1w grid

    def synthetic_volume(path, seed):
        z, y, xx = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in native],
                               indexing="ij")
        head = ((z / 0.8) ** 2 + (y / 0.9) ** 2 + (xx / 0.75) ** 2) < 1.0
        r = np.random.default_rng(seed)
        vol = head * (0.6 + 0.3 * np.sin(6 * xx + 3 * y)) + r.random(native, np.float32) * 0.1
        write_nifti(path, vol.astype(np.float32), (1.0, 1.0, 1.0))

    src = os.path.join(work, "t1w.nii.gz")
    synthetic_volume(src, 3)
    for rec, wrapper in records.values():
        wrapper.launches = 0
        wrapper.tc_launches = 0
    t = time.perf_counter()
    rc = cli.main(["--action", "evaluate", "--model", model_path, "--source", src,
                   "--device", "cuda", "--compute_dtype", "bfloat16"])
    torch.cuda.synchronize()
    log(f"cli evaluate rc={rc} in {time.perf_counter() - t:.2f}s")
    require(rc == 0, f"cli evaluate returned {rc}")
    for rec, wrapper in records.values():
        rec["launches_evaluate"] = wrapper.launches
        if wrapper in K.TC_WRAPPERS:
            rec["tc_launches_evaluate"] = wrapper.tc_launches
    log("launches in the evaluate run: "
        + json.dumps({k: r["launches_evaluate"] for k, (r, _) in records.items()}))
    require(all(r["launches_evaluate"] > 0 for r, _ in records.values()),
            "a kernel of the evaluate path was not launched")
    require(all(r["tc_launches_evaluate"] == r["launches_evaluate"] for r, w in records.values()
                if w in K.TC_WRAPPERS),
            "a bf16 K1, K3 or K4 of the evaluate path left the tensor cores")
    out = read_nifti(src + ".result.nii.gz")
    require(out.data.shape == native, f"result shape {out.data.shape}")
    labels = set(np.unique(out.data).tolist())
    require(labels <= {0, 1, 2}, f"labels {labels}")

    # three volumes through the pipelined engine, and each stage alone
    paths = []
    for i in range(3):
        p = os.path.join(work, f"vol{i}.nii.gz")
        synthetic_volume(p, 10 + i)
        paths.append(p)
    engine = EvaluateEngine(load_model(model_path, device=dev), compute_dtype=torch.bfloat16,
                            device=dev)
    t = time.perf_counter()
    cases = list(engine.run(paths))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    require(all(not c.error_msg for c in cases) and len(cases) == 3, "engine run errors")
    stages = {}
    t = time.perf_counter()
    case = engine.preprocess(paths[0])
    stages["read_preprocess_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engine.infer(case)
    torch.cuda.synchronize()
    stages["infer_s"] = time.perf_counter() - t
    infer_profile = profile_forward(lambda: engine.infer(case))
    t = time.perf_counter()
    engine.postprocess(case)
    stages["postprocess_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engine.save_case(case, os.path.join(work, "stage.result.nii.gz"))
    stages["save_s"] = time.perf_counter() - t
    e2e = {"vols_per_s": 3 / run_s, "forward_ms": forward_ms, **stages,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    print(json.dumps({"end_to_end": e2e}), flush=True)
    print(json.dumps({"infer_profile": infer_profile}), flush=True)
    del engine, cases, case
    torch.cuda.empty_cache()

    phase5_backward_kernels(records, record, rnd, nvox, (S0, S1, S2))
    # phase 7 runs first so that phase 6's counted step covers its kernels
    phase7_augmentation_kernels(record, rnd, dev, card)
    phase6_train_step(records, spec_arch, dev, card)
    phase8_cli(records, work, card)
    phase9_qc_atlas(records, work, card)

    log("all phases passed; wall time in the prefix")
    print(card)
    print(json.dumps({"kernels": [r for r, _ in records.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
