#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``unet_studio_tpu_torch``) on one NVIDIA
GPU and check it, phase by phase.  Any failed phase exits non-zero.

1. Device, ``nvidia-smi`` name and power limit, and the kernels' build
   from ``unet_studio_tpu_torch/csrc`` (nvcc, sm_90a).
2. Each kernel wrapper against its plain PyTorch twin on the card at the
   flagship U-Net's shapes (``default_architecture(3)`` on the 192x224x192
   grid), in bf16 and in f32, with its time, the twin's, one PyTorch
   library call's and the least time the card could take.
3. The full-width forward through the kernels against the all-twin
   forward and the plain unfused forward (f32), and in bf16; its time,
   and its device time by kernel from ``torch.profiler``.
4. The evaluate engine on the repo's golden fixtures (f32), then the
   normal entry point: ``cli.main --action evaluate`` on a synthetic
   182x218x182 1 mm volume in bf16, with every kernel's launch count
   read around it; then three volumes through ``EvaluateEngine.run``,
   each stage timed alone, and the device's busy share of ``infer``.

TF32 is switched off for cuDNN and matmuls, so every f32 comparison is
f32 (cuDNN runs f32 convolutions in TF32 by default).

    python3 chip_smoke.py

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds one JSON object with every kernel's numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak
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


def profile_forward(fn, top: int = 12) -> dict:
    """Device time by kernel name over one call of ``fn`` (torch.profiler,
    CUPTI), and the device's busy share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "top": [{"ms": ms, "count": n, "name": k} for ms, n, k in rows[:top]]}


class Failed(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


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
               peak):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        rec = {
            "name": name, "route": "cuda", "source": route_src, "replaces": replaces,
            "launches": None, "max_abs_err": errs["bf16_abs"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        records[name] = (rec, wrapper)
        print(json.dumps({"kernel": name, **errs, "kernel_ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": rec["bound_ms"],
                          "bound_by": rec["bound_by"]}), flush=True)

    conv_src = "unet_studio_tpu_torch/csrc/conv.cu"

    # K1, C -> C
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
            (x,), w, b, (p,) = conv_case(dims, c, c, dtype)
            y, st = K.conv3x3x3_s1(x, w, b, prologue=p, want_stats=True)
            yr, sr = K.conv3_plain([x], [p], w, b, 1, want_stats=True)
            e, es = rel_err(y, yr), stats_err(st, sr, nvox(dims))
            require(e < tol and es < STATS_TOL, f"conv3x3x3_s1 C={c} {tag}: err {e} stats {es}")
            errs[f"{tag}_rel_c{c}"] = e
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(y, yr)
                y0 = K.conv3x3x3_s1(x, w, b)  # without prologue and stats
                require(rel_err(y0, K.conv3_plain([x], [None], w, b, 1)) < tol,
                        "conv3x3x3_s1 without prologue")
                ms = timed_ms(lambda: K.conv3x3x3_s1(x, w, b, prologue=p, want_stats=True))
                plain_ms = timed_ms(lambda: K.conv3_plain([x], [p], w, b, 1, want_stats=True))
                xl, wl = K.ncdhw(x), w.to(dtype)
                lib_ms = timed_ms(lambda: torch.nn.functional.conv3d(xl, wl, b.to(dtype),
                                                                     padding=1))
                timing = (ms, plain_ms, lib_ms, 4 * c * nvox(dims), 2 * 27 * c * c * nvox(dims))
            del x, y, yr
    record("conv3x3x3_s1", conv_src, "unet_studio_tpu/ops/pallas_conv.py:355",
           K.conv3x3x3_s1, errs, *timing, BF16_TENSOR_FLOPS)

    # K1, 1 -> 16 entry conv
    errs = {}
    for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
        (x,), w, b, _ = conv_case(S0, 1, 16, dtype, with_pro=False)
        y, st = K.conv3x3x3_entry(x, w, b, want_stats=True)
        yr, sr = K.conv3_plain([x], [None], w, b, 1, want_stats=True)
        e, es = rel_err(y, yr), stats_err(st, sr, nvox(S0))
        require(e < tol and es < STATS_TOL, f"conv3x3x3_entry {tag}: err {e} stats {es}")
        errs[f"{tag}_rel"] = e
        if dtype == torch.bfloat16:
            errs["bf16_abs"] = abs_err(y, yr)
            ms = timed_ms(lambda: K.conv3x3x3_entry(x, w, b, want_stats=True))
            plain_ms = timed_ms(lambda: K.conv3_plain([x], [None], w, b, 1, want_stats=True))
            xl = K.ncdhw(x)
            lib_ms = timed_ms(lambda: torch.nn.functional.conv3d(xl, w.to(dtype), b.to(dtype),
                                                                 padding=1))
            timing = (ms, plain_ms, lib_ms, (1 + 16) * 2 * nvox(S0), 2 * 27 * 16 * nvox(S0))
        del x, y, yr
    record("conv3x3x3_entry", conv_src, "unet_studio_tpu/ops/packed.py:736",
           K.conv3x3x3_entry, errs, *timing, BF16_TENSOR_FLOPS)

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
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(y, yr)
                ms = timed_ms(lambda: K.conv3x3x3_dual(xa, xb, w, b, prologue_a=pa, prologue_b=pb))
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
    record("conv3x3x3_dual", conv_src, "unet_studio_tpu/ops/pallas_conv.py:355",
           K.conv3x3x3_dual, errs, *timing, BF16_TENSOR_FLOPS)

    # K3, C -> 2C stride 2 (64 -> 128 included)
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
            (x,), w, b, (p,) = conv_case(dims, c, 2 * c, dtype, stride=2)
            y, st = K.conv3x3x3_s2(x, w, b, prologue=p, want_stats=True)
            yr, sr = K.conv3_plain([x], [p], w, b, 2, want_stats=True)
            e, es = rel_err(y, yr), stats_err(st, sr, nvox(dims) // 8)
            require(e < tol and es < STATS_TOL, f"conv3x3x3_s2 C={c} {tag}: err {e} stats {es}")
            errs[f"{tag}_rel_c{c}"] = e
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(y, yr)
                ms = timed_ms(lambda: K.conv3x3x3_s2(x, w, b, prologue=p, want_stats=True))
                plain_ms = timed_ms(lambda: K.conv3_plain([x], [p], w, b, 2, want_stats=True))
                xl = K.ncdhw(x)
                lib_ms = timed_ms(lambda: torch.nn.functional.conv3d(
                    xl, w.to(dtype), b.to(dtype), stride=2, padding=1))
                n_out = nvox(dims) // 8
                timing = (ms, plain_ms, lib_ms, 2 * c * nvox(dims) + 2 * 2 * c * n_out,
                          2 * 27 * c * 2 * c * n_out)
            del x, y, yr
    record("conv3x3x3_s2", conv_src, "unet_studio_tpu/ops/packed.py:227",
           K.conv3x3x3_s2, errs, *timing, BF16_TENSOR_FLOPS)

    # K4, 2C -> C transposed conv
    errs = {}
    for dims, co in ((S2, 32), (S1, 16)):
        for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
            x = rnd((*dims, 2 * co), dtype)
            w = rnd((2 * co, co, 2, 2, 2), scale=(2 * co) ** -0.5)
            b, p = rnd(co, scale=0.1), pro(2 * co)
            y = K.conv_trans2x(x, w, b, prologue=p)
            yr = K.conv_trans2x_plain(x, w, b, p)
            e = rel_err(y, yr)
            require(e < tol, f"conv_trans2x Co={co} {tag}: err {e}")
            errs[f"{tag}_rel_co{co}"] = e
            if co == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(y, yr)
                ms = timed_ms(lambda: K.conv_trans2x(x, w, b, prologue=p))
                plain_ms = timed_ms(lambda: K.conv_trans2x_plain(x, w, b, p))
                xl = K.ncdhw(x)
                lib_ms = timed_ms(lambda: torch.nn.functional.conv_transpose3d(
                    xl, w.to(dtype), b.to(dtype), stride=2))
                n_in = nvox(dims)
                timing = (ms, plain_ms, lib_ms, 2 * (2 * co) * n_in + 2 * co * 8 * n_in,
                          2 * 2 * co * co * 8 * n_in)
            del x, y, yr
    record("conv_trans2x", conv_src, "unet_studio_tpu/ops/packed.py:439",
           K.conv_trans2x, errs, *timing, BF16_TENSOR_FLOPS)

    # K2 sum_sq
    errs = {}
    for dims, c in ((S0, 16), (S1, 32), (S2, 64)):
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = rnd((*dims, c), dtype) + 0.25
            st, sr = R.channel_sum_sq(x), R.channel_sum_sq_plain(x)
            e = stats_err(st, sr, nvox(dims))
            require(e < STATS_TOL, f"channel_sum_sq C={c} {tag}: err {e}")
            errs[f"{tag}_stats_c{c}"] = e
            if c == 16 and dtype == torch.bfloat16:
                errs["bf16_abs"] = abs_err(st, sr)
                ms = timed_ms(lambda: R.channel_sum_sq(x))
                plain_ms = timed_ms(lambda: R.channel_sum_sq_plain(x))
                timing = (ms, plain_ms, None, 2 * c * nvox(dims), 3 * c * nvox(dims))
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
    print(json.dumps({"forward_profile": profile_forward(
        lambda: U.forward_fused(spec, params, x, compute_dtype=torch.bfloat16,
                                level0_only=True))}), flush=True)
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
    t = time.perf_counter()
    rc = cli.main(["--action", "evaluate", "--model", model_path, "--source", src,
                   "--device", "cuda", "--compute_dtype", "bfloat16"])
    torch.cuda.synchronize()
    log(f"cli evaluate rc={rc} in {time.perf_counter() - t:.2f}s")
    require(rc == 0, f"cli evaluate returned {rc}")
    for rec, wrapper in records.values():
        rec["launches"] = wrapper.launches
    log("launches in the evaluate run: "
        + json.dumps({k: r["launches"] for k, (r, _) in records.items()}))
    require(all(r["launches"] > 0 for r, _ in records.values()),
            "a kernel of the evaluate path was not launched")
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
