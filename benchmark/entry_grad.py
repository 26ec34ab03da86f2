"""The first gradient of the entry conv's weight (``encode0.0.w``), taken
apart term by term against the reference:

    python3 -m benchmark.entry_grad --workload train.nnunet --seeds a,b,... [--f32 a,...]

``grad_gap_med`` leaves this leaf to standard error; this is the look at
why it reads high on some seeds.  For each seed, step 1 of a train cell's
set-up (the weights, template and items that ``benchmark.run`` makes from
that seed) runs in the program, the entry conv's backward recording per
item its input ``x`` and the gradient ``g`` it receives; then step 1 of
the reference, recording the same.  Each weight gradient below is
summed over the items in float64 from the recorded tensors and divided by
the batch.  One JSON line per seed; each ``gap`` is
``drive_train.norm_gaps``'s (|norm - reference's norm| over the
reference's norm or the median leaf's), each ``dist`` ||a - ref|| / ||ref||:

- ``program``: the program's gradient as its optimizer gets it (the
  benchmark's reading of this leaf);
- ``kernel_dist``: the program's own dW kernel against float64 from the
  same bf16 ``x`` and ``g`` (the kernel's own error);
- ``ref_g_bf16``, ``ref_xg_bf16``, ``ref_g_fp8``: the reference's
  gradient with its own ``g`` (and ``x``) rounded to bfloat16, or ``g``
  to float8 e4m3 as the control rounds it, at this conv alone;
- ``offset``: per item and channel, the instance norm makes sum(g) over
  the voxels nought; ``offset_*`` is ||sum(g)|| / ||sum(|g|)|| of the
  program's ``g``, the reference's, and the reference's rounded to
  bfloat16; ``*_less_offset`` the gap once each item's mean of ``g`` is
  taken out of ``g`` (dW - mean(g) * sum(x) per tap);
- ``x_dist``, ``g_dist``: the program's ``x`` and ``g`` against the
  reference's, item by item (``g`` for the first two items);
- ``ref_norm_bf16``: the reference with the backward of the entry's
  instance norm alone computed as the program computes it (bfloat16
  elementwise, its per-channel means of ``g`` and ``g * xhat`` rounded to
  bfloat16 before they are subtracted);
- with ``--f32``, ``program_f32``: the program's float32 route's gap.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from . import drive_train
from .harness import ROOT, Bench, cache_dirs
from .reference import net as ref_net
from .trace import patched

LEAF = "encode0.0.w"


@contextlib.contextmanager
def backward_of(cls, fn):
    """``cls.backward`` replaced by ``fn`` inside the block."""
    old = cls.__dict__["backward"]
    cls.backward = staticmethod(fn)
    try:
        yield
    finally:
        cls.backward = old


def _dw(x, g):
    """float64 weight gradient (Co, 1, 3, 3, 3) of the 3x3x3 stride-1
    conv of one item: ``x`` (1, D, H, W), ``g`` (Co, D, H, W)."""
    return ref_net._dw_s1(x.double(), g.double(), 3)


class Terms:
    """Sums over the items of one side's entry backward."""

    def __init__(self):
        self.sums: dict = {}
        self.offset = [0.0, 0.0]
        self.x, self.g = [], []

    def add(self, key, value):
        self.sums[key] = value if key not in self.sums else self.sums[key] + value

    def item(self, x, g, keep_g: bool, extra: dict):
        """``x`` (1, D, H, W), ``g`` (Co, D, H, W), any dtype."""
        n = g[0].numel()
        s = _dw(x, torch.ones_like(x))  # (1, 1, 3, 3, 3): sum of x per tap
        for key, gg in {"": g, **extra}.items():
            gd = gg.double()
            dw = _dw(x, gd)
            self.add(key, dw)
            mean = gd.sum(dim=(1, 2, 3)) / n
            self.add(key + "less_offset", dw - mean.view(-1, 1, 1, 1, 1) * s)
            if key == "":
                self.offset[0] += float(gd.sum(dim=(1, 2, 3)).norm())
                self.offset[1] += float(gd.abs().sum(dim=(1, 2, 3)).norm())
        self.x.append(x.detach().clone())
        if keep_g:
            self.g.append(g.detach().clone())


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def program_step(cfg, mix, seed, dev, workdir, compute_dtype=None, record=True):
    """Step 1 of the program from the seed: (grads as the optimizer gets
    them, Terms of its entry backward, p0, image, label, vs, spec)."""
    from unet_studio_tpu_torch.engine import train as prog_train
    from unet_studio_tpu_torch.ops import conv as K

    spec, engine, model, p0, image, label, vs, batch = drive_train.start_engine(
        cfg, mix, seed, dev, workdir, compute_dtype)
    terms, grads, kernel = Terms(), [], []
    orig, sgd = K.ConvEntryFn.backward, prog_train.sgd_step

    def backward(ctx, g):
        out = orig(ctx, g)
        if record:
            (x,) = ctx.saved_tensors
            gd = g.to(x.dtype)
            shape = gd.shape[-4:-1]
            terms.item(x.reshape(1, *shape), gd.reshape(*shape, -1).permute(3, 0, 1, 2),
                       len(terms.x) < 2, {})
            kernel.append(out[1].double())
        return out

    def optimizer(params, g, *args, **kwargs):
        grads.append({k: v.detach().to("cpu", copy=True) for k, v in g.items()})
        return sgd(params, g, *args, **kwargs)

    with backward_of(K.ConvEntryFn, backward), patched(prog_train, "sgd_step", optimizer):
        engine.run_epoch()
    engine.stop()
    if record:
        terms.add("kernel", sum(kernel))
    del engine, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return grads[0], terms, batch, p0, image, label, vs, spec


def reference_step(cfg, mix, seed, spec, p0, image, label, vs, dev):
    """Step 1 of the reference: (its gradients, Terms of its entry
    backward with ``g`` also rounded)."""
    terms = Terms()
    orig = ref_net._Conv.backward

    def backward(ctx, g):
        x, _ = ctx.saved_tensors
        _, trans, _ = ctx.conf
        if not trans and x.shape[1] == 1:
            xr, gr = x[0], g[0]
            terms.item(xr, gr, len(terms.x) < 2,
                       {"g_bf16": _bf16(gr), "g_fp8": ref_net._fp8_round(gr)})
            terms.add("xg_bf16", _dw(_bf16(xr), _bf16(gr)))
        return orig(ctx, g)

    with backward_of(ref_net._Conv, backward):
        ref = drive_train.reference_steps(cfg, mix, 1, spec, p0, image, label, vs, seed, dev)
    return ref["grad"], terms


class _NormBf16Backward(torch.autograd.Function):
    """The reference's instance norm (float32, two-pass statistics) whose
    backward is the program's ``InstanceNormTrain.backward`` arithmetic
    on (N, C, D, H, W): ``x`` and ``g`` in bfloat16, the sums in float32,
    the rest bfloat16 elementwise."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps=1e-5):
        dims = (2, 3, 4)
        mean = x.mean(dim=dims, keepdim=True)
        inv = torch.rsqrt((x - mean).square().mean(dim=dims, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, mean, inv)
        sh = (1, -1, 1, 1, 1)
        return (x - mean) * inv * scale.view(sh) + bias.view(sh)

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, inv = ctx.saved_tensors
        dt, dims, sh = torch.bfloat16, (2, 3, 4), (1, -1, 1, 1, 1)
        n = x[0, 0].numel()
        xb, gb = x.to(dt), g.to(dt)
        g_mean = gb.float().sum(dim=dims, keepdim=True) / n
        gx_mean = (gb.float() * ((xb.float() - mean) * inv)).sum(dim=dims, keepdim=True) / n
        xhat = (xb - mean.to(dt)) * inv.to(dt)
        coef = (inv * scale.view(sh)).to(dt)
        dx = coef * (gb - g_mean.to(dt) - xhat * gx_mean.to(dt))
        return (dx.float(), (gx_mean * n).sum(dim=0).reshape(-1),
                (g_mean * n).sum(dim=0).reshape(-1), None)


def reference_norm_bf16(cfg, mix, seed, spec, p0, image, label, vs, dev):
    """Step 1 of the reference with the entry's norm (each item's first)
    backward as the program's: its gradients."""
    from .reference import train as ref_train

    calls = [0]
    synth, norm = ref_train.synthesize, ref_net._instance_norm

    def item(*args, **kwargs):
        calls[0] = 0
        return synth(*args, **kwargs)

    def first_norm(x, scale, bias, eps=1e-5):
        calls[0] += 1
        if calls[0] == 1:
            return _NormBf16Backward.apply(x, scale, bias, eps)
        return norm(x, scale, bias, eps)

    with patched(ref_train, "synthesize", item), patched(ref_net, "_instance_norm", first_norm):
        return drive_train.reference_steps(cfg, mix, 1, spec, p0, image, label, vs, seed,
                                           dev)["grad"]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def witness(cfg, mix, seed, dev, f32: bool) -> dict:
    workdir = tempfile.mkdtemp(prefix="unet-bench-")
    try:
        grads, prog, batch, p0, image, label, vs, spec = program_step(cfg, mix, seed, dev,
                                                                      workdir)
        f32_grad = None
        if f32:
            try:
                f32_grad = program_step(cfg, mix, seed, dev, workdir, "float32", record=False)[0]
            except Exception as e:  # the route's failure is a reading too
                f32_grad = f"{type(e).__name__}: {e}"
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ref_grads, ref = reference_step(cfg, mix, seed, spec, p0, image, label, vs, dev)
    norm_grad = reference_norm_bf16(cfg, mix, seed, spec, p0, image, label, vs, dev)[LEAF]
    norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    med = float(np.median([v for v in norms.values() if v >= 1e-3 * np.median(
        list(norms.values()))]))
    r = ref_grads[LEAF].double().cpu()
    den = max(float(r.norm()), med)

    def gap(a):
        return abs(float(a.double().cpu().norm()) - float(r.norm())) / den

    out = {"seed": seed, "leaf_norm": float(r.norm()), "median_leaf_norm": med,
           "program": gap(grads[LEAF]), "program_dist": _rel(grads[LEAF].cpu(), r)}
    p = {k: v.cpu() / batch for k, v in prog.sums.items()}
    q = {k: v.cpu() / batch for k, v in ref.sums.items()}
    out["kernel_dist"] = _rel(p["kernel"], p[""])
    out["program_inputs"] = gap(p[""])
    out["reference_self_dist"] = _rel(q[""], r)
    for key in ("g_bf16", "xg_bf16", "g_fp8"):
        out[f"ref_{key}"] = gap(q[key])
        out[f"ref_{key}_dist"] = _rel(q[key], r)
    out["ref_norm_bf16"] = gap(norm_grad)
    out["ref_norm_bf16_dist"] = _rel(norm_grad.cpu(), r)
    out["offset_program"] = prog.offset[0] / prog.offset[1]
    out["offset_ref"] = ref.offset[0] / ref.offset[1]
    rl = q["less_offset"]
    out["program_less_offset"] = abs(float(p["less_offset"].norm()) - float(rl.norm())) / den
    out["program_less_offset_dist"] = _rel(p["less_offset"], rl)
    out["ref_g_bf16_less_offset_dist"] = _rel(q["g_bf16less_offset"], rl)
    out["x_dist"] = max(_rel(a.double(), b.double()) for a, b in zip(prog.x, ref.x))
    out["g_dist"] = max(_rel(a.double(), b.double()) for a, b in zip(prog.g, ref.g))
    if isinstance(f32_grad, str):
        out["program_f32"] = f32_grad
    elif f32_grad is not None:
        out["program_f32"] = gap(f32_grad[LEAF])
        out["program_f32_dist"] = _rel(f32_grad[LEAF].cpu(), r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--f32", default="", help="seeds on which the float32 route runs too")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cache_dirs()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg, mix = bench.config(cell), bench.mix(cell)
    f32 = {int(s) for s in filter(None, args.f32.split(","))}
    for seed in map(int, filter(None, args.seeds.split(","))):
        t = time.perf_counter()
        out = witness(cfg, mix, seed, torch.device(args.device), seed in f32)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
