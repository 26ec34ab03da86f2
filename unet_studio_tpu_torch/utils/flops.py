"""Analytic FLOPs and bytes of the U-Net forward pass, and the card's
published peaks (the counterpart of unet_studio_tpu/utils/flops.py), for
reporting a time beside the least time the card could take.

The walker follows ``models.unet3d.forward``'s traversal (encoder sweep
with skips, decoder levels with head and tail), so each layer's spatial
dimensions are the real ones.
"""

from __future__ import annotations

import math

from ..models.dsl import LayerSpec, UNetSpec

# (dense bf16 tensor-core FLOP/s, HBM bytes/s) per card, from NVIDIA's
# published H100 data sheet (SXM and PCIe parts)
_CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "NVIDIA H100": (989e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
}


def chip_peaks(device_name: str) -> tuple[float, float] | None:
    """(peak bf16 FLOP/s, peak HBM bytes/s) for a
    ``torch.cuda.get_device_name()``, the longest matching prefix first;
    None for a card the table does not know."""
    for k in sorted(_CHIP_PEAKS, key=len, reverse=True):
        if device_name.startswith(k):
            return _CHIP_PEAKS[k]
    return None


def _layer_cost(layer: LayerSpec, dims: list[int], bytes_per_el: int):
    """(flops, hbm_bytes, out_dims) for one layer at input spatial dims.

    FLOPs: 2*MACs for conv/conv_trans (the matrix-unit terms; norm, act
    and pool count 0 FLOPs: they are bandwidth work).
    Bytes: one read of the input, one write of the output and the weights
    (the lower bound of a fused implementation)."""
    vox_in = math.prod(dims)
    if layer.kind == "conv":
        out_dims = [d // layer.stride for d in dims] if layer.stride == 2 else dims
        vox_out = math.prod(out_dims)
        flops = 2 * vox_out * layer.ks**3 * layer.in_c * layer.out_c
        wbytes = layer.ks**3 * layer.in_c * layer.out_c * bytes_per_el
        return (
            flops,
            (vox_in * layer.in_c + vox_out * layer.out_c) * bytes_per_el + wbytes,
            out_dims,
        )
    if layer.kind == "conv_trans":
        out_dims = [d * 2 for d in dims]
        flops = 2 * vox_in * 8 * layer.in_c * layer.out_c
        wbytes = 8 * layer.in_c * layer.out_c * bytes_per_el
        return (
            flops,
            (vox_in * layer.in_c + math.prod(out_dims) * layer.out_c) * bytes_per_el
            + wbytes,
            out_dims,
        )
    if layer.kind == "max_pool":
        return 0, 2 * vox_in * layer.in_c * bytes_per_el, [d // 2 for d in dims]
    if layer.kind == "upsample":
        out_dims = [d * 2 for d in dims]
        return (
            0,
            (vox_in + math.prod(out_dims)) * layer.in_c * bytes_per_el,
            out_dims,
        )
    # norm/bnorm: ~2 reads + 1 write (stats pass fused to one read here)
    return 0, 3 * vox_in * layer.in_c * bytes_per_el, dims


def forward_cost(spec: UNetSpec, dhw, bytes_per_el: int = 2) -> tuple[int, int]:
    """(flops, hbm_bytes) of one forward pass at grid ``dhw`` (batch 1),
    walking encoders/decoders/heads/tails exactly as forward() does."""
    flops = 0
    bbytes = 0

    def run_seq(layers, dims):
        nonlocal flops, bbytes
        for layer in layers:
            f, b, dims = _layer_cost(layer, dims, bytes_per_el)
            flops += f
            bbytes += b
        return dims

    n_enc = len(spec.encoders)
    dims = list(dhw)
    skip_dims = []
    for level in range(n_enc):
        dims = run_seq(spec.encoders[level], dims)
        if level < n_enc - 1:
            skip_dims.append(dims)

    for level in range(n_enc - 2, -1, -1):
        dims = skip_dims[level]  # cat(skip, up) — same spatial dims
        dims = run_seq(spec.decoders[level], dims)
        if spec.heads[level]:
            run_seq(spec.heads[level], dims)
        if spec.tails[level]:
            dims = run_seq(spec.tails[level], dims)
    return flops, bbytes


def train_step_flops(spec: UNetSpec, dhw, bytes_per_el: int = 2) -> int:
    """Model FLOPs of one fwd+bwd item: backward costs ~2x forward
    (dL/dx and dL/dw are each one conv-sized contraction per conv)."""
    f, _ = forward_cost(spec, dhw, bytes_per_el)
    return 3 * f
