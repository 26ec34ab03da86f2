"""The benchmark's frozen cost arithmetic: the operations and bytes of the
U-Net's forward and backward work from the layer shapes, and the card's
published peaks.  Copied from unet_studio_tpu_torch/utils/flops.py
(``_layer_cost``, ``forward_cost``, the peak table) and extended with
the backward; later changes to the program do not change it.

A layer's least time is the larger of FLOPs / peak FLOP/s and bytes /
peak bytes/s.  FLOPs count 2 per multiply-add of the convs; norms,
activations and pools are bandwidth work of 0 FLOPs.  Bytes count one
read of each input, one write of each output and the weights: the work
whatever implements it.
"""

from __future__ import annotations

import math

from .reference.dsl import LayerSpec, UNetSpec

# (dense bf16 tensor-core FLOP/s, HBM bytes/s) per card, NVIDIA's
# published H100 data sheet (SXM and PCIe parts)
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "NVIDIA H100": (989e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
}


def chip_peaks(device_name: str) -> tuple[float, float] | None:
    """(peak bf16 FLOP/s, peak bytes/s) of a ``torch.cuda.get_device_name()``,
    the longest matching prefix first; None for a card not in the table."""
    for k in sorted(CHIP_PEAKS, key=len, reverse=True):
        if device_name.startswith(k):
            return CHIP_PEAKS[k]
    return None


def layer_cost(layer: LayerSpec, dims: list[int], bytes_per_el: int):
    """(flops, bytes, out_dims) of one layer's forward at input dims."""
    vox_in = math.prod(dims)
    if layer.kind == "conv":
        out_dims = [d // layer.stride for d in dims] if layer.stride == 2 else dims
        vox_out = math.prod(out_dims)
        flops = 2 * vox_out * layer.ks**3 * layer.in_c * layer.out_c
        wbytes = layer.ks**3 * layer.in_c * layer.out_c * bytes_per_el
        return (flops, (vox_in * layer.in_c + vox_out * layer.out_c) * bytes_per_el + wbytes,
                out_dims)
    if layer.kind == "conv_trans":
        out_dims = [d * 2 for d in dims]
        flops = 2 * vox_in * 8 * layer.in_c * layer.out_c
        wbytes = 8 * layer.in_c * layer.out_c * bytes_per_el
        return (flops, (vox_in * layer.in_c + math.prod(out_dims) * layer.out_c) * bytes_per_el
                + wbytes, out_dims)
    if layer.kind == "max_pool":
        return 0, 2 * vox_in * layer.in_c * bytes_per_el, [d // 2 for d in dims]
    if layer.kind == "upsample":
        out_dims = [d * 2 for d in dims]
        return 0, (vox_in + math.prod(out_dims)) * layer.in_c * bytes_per_el, out_dims
    # norm: a statistics read, a read and a write (the activation fused)
    return 0, 3 * vox_in * layer.in_c * bytes_per_el, dims


def backward_cost(layer: LayerSpec, dims: list[int], bytes_per_el: int, need_dx: bool):
    """(flops, bytes) of one layer's backward at input dims: for a conv the
    input gradient (read g and the weights, write dx; skipped where no
    input needs a gradient) and the weight gradient (read x and g, write
    dW), each as many FLOPs as the forward; for a norm the sums of g and
    g * xhat (read g and x) and dx (read g and x, write dx); for a pool or
    an upsample g read and dx written."""
    f, b, out_dims = layer_cost(layer, dims, bytes_per_el)
    vox_in, vox_out = math.prod(dims), math.prod(out_dims)
    if layer.kind in ("conv", "conv_trans"):
        k3 = layer.ks**3 if layer.kind == "conv" else 8
        w = k3 * layer.in_c * layer.out_c * bytes_per_el
        x_b, g_b = vox_in * layer.in_c * bytes_per_el, vox_out * layer.out_c * bytes_per_el
        flops, nbytes = f, x_b + g_b + w  # dW
        if need_dx:
            flops, nbytes = flops + f, nbytes + g_b + w + x_b
        return flops, nbytes
    if layer.kind == "norm":
        return 0, 5 * vox_in * layer.in_c * bytes_per_el
    return 0, (vox_in + vox_out) * layer.in_c * bytes_per_el


def walk(spec: UNetSpec, dhw, heads: str = "all"):
    """Yield (layer, input dims) in the forward's order (encoders with
    skips, then decoder levels with their head and tail); ``heads="level0"``
    skips the heads of the other levels, as inference does."""
    n_enc = len(spec.encoders)
    dims = list(dhw)
    skip_dims = []
    for level in range(n_enc):
        for layer in spec.encoders[level]:
            yield layer, dims
            dims = layer_cost(layer, dims, 2)[2]
        if level < n_enc - 1:
            skip_dims.append(dims)
    for level in range(n_enc - 2, -1, -1):
        dims = skip_dims[level]
        for layer in spec.decoders[level]:
            yield layer, dims
            dims = layer_cost(layer, dims, 2)[2]
        if spec.heads[level] and (heads == "all" or level == 0):
            hd = dims
            for layer in spec.heads[level]:
                yield layer, hd
                hd = layer_cost(layer, hd, 2)[2]
        for layer in spec.tails[level]:
            yield layer, dims
            dims = layer_cost(layer, dims, 2)[2]


def forward_cost(spec: UNetSpec, dhw, bytes_per_el: int = 2, heads: str = "all"):
    """(flops, bytes) of one forward at grid ``dhw``, batch 1."""
    flops = nbytes = 0
    for layer, dims in walk(spec, dhw, heads):
        f, b, _ = layer_cost(layer, dims, bytes_per_el)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def least_seconds(spec: UNetSpec, dhw, peaks, bytes_per_el: int = 2, train: bool = True):
    """The least time of one item's forward (and, with ``train``,
    backward) work: per layer the larger of its FLOPs over the peak FLOP/s
    and its bytes over the peak bytes/s, summed.  The first conv reads
    the image, which needs no gradient, so it has no input gradient."""
    peak_f, peak_b = peaks
    total = 0.0
    first = True
    for layer, dims in walk(spec, dhw):
        f, b, _ = layer_cost(layer, dims, bytes_per_el)
        total += max(f / peak_f, b / peak_b)
        if train:
            bf, bb = backward_cost(layer, dims, bytes_per_el, need_dx=not first)
            total += max(bf / peak_f, bb / peak_b)
        if layer.kind == "conv":
            first = False
    return total
