"""Frozen copy of unet_studio_tpu_torch/models/dsl.py (the architecture
DSL parser), kept here so that the reference and the cost arithmetic
read the configuration without importing the program.

Architecture DSL parser.

Grammar (reference: unet.cpp:24-101): the architecture string is a list of
lines, one per resolution level; the first ``n//2 + 1`` lines are encoder
levels, the rest decoder levels (unet.cpp:118).  Each line is ``+``-joined
layer tokens; each token is a comma-separated list of words, each word an
op name with an optional trailing integer (``conv16`` -> op ``conv``,
arg 16).

Ops: ``conv`` (ks 1/3, stride 1/2 constrained), ``conv_trans`` (ks2 stride2
only), ``max_pool``, ``upsample``, ``norm`` (InstanceNorm affine), ``bnorm``
(BatchNorm eps=0); optional activation word ``relu``/``leaky_relu``/``elu``
appended to the same token.

The final token of the last decoder line is the deep-supervision head
token; wherever it appears in a decoder line it splits that level into
``decoding`` (before), ``output`` (the 1x1x1 head), and ``decoding_tail``
(after, usually the ``conv_trans`` upsampler) (unet.cpp:138-158).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class LayerSpec:
    kind: str  # conv | conv_trans | max_pool | upsample | norm | bnorm
    in_c: int
    out_c: int
    ks: int = 1
    stride: int = 1
    act: str | None = None  # relu | leaky_relu | elu

    @property
    def has_params(self) -> bool:
        return self.kind in ("conv", "conv_trans", "norm", "bnorm")


@dataclass(frozen=True)
class UNetSpec:
    in_count: int
    out_count: int
    architecture: str
    encoders: tuple[tuple[LayerSpec, ...], ...]
    decoders: tuple[tuple[LayerSpec, ...], ...]
    heads: tuple[tuple[LayerSpec, ...], ...]
    tails: tuple[tuple[LayerSpec, ...], ...]

    @property
    def n_levels(self) -> int:
        return len(self.encoders)

    def module_names(self):
        """Module names in LibTorch registration order (unet.cpp:130,160-164).

        This order defines the positional tensor0..tensorN layout of .nz
        files: encode0..encodeN, then for level n_dec-1 .. 0:
        decode{level}, output{level} (if any), decode_tail{level} (if any).
        """
        names = [(f"encode{i}", self.encoders[i]) for i in range(len(self.encoders))]
        for level in range(len(self.decoders) - 1, -1, -1):
            names.append((f"decode{level}", self.decoders[level]))
            if self.heads[level]:
                names.append((f"output{level}", self.heads[level]))
            if self.tails[level]:
                names.append((f"decode_tail{level}", self.tails[level]))
        return names


_WORD_RE = re.compile(r"^([a-z_]+)(\d*)$")


def _parse_token(token: str, in_c: int) -> tuple[LayerSpec, int]:
    """Parse one comma-joined token into a LayerSpec (unet.cpp:24-101)."""
    params: dict[str, int] = {}
    order: list[str] = []
    for word in token.split(","):
        word = word.strip()
        if not word:
            continue
        m = _WORD_RE.match(word)
        if not m:
            raise ValueError(f"cannot parse token word {word!r}")
        params[m.group(1)] = int(m.group(2)) if m.group(2) else 1
        order.append(m.group(1))

    act = None
    for a in ("relu", "leaky_relu", "elu"):
        if a in params:
            act = a
            break

    out_c = in_c
    if "max_pool" in params:
        spec = LayerSpec("max_pool", in_c, in_c, ks=2, stride=2, act=act)
    elif "upsample" in params:
        spec = LayerSpec("upsample", in_c, in_c, ks=2, stride=2, act=act)
    elif "conv_trans" in params:
        out_c = params["conv_trans"]
        ks = params.get("ks", 2)
        stride = params.get("stride", 2)
        if ks != 2 or stride != 2:
            raise ValueError("conv_trans supports only ks2 stride2")
        spec = LayerSpec("conv_trans", in_c, out_c, ks=2, stride=2, act=act)
    elif "conv" in params:
        out_c = params["conv"]
        ks = params.get("ks", 3)
        stride = params.get("stride", 1)
        if not ((ks == 1 and stride == 1) or (ks == 3 and stride in (1, 2))):
            raise ValueError(
                "conv supports only ks1 stride1, ks3 stride1, and ks3 stride2"
            )
        spec = LayerSpec("conv", in_c, out_c, ks=ks, stride=stride, act=act)
    elif "norm" in params:
        spec = LayerSpec("norm", in_c, in_c, act=act)
    elif "bnorm" in params:
        spec = LayerSpec("bnorm", in_c, in_c, act=act)
    else:
        unknown = order[0] if order else token
        raise ValueError(f"unknown layer: {unknown}")
    return spec, out_c


def parse_architecture(in_count: int, out_count: int, architecture: str) -> UNetSpec:
    """Build a UNetSpec from the architecture string (unet.cpp:103-166)."""
    lines = [ln.strip() for ln in architecture.replace("\r", "\n").split("\n")]
    lines = [ln for ln in lines if ln]
    if len(lines) < 3:
        raise ValueError("invalid u-net structure")
    enc_count = len(lines) // 2 + 1
    enc_lines, dec_lines = lines[:enc_count], lines[enc_count:]

    encoders: list[tuple[LayerSpec, ...]] = []
    skip_channels: list[int] = []
    channel = in_count
    for line in enc_lines:
        layers = []
        for token in line.split("+"):
            spec, channel = _parse_token(token, channel)
            layers.append(spec)
        encoders.append(tuple(layers))
        skip_channels.append(channel)

    n_dec = len(dec_lines)
    decoders: list[tuple[LayerSpec, ...] | None] = [None] * n_dec
    heads: list[tuple[LayerSpec, ...]] = [()] * n_dec
    tails: list[tuple[LayerSpec, ...]] = [()] * n_dec

    out_token = dec_lines[-1].split("+")[-1]
    for level in range(n_dec - 1, -1, -1):
        tokens = dec_lines[n_dec - 1 - level].split("+")
        channel += skip_channels[level]
        body: list[LayerSpec] = []
        tail: list[LayerSpec] = []
        head: list[LayerSpec] = []
        after_out = False
        for token in tokens:
            if token == out_token:
                spec, _ = _parse_token(token, channel)
                head.append(spec)
                after_out = True
                continue
            spec, channel = _parse_token(token, channel)
            (tail if after_out else body).append(spec)
        decoders[level] = tuple(body)
        heads[level] = tuple(head)
        tails[level] = tuple(tail)

    return UNetSpec(
        in_count=in_count,
        out_count=out_count,
        architecture=architecture,
        encoders=tuple(encoders),
        decoders=tuple(decoders),
        heads=tuple(heads),
        tails=tuple(tails),
    )

