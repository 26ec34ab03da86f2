"""Frozen copy of unet_studio_tpu_torch/ops/perlin.py.

Perlin gradient noise (the counterpart of the JAX package's
unet_studio_tpu/ops/perlin.py; reference:
visual_perception_augmentation.cpp:110-155).

The lattice hash is the JAX package's integer mix (uint32 arithmetic), in
place of the reference's 256-entry permutation table, feeding the classic
12-direction gradient function; both packages give the same field for the
same seed.  torch has little uint32 arithmetic, so the hash runs in int64
on values below 2^32, each 32-bit product taken in two 16-bit halves so
that no int64 product overflows.  The 8 lattice corners go through the
hash together, stacked on a leading axis.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit ``c``."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash3(xi: torch.Tensor, yi: torch.Tensor, zi: torch.Tensor, seed: int) -> torch.Tensor:
    """Integer mix of lattice coordinates (int64, any sign) -> uint32
    values as int64."""
    h = (_mul32(xi & _M32, 0x9E3779B1) ^ _mul32(yi & _M32, 0x85EBCA77)
         ^ _mul32(zi & _M32, 0xC2B2AE3D) ^ (int(seed) & _M32))
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    return h ^ (h >> 15)


def _grad(h: torch.Tensor, x, y, z) -> torch.Tensor:
    """The classic Perlin gradient function (12 directions),
    visual_perception_augmentation.cpp:112-117."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where(h & 1 == 0, u, -u) + torch.where(h & 2 == 0, v, -v)


def _fade(t: torch.Tensor) -> torch.Tensor:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3(coords: torch.Tensor, seed: int) -> torch.Tensor:
    """coords (..., 3) f32 (x, y, z) -> noise (...) in about [-1, 1]."""
    x, y, z = coords.unbind(-1)
    fx, fy, fz = torch.floor(x), torch.floor(y), torch.floor(z)
    xf, yf, zf = x - fx, y - fy, z - fz
    u, v, w = _fade(xf), _fade(yf), _fade(zf)
    # the 8 corners stacked on axis 0, order (dz, dy, dx)
    shape = (8,) + (1,) * x.dim()
    corner = torch.arange(8, device=x.device).reshape(shape)
    dz, dy, dx = corner >> 2, (corner >> 1) & 1, corner & 1
    h = _hash3(fx.long() + dx, fy.long() + dy, fz.long() + dz, seed)
    g = _grad(h, xf - dx.to(x.dtype), yf - dy.to(x.dtype), zf - dz.to(x.dtype))

    def lerp(t, a, b):
        return a + t * (b - a)

    x1 = lerp(u, g[0], g[1])
    x2 = lerp(u, g[2], g[3])
    y1 = lerp(v, x1, x2)
    x1 = lerp(u, g[4], g[5])
    x2 = lerp(u, g[6], g[7])
    y2 = lerp(v, x1, x2)
    return lerp(w, y1, y2)


def perlin_octaves(shape_dhw, zoom: torch.Tensor, seed: int, octaves: int = 4,
                   device=None) -> torch.Tensor:
    """4-octave fractal noise on the (D, H, W) grid, then the fractional
    part of twice it (visual_perception_augmentation.cpp:392-411).
    ``zoom`` is an f32 scalar."""
    from .resample import meshgrid_xyz

    coords = meshgrid_xyz(shape_dhw, device)
    zoom = torch.as_tensor(zoom, dtype=torch.float32, device=coords.device)
    out = None
    for octave in range(octaves):
        p = 0.5**octave
        term = perlin3(coords * (zoom * p), seed) * p
        out = term if out is None else out + term
    out = out * 2.0
    return out - torch.floor(out)
