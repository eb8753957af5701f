"""Channel-split 3-vectors: a vector is three (M,) tensors.

Counterpart of rlshaders_tpu/core/vec3.py, kept in the same layout so the
shading code ports line by line. Whether an (M, 3) layout is faster on the
GPU is a question for a measured later change.

`V3` is a NamedTuple with arithmetic operators; scalars and (M,) tensors
broadcast per channel. `v3` / `V3.aos` convert from/to (..., 3) tensors at
the edges (ray queries, framebuffer splat, host I/O).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def aos(self) -> torch.Tensor:
        """(..., 3) tensor of this vector."""
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z),
                           dim=-1)


def v3(a: torch.Tensor) -> V3:
    """(..., 3) tensor -> V3 of (...,) channels."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def normalize(a: V3, eps: float = 1e-20) -> V3:
    inv = torch.rsqrt(torch.clamp_min(dot(a, a), eps))
    return V3(a.x * inv, a.y * inv, a.z * inv)


def reflect(w: V3, n: V3) -> V3:
    """Mirror w about n: 2(w.n)n - w."""
    k = 2.0 * dot(w, n)
    return V3(k * n.x - w.x, k * n.y - w.y, k * n.z - w.z)


def _sel(mask, a, b):
    return torch.where(mask, a, b)


def where(mask, a, b) -> V3:
    """Componentwise select; a/b may be V3 or scalar-like."""
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(_sel(mask, ax, bx), _sel(mask, ay, by), _sel(mask, az, bz))


def maxc(a: V3) -> torch.Tensor:
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def vmax(a: V3, b: V3) -> V3:
    """Componentwise maximum."""
    return V3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
              torch.maximum(a.z, b.z))


def luminance(a: V3) -> torch.Tensor:
    """Rec.709 luma (colorToLuminance, rlUtil.h:36-39)."""
    return 0.2126 * a.x + 0.7152 * a.y + 0.0722 * a.z


def clip(a: V3, lo: float, hi: float) -> V3:
    return V3(torch.clamp(a.x, lo, hi), torch.clamp(a.y, lo, hi),
              torch.clamp(a.z, lo, hi))


def tile(a: V3, k: int) -> V3:
    """Repeat the batch k times (column-major chunks: [a; a; ...])."""
    return V3(a.x.repeat(k), a.y.repeat(k), a.z.repeat(k))


def ksum(a: V3, k: int) -> V3:
    """Sum k column-major chunks back down to the base batch."""
    n = a.x.shape[0] // k
    return V3(
        a.x.reshape(k, n).sum(0),
        a.y.reshape(k, n).sum(0),
        a.z.reshape(k, n).sum(0),
    )


def kmean(a: V3, k: int) -> V3:
    s = ksum(a, k)
    inv = 1.0 / k
    return V3(s.x * inv, s.y * inv, s.z * inv)
