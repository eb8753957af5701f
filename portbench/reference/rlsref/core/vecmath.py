"""Batched (..., 3) vector math: the AoS helpers the ported slices use.

Counterpart of rlshaders_tpu/core/vecmath.py. The camera and the SSS probe
stage, which the JAX package writes on (..., 3) arrays, use these; the
shading code uses the channel-split `core.vec3`. The component sums run in
the order x, y, z, as XLA's reduction over a trailing axis of 3 does.
"""
from __future__ import annotations

import math

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing component axis (keeps no dims)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: returns v/|v|, or 0 for (near-)zero vectors."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.where(
        n2 > eps, 1.0 / torch.sqrt(torch.clamp_min(n2, eps)), 0.0)


def concentric_disk_sample(rx: torch.Tensor, ry: torch.Tensor):
    """Shirley-Chiu concentric square-to-disk map, safe at the origin;
    returns the disk point as (x, y)."""
    ox = rx * 2.0 - 1.0
    oy = ry * 2.0 - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    r = torch.where(use_x, ox, oy)
    phi = torch.where(
        use_x,
        (math.pi / 4.0) * (oy / safe_ox),
        (math.pi / 2.0) * (1.0 - 0.5 * ox / safe_oy),
    )
    degenerate = (ox == 0.0) & (oy == 0.0)
    x = torch.where(degenerate, 0.0, r * torch.cos(phi))
    y = torch.where(degenerate, 0.0, r * torch.sin(phi))
    return x, y


def cosine_sample_hemisphere(rx: torch.Tensor,
                             ry: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted local (+z) hemisphere direction, (..., 3), through
    the concentric disk map."""
    x, y = concentric_disk_sample(rx, ry)
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    return torch.stack([x, y, z], dim=-1)


def linearstep(lo, hi, x):
    """Linear remap of x from [lo, hi] to [0, 1], clamped."""
    return torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
