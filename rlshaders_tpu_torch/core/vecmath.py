"""Batched (..., 3) vector math: the AoS helpers the ported slice uses.

Counterpart of rlshaders_tpu/core/vecmath.py. Only what the camera needs
is ported; the shading code uses the channel-split `core.vec3` instead.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: returns v/|v|, or 0 for (near-)zero vectors."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.where(
        n2 > eps, 1.0 / torch.sqrt(torch.clamp_min(n2, eps)), 0.0)
