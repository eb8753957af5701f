"""Oren-Nayar diffuse BRDF (full ON'94 direct term) with cosine sampling.

Counterpart of rlshaders_tpu/bsdf/orennayar.py without its qualitative-model
ablation switch. At sigma = 0 the term is exactly Lambert (1/pi). `eval_brdf`
returns f*cos(theta_i) in the local frame (normal = +z).
"""
from __future__ import annotations

import math

import torch

from ..core.vec3 import V3

INV_PI = 1.0 / math.pi


def eval_brdf(roughness, wo: V3, wi: V3) -> torch.Tensor:
    """Scalar f*cos of the albedo-free lobe, sigma in the [0,1] slope
    parameterization."""
    cos_i = wi.z
    cos_o = wo.z
    valid = (cos_i > 0.0) & (cos_o > 0.0)

    s2 = roughness * roughness
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)

    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_o = torch.sqrt(torch.clamp_min(1.0 - cos_o * cos_o, 0.0))
    cos_dphi = torch.where(
        (sin_i > 1e-6) & (sin_o > 1e-6),
        (wi.x * wo.x + wi.y * wo.y) / torch.clamp_min(sin_i * sin_o, 1e-12),
        0.0,
    )
    cos_dphi = torch.clamp(cos_dphi, -1.0, 1.0)

    # alpha = max angle, beta = min angle
    sin_alpha = torch.maximum(sin_i, sin_o)
    cos_beta = torch.maximum(cos_i, cos_o)
    tan_beta = torch.minimum(sin_i, sin_o) / torch.clamp_min(cos_beta, 1e-6)

    alpha = torch.acos(torch.clamp(torch.minimum(cos_i, cos_o), -1.0, 1.0))
    beta = torch.acos(torch.clamp(torch.maximum(cos_i, cos_o), -1.0, 1.0))
    # C2: the negative-cos_dphi branch subtracts (2 beta / pi)^3
    bp = 2.0 * beta / math.pi
    c2 = torch.where(
        cos_dphi >= 0.0,
        b * sin_alpha,
        b * (sin_alpha - bp * (bp * bp)),
    )
    ab = 4.0 * alpha * beta / (math.pi * math.pi)
    c3 = (0.125 * s2 / (s2 + 0.09)) * (ab * ab)
    tan_halfsum = torch.tan(torch.clamp((alpha + beta) * 0.5, 0.0, 1.55))
    f = INV_PI * (
        a
        + c2 * cos_dphi * tan_beta
        + c3 * (1.0 - torch.abs(cos_dphi)) * tan_halfsum
    )
    return torch.where(valid, torch.clamp_min(f, 0.0) * cos_i, 0.0)


def sample_v(rx, ry) -> V3:
    """Cosine-weighted hemisphere sample (local frame) through the
    concentric (Shirley-Chiu) square-to-disk map."""
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
    return V3(x, y, torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0)))
