"""Beckmann (Cook-Torrance) microfacet lobe of the Arnold `standard` shader.

Counterpart of rlshaders_tpu/bsdf/beckmann.py: the default `specular_brdf`
"cook_torrance" of `standard` (Walter et al. EGSR'07 Eq.25-29). Channel-split
`V3` directions in the local frame.
"""
from __future__ import annotations

import math

import torch

from ..core import vec3
from ..core.vec3 import V3

TWO_PI = 2.0 * math.pi


def d_beckmann(m: V3, alpha) -> torch.Tensor:
    """Isotropic Beckmann NDF (Walter Eq.25)."""
    cos2 = torch.clamp(m.z * m.z, 1e-12, 1.0)
    a2 = torch.clamp_min(alpha * alpha, 1e-12)
    d = torch.exp((1.0 - 1.0 / cos2) / a2) / (math.pi * a2 * cos2 * cos2)
    return torch.where(m.z > 0.0, d, 0.0)


def g1(w: V3, m: V3, alpha) -> torch.Tensor:
    """Walter Eq.27 rational approximation of the Beckmann Smith G1."""
    wdotm = vec3.dot(w, m)
    same_side = wdotm * w.z > 0.0
    cosv = torch.clamp(torch.abs(w.z), 1e-6, 1.0)
    tanv = torch.sqrt(torch.clamp_min(1.0 - cosv * cosv, 0.0)) / cosv
    a = 1.0 / torch.clamp_min(alpha * tanv, 1e-9)
    g = torch.where(
        a < 1.6,
        (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
        1.0,
    )
    return torch.where(same_side, g, 0.0)


def gd(wo: V3, wi: V3, alpha) -> torch.Tensor:
    """D * G / (4 cos_o cos_i), the non-Fresnel part of the BRDF."""
    h = vec3.normalize(wo + wi)
    denom = 4.0 * torch.clamp_min(torch.abs(wo.z) * torch.abs(wi.z), 1e-9)
    return d_beckmann(h, alpha) * g1(wo, h, alpha) * g1(wi, h, alpha) / denom


def sample(wo: V3, alpha, rx, ry) -> V3:
    """Draw a microfacet normal from the full NDF (Walter Eq.28-29) and
    mirror wo about it."""
    a2 = torch.clamp_min(alpha * alpha, 1e-12)
    tan2 = -a2 * torch.log(torch.clamp_min(1.0 - rx, 1e-12))
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * ry
    m = V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    return m * (2.0 * vec3.dot(wo, m)) - wo


def pdf(wo: V3, wi: V3, alpha) -> torch.Tensor:
    """pdf of `sample` over wi: D(h)*|h.z| / (4 |wi.h|)."""
    h = vec3.normalize(wo + wi)
    idoth = torch.clamp_min(torch.abs(vec3.dot(wi, h)), 1e-9)
    return d_beckmann(h, alpha) * torch.abs(h.z) / (4.0 * idoth)
