"""Light sampling with solid-angle pdfs for MIS: quad lights and the dome.

Counterpart of the flat channel-split API of rlshaders_tpu/integrator/
lights.py that the wavefront uses: one light per call, the sample axis
flattened into the batch. Quad lights emit along -normal (Arnold quads);
the dome is sampled cosine-weighted about the shading normal. Disk lights
and the lights-as-an-axis functions are later work.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..bsdf.orennayar import sample_v
from ..core import vec3
from ..core.frame import build_frame_polar_v, to_world_v
from ..core.vec3 import V3

INV_PI = 1.0 / math.pi


class LightSampleV(NamedTuple):
    direction: V3          # unit, shading point -> light
    dist: torch.Tensor     # (M,)
    radiance: V3           # emitted radiance toward the point
    pdf: torch.Tensor      # (M,) solid-angle pdf (0 = invalid)


def mis_weight(pdf_a, pdf_b):
    """Balance heuristic."""
    return pdf_a / torch.clamp_min(pdf_a + pdf_b, 1e-12)


def _row(a: torch.Tensor) -> V3:
    return V3(a[0], a[1], a[2])


def sample_quad_flat(verts_l, normal_l, area_l, radiance_l, p: V3,
                     u: torch.Tensor) -> LightSampleV:
    """Uniform-area sample of one (parallelogram) quad light; verts_l
    (4, 3), p V3 of (M,), u (M, 2) uniforms."""
    v0, e1, e2 = verts_l[0], verts_l[1] - verts_l[0], verts_l[3] - verts_l[0]
    u1, u2 = u[..., 0], u[..., 1]
    q = V3(
        v0[0] + u1 * e1[0] + u2 * e2[0],
        v0[1] + u1 * e1[1] + u2 * e2[1],
        v0[2] + u1 * e1[2] + u2 * e2[2],
    )
    to_l = q - p
    dist2 = torch.clamp_min(vec3.dot(to_l, to_l), 1e-12)
    dist = torch.sqrt(dist2)
    wi = to_l * (1.0 / dist)
    cos_l = -vec3.dot(wi, _row(normal_l))
    visible = cos_l > 1e-6
    pdf = dist2 / torch.clamp_min(torch.abs(cos_l) * area_l, 1e-12)
    return LightSampleV(
        direction=wi,
        dist=dist,
        radiance=vec3.where(visible, _row(radiance_l) * torch.ones_like(dist),
                            0.0),
        pdf=torch.where(visible, pdf, 0.0),
    )


def sample_sky_flat(radiance, nf: V3, u: torch.Tensor) -> LightSampleV:
    """Cosine-hemisphere sample about nf (V3 of (M,)); u (M, 2)."""
    local = sample_v(u[..., 0], u[..., 1])
    wi = to_world_v(build_frame_polar_v(nf), local)
    pdf = torch.clamp_min(torch.clamp_min(local.z, 0.0) * INV_PI, 1e-9)
    return LightSampleV(
        direction=wi,
        dist=torch.full_like(pdf, 1e30),
        radiance=_row(radiance) * torch.ones_like(pdf),
        pdf=pdf,
    )


def intersect_quad_flat(verts_l, normal_l, p: V3, wi: V3):
    """Ray-quad hit for the BSDF-sampling strategy; returns (hit, t)."""
    v0 = _row(verts_l[0])
    e1 = verts_l[1] - verts_l[0]
    e2 = verts_l[3] - verts_l[0]
    nl = _row(normal_l)
    denom = vec3.dot(wi, nl)
    t = vec3.dot(v0 - p, nl) / torch.where(torch.abs(denom) < 1e-9, 1e-9,
                                           denom)
    q = p + wi * t - v0
    len1 = torch.clamp_min(e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2],
                           1e-12)
    len2 = torch.clamp_min(e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2],
                           1e-12)
    a = vec3.dot(q, _row(e1)) / len1
    b = vec3.dot(q, _row(e2)) / len2
    hit = (
        (t > 1e-4)
        & (a >= 0.0) & (a <= 1.0)
        & (b >= 0.0) & (b <= 1.0)
        & (-vec3.dot(wi, nl) > 1e-6)  # emission side only
    )
    return hit, t


def pdf_sky_v(n: V3, wi: V3) -> torch.Tensor:
    return torch.clamp_min(vec3.dot(n, wi), 0.0) * INV_PI
