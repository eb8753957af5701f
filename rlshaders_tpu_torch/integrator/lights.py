"""Light sampling with solid-angle pdfs for MIS: quad and disk lights and
the dome.

Counterpart of rlshaders_tpu/integrator/lights.py: the flat channel-split
API the wavefront uses (one light per call, the sample axis flattened into
the batch), and the row forms on (..., 3) tensors that the SSS stage's
probe-hit lighting uses (lights as an axis: (N, L, S, ...)). The two forms
round differently (the row form divides by the distance where the flat one
multiplies by its reciprocal), so each caller keeps the JAX package's.
Quad and disk lights emit along -normal (Arnold's); a disk is sampled
uniformly over its area (r = sqrt(u1), phi = 2 pi u2 on its radius-scaled
u, v axes); the dome is sampled cosine-weighted about the shading normal.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..bsdf.orennayar import sample_v
from ..core import tracer, vec3
from ..core.frame import (
    build_frame_polar, build_frame_polar_v, to_world, to_world_v,
)
from ..core.vec3 import V3
from ..core.vecmath import cosine_sample_hemisphere, dot

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


@tracer.traced("light")
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


@tracer.traced("light")
def sample_disk_flat(center_l, uax_l, vax_l, normal_l, area_l, radiance_l,
                     p: V3, u: torch.Tensor) -> LightSampleV:
    """Uniform-area sample of one disk light; p V3 of (M,), u (M, 2)."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    cu = r * torch.cos(phi)
    cv = r * torch.sin(phi)
    q = V3(
        center_l[0] + cu * uax_l[0] + cv * vax_l[0],
        center_l[1] + cu * uax_l[1] + cv * vax_l[1],
        center_l[2] + cu * uax_l[2] + cv * vax_l[2],
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


@tracer.traced("light")
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


def intersect_disk_flat(center_l, uax_l, vax_l, normal_l, p: V3, wi: V3):
    """Ray-disk hit for the BSDF-sampling strategy; returns (hit, t)."""
    nl = _row(normal_l)
    denom = vec3.dot(wi, nl)
    t = vec3.dot(_row(center_l) - p, nl) / torch.where(
        torch.abs(denom) < 1e-9, 1e-9, denom)
    q = p + wi * t - _row(center_l)
    len_u = torch.clamp_min(torch.dot(uax_l, uax_l), 1e-12)
    len_v = torch.clamp_min(torch.dot(vax_l, vax_l), 1e-12)
    a = vec3.dot(q, _row(uax_l)) / len_u
    b = vec3.dot(q, _row(vax_l)) / len_v
    hit = (t > 1e-4) & (a * a + b * b <= 1.0) & (-vec3.dot(wi, nl) > 1e-6)
    return hit, t


def pdf_sky_v(n: V3, wi: V3) -> torch.Tensor:
    return torch.clamp_min(vec3.dot(n, wi), 0.0) * INV_PI


# ---------------------------------------------------------------------------
# Row forms: (..., 3) tensors, lights as an axis
# ---------------------------------------------------------------------------


class LightSample(NamedTuple):
    direction: torch.Tensor  # (..., 3) unit, shading point -> light
    dist: torch.Tensor       # (...,)
    radiance: torch.Tensor   # (..., 3)
    pdf: torch.Tensor        # (...,) solid-angle pdf (0 = invalid)


def _area_sample(to_l, normal, area, radiance) -> LightSample:
    """The sample toward an area-light point `to_l` away (rows)."""
    dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
    dist = torch.sqrt(dist2)
    wi = to_l / dist[..., None]
    cos_l = dot(-wi, normal)
    visible = cos_l > 1e-6
    pdf = dist2 / torch.clamp_min(torch.abs(cos_l) * area, 1e-12)
    return LightSample(
        direction=wi,
        dist=dist,
        radiance=torch.where(visible[..., None], radiance, 0.0),
        pdf=torch.where(visible, pdf, 0.0),
    )


@tracer.traced("light")
def sample_quads_batched(verts, normal, area, radiance, p,
                         u) -> LightSample:
    """verts (L, 4, 3), p (N, 3), u (N, L, S, 2) -> fields (N, L, S, ...)."""
    e1 = (verts[:, 1] - verts[:, 0])[None, :, None]
    e2 = (verts[:, 3] - verts[:, 0])[None, :, None]
    q = verts[None, :, None, 0] + u[..., 0:1] * e1 + u[..., 1:2] * e2
    return _area_sample(q - p[:, None, None, :], normal[None, :, None],
                        area[None, :, None], radiance[None, :, None])


@tracer.traced("light")
def sample_disk(center, u, v, normal, area, radiance, p, u1,
                u2) -> LightSample:
    """Uniform-area sample of one disk light at rows p (..., 3)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    q = (center + (r * torch.cos(phi))[..., None] * u
         + (r * torch.sin(phi))[..., None] * v)
    return _area_sample(q - p, normal, area, radiance)


@tracer.traced("light")
def sample_disks_batched(center, uax, vax, normal, area, radiance, p,
                         u) -> LightSample:
    """center (L, 3), p (N, 3), u (N, L, S, 2) -> fields (N, L, S, ...)."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    q = (center[None, :, None]
         + (r * torch.cos(phi))[..., None] * uax[None, :, None]
         + (r * torch.sin(phi))[..., None] * vax[None, :, None])
    return _area_sample(q - p[:, None, None, :], normal[None, :, None],
                        area[None, :, None], radiance[None, :, None])


@tracer.traced("light")
def sample_sky_batched(radiance, nf, u) -> LightSample:
    """nf (N, 3), u (N, 1, S, 2) -> (N, 1, S, ...) cosine samples about nf."""
    local = cosine_sample_hemisphere(u[..., 0], u[..., 1])
    wi = to_world(build_frame_polar(nf[:, None, None, :]), local)
    pdf = torch.clamp_min(torch.clamp_min(local[..., 2], 0.0) * INV_PI, 1e-9)
    return LightSample(
        direction=wi,
        dist=torch.full_like(pdf, 1e30),
        radiance=torch.broadcast_to(radiance, wi.shape),
        pdf=pdf,
    )


def intersect_quad(verts, normal, p, wi):
    """Ray-quad hit of rows p, wi (N, 3) against one light's verts (4, 3):
    (hit, t)."""
    e1 = verts[1] - verts[0]
    e2 = verts[3] - verts[0]
    denom = dot(wi, normal)
    t = dot(verts[0] - p, normal) / torch.where(torch.abs(denom) < 1e-9,
                                                1e-9, denom)
    q = p + wi * t[..., None] - verts[0]
    len1 = torch.clamp_min(dot(e1, e1), 1e-12)
    len2 = torch.clamp_min(dot(e2, e2), 1e-12)
    a = dot(q, e1) / len1
    b = dot(q, e2) / len2
    hit = (
        (t > 1e-4)
        & (a >= 0.0) & (a <= 1.0)
        & (b >= 0.0) & (b <= 1.0)
        & (dot(-wi, normal) > 1e-6)  # emission side only
    )
    return hit, t


def intersect_disk(center, u, v, normal, p, wi):
    """Ray-disk hit of rows p, wi (N, 3) against one disk light: (hit, t)."""
    denom = dot(wi, normal)
    t = dot(center - p, normal) / torch.where(torch.abs(denom) < 1e-9, 1e-9,
                                              denom)
    q = p + wi * t[..., None] - center
    a = dot(q, u) / torch.clamp_min(dot(u, u), 1e-12)
    b = dot(q, v) / torch.clamp_min(dot(v, v), 1e-12)
    hit = (t > 1e-4) & (a * a + b * b <= 1.0) & (dot(-wi, normal) > 1e-6)
    return hit, t


def pdf_quad(verts, normal, area, p, wi, t):
    """Solid-angle pdf of the area sampler for a direction hitting at t."""
    cos_l = torch.abs(dot(-wi, normal))
    return (t * t) / torch.clamp_min(cos_l * area, 1e-12)
