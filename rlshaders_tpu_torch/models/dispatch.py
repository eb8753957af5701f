"""Batched surface-shader evaluation with material-type dispatch.

Counterpart of rlshaders_tpu/models/dispatch.py for the two material types
of the ported slice: `rlGgx` (Oren-Nayar diffuse + GGX specular with the
dielectric Fresnel) and Arnold's `standard` (Oren-Nayar diffuse + the
cook_torrance Beckmann lobe, or GGX, with Schlick or no Fresnel). Every lobe
evaluator computes the models of all lanes and masks by type.

`gather` raises on what this slice does not shade: rlDisney and rlSkin
materials, and textures or bump maps.

Lobe contract (local frame, +z = forward-facing shading normal):
  diffuse:  f*cos V3, pdf   (cosine sampled)
  specular: f*cos V3, pdf
  refract:  sampled direction and its Walter Eq.41 weight * Kt * KtColor
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..bsdf import beckmann, ggx, orennayar
from ..core import vec3
from ..core.vec3 import V3, v3
from ..scene.build import MAT_DISNEY, MAT_SKIN, MAT_STANDARD, Materials


class MatG(NamedTuple):
    """Per-hit gathered material parameters and lobe parameters."""

    mtype: torch.Tensor
    diffuse_color: V3
    diffuse_roughness: torch.Tensor
    spec_weight: V3
    spec_fresnel_mode: torch.Tensor  # 0 dielectric ior, 1 Schlick ksn, 2 none
    spec_ksn: torch.Tensor
    spec_dist: torch.Tensor          # 0 GGX, 1 Beckmann
    ggx: ggx.GGXParams
    kt_color: V3                     # KtColor * Kt
    opacity: V3
    emission: V3
    has_diffuse: torch.Tensor        # bool masks
    has_spec: torch.Tensor
    has_refract: torch.Tensor


def check_supported(mats: Materials) -> None:
    """Raise NotImplementedError for material features this slice lacks."""
    mtype = mats.mtype.cpu()
    if bool(((mtype == MAT_DISNEY) | (mtype == MAT_SKIN)).any()):
        raise NotImplementedError(
            "rlDisney and rlSkin materials are not ported yet")
    tex = torch.stack([mats.kd_tex, mats.ks_tex, mats.bump_tex]).cpu()
    if bool((tex >= 0).any()):
        raise NotImplementedError("textures and bump maps are not ported yet")


def _absmax(c: V3) -> torch.Tensor:
    return torch.maximum(torch.abs(c.x),
                         torch.maximum(torch.abs(c.y), torch.abs(c.z)))


def gather(mats: Materials, mat_id: torch.Tensor, entering: torch.Tensor,
           diffuse_ray: bool = False) -> MatG:
    """Gather the material rows of a hit batch and build lobe parameters."""
    check_supported(mats)
    mid = mat_id.long()
    g = Materials(*(a[mid] for a in mats))
    is_standard = g.mtype == MAT_STANDARD

    # rlGgx/standard diffuse: Kd * Kd_color (rlGgx.cpp:278-279)
    diffuse_color = v3(g.kd_color) * g.kd
    spec_weight = v3(g.ks_color) * g.ks
    if diffuse_ray:
        # standard with enable_glossy_caustics off kills the whole specular
        # response on diffuse rays; the rl* plugins carry no such gate
        spec_weight = vec3.where(is_standard & ~g.glossy_caustics, 0.0,
                                 spec_weight)
    # ior < 1 is legal (near-mirror through TIR); the reference clamps only
    # at 1e-4 (rlGgx.h:139)
    ggx_p = ggx.make_params(g.spec_roughness, torch.clamp_min(g.ior, 1e-4),
                            g.spec_aniso, entering)
    kt_color = v3(g.kt_color) * g.kt
    eps = 1e-5
    return MatG(
        mtype=g.mtype,
        diffuse_color=diffuse_color,
        diffuse_roughness=g.diffuse_roughness,
        spec_weight=spec_weight,
        spec_fresnel_mode=g.spec_fresnel_mode,
        spec_ksn=g.spec_ksn,
        spec_dist=g.spec_dist,
        ggx=ggx_p,
        kt_color=kt_color,
        opacity=v3(g.opacity),
        emission=v3(g.emission),
        has_diffuse=_absmax(diffuse_color) > eps,
        has_spec=_absmax(spec_weight) > eps,
        has_refract=_absmax(kt_color) > eps,
    )


def tile_v(m: MatG, k: int) -> MatG:
    """Repeat a MatG k times along the batch axis (column-major chunks,
    matching vec3.tile's layout)."""
    if k == 1:
        return m

    def f(a):
        if isinstance(a, tuple):
            return type(a)(*(f(x) for x in a))
        return a.repeat(k)

    return f(m)


def eval_diffuse(m: MatG, wo: V3, wi: V3):
    """(f*cos V3, pdf) of the diffuse lobe in the local frame."""
    f = m.diffuse_color * orennayar.eval_brdf(m.diffuse_roughness, wo, wi)
    pdf = torch.clamp_min(wi.z, 0.0) / math.pi
    return vec3.where(m.has_diffuse, f, 0.0), torch.clamp_min(pdf, 1e-9)


def sample_diffuse(m: MatG, wo: V3, rx, ry) -> V3:
    del m, wo
    return orennayar.sample_v(rx, ry)


def eval_specular(m: MatG, wo: V3, wi: V3):
    """(f*cos V3, pdf) of the specular lobe in the local frame; the Fresnel
    mode follows the material (dielectric IOR, Schlick with F0 = Ksn, or
    none), and cook_torrance swaps in the Beckmann D*G and pdf."""
    f_diel, gd = ggx.reflection_parts(m.ggx, wo, wi)
    h = vec3.normalize(wo + wi)
    s = torch.clamp(1.0 - torch.abs(vec3.dot(wi, h)), 0.0, 1.0)
    s2 = s * s
    f_schlick = m.spec_ksn + (1.0 - m.spec_ksn) * (s * (s2 * s2))
    fres = torch.where(
        m.spec_fresnel_mode == 0,
        f_diel,
        torch.where(m.spec_fresnel_mode == 1, f_schlick, 1.0),
    )
    is_beck = m.spec_dist == 1
    gd = torch.where(is_beck, beckmann.gd(wo, wi, m.ggx.alpha_g), gd)
    valid = vec3.dot(wi, wi) > 1e-12
    refl = torch.where(valid, fres * gd * wi.z, 0.0)
    f = m.spec_weight * refl
    pdf = torch.where(
        is_beck,
        beckmann.pdf(wo, wi, m.ggx.alpha_g),
        ggx.pdf(m.ggx, wo, wi),
    )
    return vec3.where(m.has_spec, f, 0.0), torch.clamp_min(pdf, 1e-9)


def sample_specular(m: MatG, wo: V3, rx, ry) -> V3:
    wi_ggx, _ = ggx.sample(m.ggx, wo, rx, ry)
    wi_beck = beckmann.sample(wo, m.ggx.alpha_g, rx, ry)
    return vec3.where(m.spec_dist == 1, wi_beck, wi_ggx)


def sample_refract(m: MatG, wo: V3, rx, ry):
    """(wi V3, weight V3) of one rough-refraction sample (integrateRefract
    per sample, rlGgx.h:228-243); the weight is 0 where nothing refracts."""
    wi, w, _ = ggx.sample_refract(m.ggx, wo, rx, ry)
    return wi, vec3.where(m.has_refract, m.kt_color * w, 0.0)
