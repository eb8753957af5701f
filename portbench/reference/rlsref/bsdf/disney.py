"""Disney principled BRDF (Burley SIGGRAPH'12).

Counterpart of rlshaders_tpu/bsdf/disney.py (the reference's DisneySampler,
rlDisney.cpp:105-602):

* diffuse with Schlick-Fresnel retro-reflection F90 and the Hanrahan-Krueger
  flat-subsurface lerp,
* GTR2 anisotropic specular with VNDF slope sampling, metallic/tint F0 remap,
* GTR1 clearcoat (fixed F0 0.04, roughness 0.25 in G) with inverse-CDF
  sampling,
* Schlick sheen, lobe-weighted mixture sampling and the matching MIS pdfs.

Local shading frame (+z = N, +x = tangent); directions point away from the
surface and are channel-split `V3` triples, colours too. Functions return
f*cos like the Arnold evalBrdf convention. The reference's quirks are kept
as the JAX package has them, each with its comment, and so are its
roundings: `clip(1 - x, 0, 1)**5` is `s * (s2 * s2)` as XLA's integer_pow
evaluates it, and a constant divided by a tensor is one division (torch's
`c / t` multiplies by the reciprocal).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import vec3
from ..core.vec3 import V3
from . import ggx, orennayar

EPS = 1e-7
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi


class DisneyParams(NamedTuple):
    """Per-shading-point Disney parameters (ctor at rlDisney.cpp:155-192).
    Scalar fields broadcast over the batch; colours are V3."""

    base_color: V3
    roughness: torch.Tensor       # raw artist roughness
    subsurface: torch.Tensor
    metallic: torch.Tensor
    sheen_color: V3               # premultiplied by the sheen weight
    spec_f0: V3
    clearcoat: torch.Tensor       # premultiplied by 0.25
    clearcoat_gloss: torch.Tensor
    alpha_x: torch.Tensor
    alpha_y: torch.Tensor
    spec_roughness: torch.Tensor  # roughness^2, read by Smith G


def _f(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _over(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as one rounded division."""
    return torch.full_like(x, c) / x


def make_params(base_color: V3, subsurface=0.0, metallic=0.0, specular=0.0,
                specular_tint=0.0, roughness=0.0, anisotropic=0.0, sheen=0.0,
                sheen_tint=0.0, clearcoat=0.0,
                clearcoat_gloss=0.0) -> DisneyParams:
    base = base_color
    roughness = _f(roughness)
    subsurface, metallic = _f(subsurface), _f(metallic)
    specular_tint, sheen, sheen_tint = (_f(specular_tint), _f(sheen),
                                        _f(sheen_tint))
    anisotropic = _f(anisotropic)
    clearcoat, clearcoat_gloss = _f(clearcoat), _f(clearcoat_gloss)
    # normal-incidence reflectance remap: specular in [0,1] -> F0 in [0,0.08]
    specular = _f(specular) * 0.08

    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    r2 = roughness * roughness
    alpha_x = torch.clamp_min(r2 / aspect, 1e-2)
    alpha_y = torch.clamp_min(r2 * aspect, 1e-2)

    lum = vec3.luminance(base)
    # a multiply by the reciprocal, not a division, as the reference
    inv_lum = 1.0 / torch.clamp_min(lum, 1e-12)
    tint = vec3.where(lum > 0.0, base * inv_lum, 1.0)
    # lerp(specular_tint, white, tint) then * specular
    metallic_color = (1.0 + (tint - 1.0) * specular_tint) * specular
    spec_f0 = metallic_color + (base - metallic_color) * metallic
    sheen_color = (1.0 + (tint - 1.0) * sheen_tint) * sheen
    return DisneyParams(
        base_color=base,
        roughness=roughness,
        subsurface=subsurface,
        metallic=metallic,
        sheen_color=sheen_color,
        spec_f0=spec_f0,
        clearcoat=clearcoat * 0.25,
        clearcoat_gloss=clearcoat_gloss,
        alpha_x=alpha_x,
        alpha_y=alpha_y,
        spec_roughness=r2,
    )


# ---------------------------------------------------------------------------
# Lobe terms
# ---------------------------------------------------------------------------

def expand_sample_axis(params: DisneyParams) -> DisneyParams:
    """Insert a broadcast sample axis after the batch axis on every field,
    each channel of a colour (scalar fields pass through: they broadcast
    already)."""
    def f(a: torch.Tensor) -> torch.Tensor:
        return a if a.ndim == 0 else a.unsqueeze(1)

    return DisneyParams(*(V3(*map(f, a)) if isinstance(a, V3) else f(a)
                          for a in params))


def _schlick5(x: torch.Tensor) -> torch.Tensor:
    s = torch.clamp(1.0 - x, 0.0, 1.0)
    s2 = s * s
    return s * (s2 * s2)


def d_gtr1(params: DisneyParams, mdotn2) -> torch.Tensor:
    """Clearcoat GTR1 NDF; alpha in [0.1, 0.001] by gloss
    (rlDisney.cpp:545-551)."""
    alpha = 0.1 + (0.001 - 0.1) * params.clearcoat_gloss
    a2 = alpha * alpha
    denom = torch.log(a2) * (1.0 + (a2 - 1.0) * mdotn2)
    return (a2 - 1.0) * INV_PI / denom


def d_gtr2_aniso(params: DisneyParams, m: V3, mdotn2) -> torch.Tensor:
    qx = m.x / params.alpha_x
    qy = m.y / params.alpha_y
    t = qx * qx + qy * qy + mdotn2
    denom = params.alpha_x * params.alpha_y * t * t
    return _over(INV_PI, torch.clamp_min(denom, 1e-20))


def smith_g_over_2ndotv(ndotv, alpha_g) -> torch.Tensor:
    """Walter's G1 divided by 2*NdotV (rlDisney.cpp:570-577)."""
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / torch.clamp_min(
        ndotv + torch.sqrt(torch.clamp_min(a + b - a * b, 0.0)), 1e-12)


def eval_diffuse(params: DisneyParams, wo: V3, wi: V3) -> V3:
    """Disney diffuse + HK flat subsurface, WITHOUT cos
    (rlDisney.cpp:199-236)."""
    ldotn = wi.z
    vdotn = wo.z
    h = vec3.normalize(wi + wo)
    ldoth = vec3.dot(wi, h)
    # the reference computes 'NdotH' as dot(viewDir, H) (rlDisney.cpp:210)
    # and early-outs on it; the exact gate is kept for parity
    ndoth = vec3.dot(wo, h)
    valid = (ldotn > EPS) & (vdotn > EPS) & (ndoth > EPS) & (ldoth > EPS)

    ldoth2 = ldoth * ldoth
    fl = _schlick5(ldotn)
    fv = _schlick5(vdotn)
    f90 = 0.5 + 2.0 * params.roughness * ldoth2
    diffuse_factor = (1.0 + (f90 - 1.0) * fl) * (1.0 + (f90 - 1.0) * fv)

    fss90 = params.roughness * ldoth2
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss_factor = 1.25 * (
        fss * (1.0 / torch.clamp_min(ldotn + vdotn, 1e-12) - 0.5) + 0.5)

    factor = diffuse_factor + (ss_factor - diffuse_factor) * params.subsurface
    scale = torch.where(valid, INV_PI * factor * (1.0 - params.metallic), 0.0)
    return params.base_color * scale


def eval_specular(params: DisneyParams, wo: V3, wi: V3,
                  with_clearcoat: bool = True) -> V3:
    """Combined GTR2-aniso + clearcoat + sheen, WITHOUT cos
    (rlDisney.cpp:318-356). `with_clearcoat=False` skips the GTR1 terms
    (valid when every shading point has clearcoat 0)."""
    ldotn = wi.z
    vdotn = wo.z
    m = vec3.normalize(wi + wo)
    ldotm = vec3.dot(wi, m)
    ndotm = m.z
    valid = (ldotn > EPS) & (vdotn > EPS) & (ndotm > EPS) & (ldotm > EPS)

    ndotm2 = ndotm * ndotm
    ds = d_gtr2_aniso(params, m, ndotm2)
    fh = _schlick5(ldotm)
    spec_f0 = params.spec_f0
    fs = spec_f0 + (1.0 - spec_f0) * fh
    gs = (smith_g_over_2ndotv(ldotn, params.spec_roughness)
          * smith_g_over_2ndotv(vdotn, params.spec_roughness))

    fsheen = params.sheen_color * (fh * (1.0 - params.metallic))

    f = fs * (ds * gs) + fsheen
    if with_clearcoat:
        clearcoat_f0 = 0.04
        clearcoat_rough = 0.25
        dr = d_gtr1(params, ndotm2)
        fr = clearcoat_f0 + (1.0 - clearcoat_f0) * fh
        gr = (smith_g_over_2ndotv(ldotn, clearcoat_rough)
              * smith_g_over_2ndotv(vdotn, clearcoat_rough))
        f = f + params.clearcoat * dr * fr * gr
    return vec3.where(valid, f, 0.0)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def sample_diffuse(params: DisneyParams, wo: V3, rx, ry) -> V3:
    del params, wo
    return orennayar.sample_v(rx, ry)


def pdf_diffuse(params: DisneyParams, wo: V3, wi: V3) -> torch.Tensor:
    del params, wo
    return torch.clamp_min(wi.z * INV_PI, 1e-4)


def _sample_gtr1(params: DisneyParams, rx, ry) -> V3:
    """GTR1 inverse-CDF sample (rlDisney.cpp:393-404). The reference uses
    the RAW roughness^2 here (mRoughness is raw in that scope), not the
    clearcoat alpha.

    pow(a2, 1-ry) is evaluated as exp((1-ry)*log(a2)), as the JAX package
    does, with the degenerate a2 = 1 branch."""
    phi = TWO_PI * rx
    a2 = params.roughness * params.roughness
    degenerate = torch.abs(a2 - 1.0) < 1e-6
    safe_a2 = torch.where(degenerate, 0.5, a2)
    log_a2 = torch.log(torch.clamp_min(safe_a2, 1e-20))
    pow_term = torch.exp((1.0 - ry) * log_a2)
    cos_t = torch.where(
        degenerate,
        torch.sqrt(torch.clamp_min(1.0 - ry, 0.0)),
        torch.sqrt(torch.clamp((1.0 - pow_term) / (1.0 - safe_a2), 0.0, 1.0)),
    )
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def _sample_gtr2_aniso_vndf(params: DisneyParams, wo: V3, rx, ry) -> V3:
    """GTR2 anisotropic visible-normal sample (rlDisney.cpp:467-502): the
    GGX kernel's slope-space sampler."""
    return ggx.sample_vndf(wo, params.alpha_x, params.alpha_y, rx, ry)


def sample_specular(params: DisneyParams, wo: V3, rx, ry,
                    with_clearcoat: bool = True) -> V3:
    """Lobe-mixture specular sample (rlDisney.cpp:367-390): GTR2-aniso VNDF
    with weight 1/(clearcoat+1), else GTR1, reflected about the sampled
    normal. The zero vector for below-horizon normals, as the reference
    rejects them."""
    if not with_clearcoat:
        m = _sample_gtr2_aniso_vndf(params, wo, rx, ry)
        return vec3.where(m.z < 0.0, 0.0, vec3.reflect(wo, m))
    gtr2_w = 1.0 / (params.clearcoat + 1.0)
    use_gtr2 = rx < gtr2_w
    rx2 = torch.where(
        use_gtr2,
        rx / torch.clamp_min(gtr2_w, 1e-12),
        (rx - gtr2_w) / torch.clamp_min(1.0 - gtr2_w, 1e-12),
    )
    m2 = _sample_gtr2_aniso_vndf(params, wo, rx2, ry)
    m1 = _sample_gtr1(params, rx2, ry)
    m = vec3.where(use_gtr2, m2, m1)
    return vec3.where(m.z < 0.0, 0.0, vec3.reflect(wo, m))


def pdf_specular(params: DisneyParams, wo: V3, wi: V3,
                 with_clearcoat: bool = True) -> torch.Tensor:
    """Mixture pdf matching sample_specular (role of rlDisney.cpp:520-543).

    The GTR2 branch uses the EXACT anisotropic Smith G1, so the pdf is the
    slope-space sampler's true density (the reference approximates G1 with
    smithG_GGX at I.M, which mis-normalizes at grazing angles); the GTR1
    branch is the half-vector-NDF Jacobian form, as in the reference."""
    m = vec3.normalize(wi + wo)
    idotm = torch.abs(vec3.dot(wi, m))
    mdotn = m.z
    mdotn2 = mdotn * mdotn
    vdotn = torch.clamp_min(wo.z, 1e-4)
    p_gtr2 = (d_gtr2_aniso(params, m, mdotn2)
              * ggx.smith_g1_aniso(wo, m, params.alpha_x, params.alpha_y)
              / vdotn)
    if with_clearcoat:
        cc_w = params.clearcoat / (params.clearcoat + 1.0)
        p_gtr1 = (d_gtr1(params, mdotn2) * torch.abs(mdotn)
                  / torch.clamp_min(idotm, 1e-12))
        d_mix = p_gtr2 + (p_gtr1 - p_gtr2) * cc_w
    else:
        d_mix = p_gtr2
    return torch.where(mdotn < 0.0, 0.0, d_mix * 0.25)


# f*cos wrappers (Arnold evalBrdf convention, rlDisney.cpp:120-137)

def eval_diffuse_cos(params: DisneyParams, wo: V3, wi: V3) -> V3:
    return eval_diffuse(params, wo, wi) * wi.z


def eval_specular_cos(params: DisneyParams, wo: V3, wi: V3,
                      with_clearcoat: bool = True) -> V3:
    return eval_specular(params, wo, wi, with_clearcoat) * wi.z


def has_clearcoat(params: DisneyParams) -> bool:
    """Whether any shading point has a clearcoat: decides
    `with_clearcoat` on the host (one device-to-host copy)."""
    return bool((params.clearcoat > 0.0).any())
