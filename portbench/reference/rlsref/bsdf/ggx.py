"""GGX microfacet BSDF with VNDF importance sampling.

Counterpart of rlshaders_tpu/bsdf/ggx.py (anisotropic GGX NDF, Smith G1,
exact dielectric Fresnel with TIR, Heitz & d'Eon slope-space VNDF sampling,
the Walter Eq.20 reflection term, rough refraction: the Eq.21 refraction
term, the Eq.40 refracted direction and the Eq.41 sample weight, and the
view-averaged Fresnel of rlSkin's layering), and the debug surface the
JAX package's tests and `cli patterns` use: `sample_slope`, `sample_ndf`,
`ndf_pdf`, `eval_brdf` and `fresnel_avg_normal`.

Local shading frame: the normal is +z, the alpha_x axis is +x; directions
point away from the surface and are channel-split `V3` triples.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import vec3
from ..core.vec3 import V3

EPS = 1e-4
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi


class GGXParams(NamedTuple):
    alpha_x: torch.Tensor
    alpha_y: torch.Tensor
    alpha_g: torch.Tensor  # isotropic alpha for G1 (= roughness^2)
    ior_in: torch.Tensor   # refraction index on the incident side
    ior_out: torch.Tensor  # refraction index on the transmitted side


def make_params(roughness, ior, anisotropic, entering) -> GGXParams:
    """Lobe parameters as the reference ctor builds them (rlGgx.h:130-156):
    roughness r -> r^2, anisotropy splits alpha by sqrt(1 - 0.9*aniso), and
    the IORs swap when exiting a medium."""
    ior = torch.clamp_min(ior, 1e-4)
    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    r2 = roughness * roughness
    return GGXParams(
        alpha_x=torch.clamp_min(r2 / aspect, 1e-4),
        alpha_y=torch.clamp_min(r2 * aspect, 1e-4),
        alpha_g=torch.clamp_min(r2, 1e-5),
        ior_in=torch.where(entering, 1.0, ior),
        ior_out=torch.where(entering, ior, 1.0),
    )


def d_ggx_aniso(m: V3, alpha_x, alpha_y) -> torch.Tensor:
    """Anisotropic GGX NDF (Burley Eq.13; rlGgx.h:332-340)."""
    ax = m.x / alpha_x
    ay = m.y / alpha_y
    t = ax * ax + ay * ay + m.z * m.z
    denom = alpha_x * alpha_y * t * t
    return INV_PI / torch.clamp_min(denom, 1e-20)


def smith_g1(w: V3, m: V3, alpha_g) -> torch.Tensor:
    """Walter Eq.34 G1 with the isotropic alpha (rlGgx.h:343-357)."""
    wdotm = vec3.dot(w, m)
    wdotn = w.z
    same_side = wdotm * wdotn > 0.0
    cos2 = torch.clamp(wdotn * wdotn, 1e-12, 1.0)
    tan2 = 1.0 / cos2 - 1.0
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha_g * alpha_g * tan2))
    return torch.where(same_side, g, 0.0)


def smith_g(wi: V3, wo: V3, m: V3, alpha_g) -> torch.Tensor:
    return smith_g1(wi, m, alpha_g) * smith_g1(wo, m, alpha_g)


def smith_g1_aniso(w: V3, m: V3, alpha_x, alpha_y) -> torch.Tensor:
    """Exact anisotropic Smith G1, matching the VNDF sampler's pdf."""
    wdotm = vec3.dot(w, m)
    same_side = wdotm * w.z > 0.0
    ax = alpha_x * w.x
    ay = alpha_y * w.y
    a2 = ax * ax + ay * ay
    g = 2.0 / (1.0 + torch.sqrt(1.0 + a2 / torch.clamp_min(w.z * w.z, 1e-12)))
    return torch.where(same_side, g, 0.0)


def fresnel_dielectric(i: V3, m: V3, ior_in, ior_out) -> torch.Tensor:
    """Unpolarized dielectric Fresnel, Walter Eq.22 (rlGgx.h:249-270);
    1 on total internal reflection."""
    c = torch.abs(vec3.dot(i, m))
    eta = ior_out / ior_in
    g_sqr = eta * eta - 1.0 + c * c
    tir = g_sqr < 0.0
    g = torch.sqrt(torch.clamp_min(g_sqr, 0.0))
    gmc = g - c
    gpc = g + c
    a = gmc / torch.where(torch.abs(gpc) < 1e-12, 1e-12, gpc)
    b_den = c * gmc + 1.0
    b = (c * gpc - 1.0) / torch.where(torch.abs(b_den) < 1e-12, 1e-12, b_den)
    f = 0.5 * a * a * (1.0 + b * b)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def _sample_slope_uniform(rx, ry):
    """Isotropic full-NDF slope sample used at normal incidence."""
    r = torch.sqrt(rx / torch.clamp_min(1.0 - rx, 1e-12))
    phi = TWO_PI * ry
    return r * torch.cos(phi), r * torch.sin(phi)


def sample_slope_tan(tan_theta, near_normal, rx, ry):
    """Slopes of the visible-normal distribution for a stretched view
    direction with polar tangent `tan_theta` (rlGgx.cpp:14-61); the
    near-normal and degenerate paths fall back to the uniform sample."""
    ux, uy = _sample_slope_uniform(rx, ry)

    b = torch.clamp_min(tan_theta, 0.0)
    b2 = b * b
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + b2))

    a = 2.0 * rx / torch.clamp_min(g1, 1e-12) - 1.0
    a2 = a * a
    degenerate = torch.abs(a2 - 1.0) < EPS

    tmp = 1.0 / torch.where(degenerate, 1.0, a2 - 1.0)
    disc = torch.sqrt(torch.clamp_min(b2 * tmp * tmp - (a2 - b2) * tmp, 0.0))
    slope_x1 = b * tmp - disc
    slope_x2 = b * tmp + disc
    use_x1 = (a < 0.0) | (slope_x2 > 1.0 / torch.clamp_min(b, 1e-12))
    slope_x = torch.where(use_x1, slope_x1, slope_x2)

    # slope_y via the rational-polynomial fit of the inverse CDF
    flip = ry > 0.5
    sign = torch.where(flip, 1.0, -1.0)
    ry2 = torch.where(flip, 2.0 * (ry - 0.5), 2.0 * (0.5 - ry))
    z = (ry2 * (ry2 * (ry2 * 0.27385 - 0.73369) + 0.46341)) / (
        ry2 * (ry2 * (ry2 * 0.093073 + 0.309420) - 1.0) + 0.597999
    )
    slope_y = sign * z * torch.sqrt(1.0 + slope_x * slope_x)

    fallback = near_normal | degenerate
    return (
        torch.where(fallback, ux, slope_x),
        torch.where(fallback, uy, slope_y),
    )


def sample_slope(theta, rx, ry):
    """Angle-parameterized wrapper of `sample_slope_tan` (reference
    parity in tests)."""
    tan_theta = torch.tan(torch.clamp(theta, 0.0, math.pi / 2 - 1e-4))
    return sample_slope_tan(tan_theta, theta < EPS, rx, ry)


def sample_vndf(wo: V3, alpha_x, alpha_y, rx, ry) -> V3:
    """Sample a visible microfacet normal (VNDFKernel::evalSample,
    rlGgx.cpp:63-99): stretch, sample slopes, rotate, unstretch."""
    v = vec3.normalize(V3(wo.x * alpha_x, wo.y * alpha_y, wo.z))

    vz = torch.clamp(v.z, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - vz * vz, 0.0))
    on_pole = vz >= 1.0 - EPS
    inv_sin = 1.0 / torch.clamp_min(sin_t, 1e-12)
    cos_phi = torch.where(on_pole, 1.0, v.x * inv_sin)
    sin_phi = torch.where(on_pole, 0.0, v.y * inv_sin)
    tan_theta = sin_t / torch.clamp_min(torch.abs(vz), 1e-12)

    slope_x, slope_y = sample_slope_tan(tan_theta, on_pole, rx, ry)

    mx = -(cos_phi * slope_x - sin_phi * slope_y) * alpha_x
    my = -(sin_phi * slope_x + cos_phi * slope_y) * alpha_y
    return vec3.normalize(V3(mx, my, torch.ones_like(mx)))


def vndf_pdf(params: GGXParams, wo: V3, m: V3) -> torch.Tensor:
    """PDF of the VNDF reflection sample: D*G1 / (4 |wo.n|) (rlGgx.h:71-80),
    with the chi+(m.n) sidedness term."""
    idotn = torch.abs(wo.z)
    pdf = (
        d_ggx_aniso(m, params.alpha_x, params.alpha_y)
        * smith_g1_aniso(wo, m, params.alpha_x, params.alpha_y)
        / torch.clamp_min(idotn, 1e-12)
        * 0.25
    )
    return torch.where(m.z > 0.0, torch.clamp_min(pdf, EPS), EPS)


def sample_ndf(alpha_x, alpha_y, rx, ry) -> V3:
    """Sample the full (not visible) NDF, Burley Eq.14 (rlGgx.h:33-41)."""
    g = torch.sqrt(rx / torch.clamp_min(1.0 - rx, 1e-12))
    phi = TWO_PI * ry
    return vec3.normalize(V3(g * alpha_x * torch.cos(phi),
                             g * alpha_y * torch.sin(phi),
                             torch.ones_like(phi)))


def ndf_pdf(params: GGXParams, wo: V3, m: V3) -> torch.Tensor:
    """Reflection pdf of plain-NDF sampling, Walter Eq.38
    (rlGgx.h:44-50)."""
    idotm = torch.abs(vec3.dot(wo, m))
    mdotn = torch.abs(m.z)
    return (d_ggx_aniso(m, params.alpha_x, params.alpha_y) * mdotn * 0.25
            / torch.clamp_min(idotm, 1e-12))


def reflection_parts(params: GGXParams, wo: V3, wi: V3):
    """(fresnel, G*D/(4 |l.n||v.n|)) of Walter Eq.20."""
    sign = torch.sign(wo.z)
    sign = torch.where(sign == 0.0, 1.0, sign)
    hr = vec3.normalize(wo + wi) * sign
    f = fresnel_dielectric(wo, hr, params.ior_in, params.ior_out)
    ldotn = torch.abs(wi.z)
    vdotn = torch.abs(wo.z)
    g = smith_g(wo, wi, hr, params.alpha_g)
    d = d_ggx_aniso(hr, params.alpha_x, params.alpha_y)
    return f, g * d * 0.25 / torch.clamp_min(ldotn * vdotn, 1e-12)


def reflection_term(params: GGXParams, wo: V3, wi: V3) -> torch.Tensor:
    """Scalar reflection BRDF value, Walter Eq.20 (rlGgx.h:304-313)."""
    f, gd = reflection_parts(params, wo, wi)
    return f * gd


def eval_brdf(params: GGXParams, wo: V3, wi: V3, spec_color: V3) -> V3:
    """Reflectance times cos(theta_i) (GgxSamplerT::evalBrdf ->
    evalReflectance, rlGgx.h:110-119, 158-165); 0 for a zero `wi`. The
    JAX package's `spec_color` is a field of its params; here it is an
    argument."""
    valid = vec3.dot(wi, wi) > 1e-12
    refl = reflection_term(params, wo, wi) * wi.z
    return spec_color * torch.where(valid, refl, 0.0)


def refraction_term(params: GGXParams, wo: V3, wi: V3) -> torch.Tensor:
    """Scalar refraction BTDF value, Walter Eq.21 (rlGgx.h:316-328)."""
    ht = -vec3.normalize(wo * params.ior_in + wi * params.ior_out)
    f = 1.0 - fresnel_dielectric(wo, ht, params.ior_in, params.ior_out)
    odotn = torch.abs(wi.z)
    idotn = torch.abs(wo.z)
    odoth = vec3.dot(wi, ht)
    idoth = vec3.dot(wo, ht)
    s = params.ior_in * idoth + params.ior_out * odoth
    denom = odotn * idotn * (s * s)
    g = smith_g(wo, wi, ht, params.alpha_g)
    d = d_ggx_aniso(ht, params.alpha_x, params.alpha_y)
    return (torch.abs(odoth * idoth) * (params.ior_out * params.ior_out)
            * f * g * d / torch.clamp_min(denom, 1e-12))


def bsdf_sample_weight(params: GGXParams, wo: V3, wi: V3,
                       m: V3) -> torch.Tensor:
    """Weight of an NDF-sampled BSDF path, Walter Eq.41 (rlGgx.h:294-301):
    G |i.h| / (|i.n| |m.n|)."""
    idoth = vec3.dot(wo, m)
    mdotn = torch.abs(m.z)
    idotn = torch.abs(wo.z)
    g = smith_g(wo, wi, m, params.alpha_g)
    return g * torch.abs(idoth / torch.clamp_min(idotn * mdotn, 1e-12))


def refract_direction(m: V3, wo: V3, ior_in, ior_out):
    """Refract `wo` about the microfacet normal `m` (Walter Eq.40); returns
    (wi, tir). `wi` points into the transmitted hemisphere; where `tir` is
    True it is meaningless and callers mirror-reflect instead."""
    eta = ior_in / ior_out
    idotm = vec3.dot(wo, m)
    sign = torch.sign(wo.z)
    sign = torch.where(sign == 0.0, 1.0, sign)
    cos2 = 1.0 - eta * eta * (1.0 - idotm * idotm)
    tir = cos2 < 0.0
    k = eta * idotm - sign * torch.sqrt(torch.clamp_min(cos2, 0.0))
    return vec3.normalize(m * k - wo * eta), tir


def sample(params: GGXParams, wo: V3, rx, ry):
    """Sample a reflected direction via VNDF. Returns (wi, fresnel_weight)."""
    m = sample_vndf(wo, params.alpha_x, params.alpha_y, rx, ry)
    wi = vec3.reflect(wo, m)
    fw = fresnel_dielectric(wi, m, params.ior_in, params.ior_out)
    return wi, fw


# radical-inverse (van der Corput) points of the avg_fresnel quadrature
_VDC16 = (0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875,
          0.0625, 0.5625, 0.3125, 0.8125, 0.1875, 0.6875, 0.4375,
          0.9375, 0.03125)


def avg_fresnel(params: GGXParams, wo: V3, n: int = 16) -> torch.Tensor:
    """View-averaged dielectric Fresnel over n VNDF draws at fixed
    Hammersley points: the deterministic limit of the reference's running
    mean `getAvgReflectWeight()` (rlGgx.h:103-106, 181-184), which rlSkin's
    energy layering reads (rlSkin.cpp:204, 228, 238)."""
    acc = torch.zeros_like(wo.z)
    for i in range(n):
        rx = torch.full_like(wo.z, (i + 0.5) / n)
        ry = torch.full_like(wo.z, _VDC16[i % len(_VDC16)])
        m = sample_vndf(wo, params.alpha_x, params.alpha_y, rx, ry)
        wi = vec3.reflect(wo, m)
        acc = acc + fresnel_dielectric(wi, m, params.ior_in, params.ior_out)
    return acc / n


def pdf(params: GGXParams, wo: V3, wi: V3) -> torch.Tensor:
    """PDF of `sample` for MIS (rlGgx.h:121-127)."""
    h = vec3.normalize(wo + wi)
    return vndf_pdf(params, wo, h)


def sample_refract(params: GGXParams, wo: V3, rx, ry):
    """One rough-refraction sample (integrateRefract, rlGgx.h:228-243):
    draw a microfacet normal from the VNDF, refract about it (mirror-reflect
    on TIR) and weight by Eq.41. Returns (wi, weight, tir)."""
    m = sample_vndf(wo, params.alpha_x, params.alpha_y, rx, ry)
    wi_refr, tir = refract_direction(m, wo, params.ior_in, params.ior_out)
    wi = vec3.where(tir, vec3.reflect(wo, m), wi_refr)
    return wi, bsdf_sample_weight(params, wo, wi, m), tir


def fresnel_avg_normal(params: GGXParams) -> torch.Tensor:
    """Fresnel at normal incidence: F0 = ((eta-1)/(eta+1))^2."""
    eta = params.ior_out / params.ior_in
    return ((eta - 1.0) / (eta + 1.0)) ** 2
