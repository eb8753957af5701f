"""Batched surface-shader evaluation with material-type dispatch.

Counterpart of rlshaders_tpu/models/dispatch.py for the four material types
of the ported slices: `rlGgx` (Oren-Nayar diffuse + GGX specular with the
dielectric Fresnel), Arnold's `standard` (Oren-Nayar diffuse + the
cook_torrance Beckmann lobe, or GGX, with Schlick or no Fresnel; its Ksss
lobe is the SSS stage's), `rlDisney` (the principled diffuse and the GTR2 +
clearcoat + sheen specular mixture, bsdf/disney.py) and `rlSkin` (a GGX
specular lobe under a GGX sheen lobe with Fresnel energy layering; its
diffuse is the SSS stage's at camera hits and the albedo sss_color *
sss_weight on diffuse rays). Every lobe evaluator computes the models of
all lanes and masks by type; the models of types a table lacks are left
out, as the caller's per-table flags say.

Texture links (`gather`'s `tex`): the diffuse colour's MayaFile texture on
the mesh uv or a planar MayaProjection (defaultColor outside its square,
or wrapping), filtered at a level of detail from the ray footprint, its
`invert` in storage space, the texture_gamma decode, then colorGain and
colorOffset; and a Ks texture's luminance as Ks's alpha. `apply_bump`
perturbs the shading normal by a bump3d height map. A table with no
texture link skips all of it, as the caller's flags say.

Lobe contract (local frame, +z = forward-facing shading normal):
  diffuse:  f*cos V3, pdf   (cosine sampled)
  specular: f*cos V3, pdf   (GGX, Beckmann, Disney's mixture, or rlSkin's
                             two lobes)
  refract:  sampled direction and its Walter Eq.41 weight * Kt * KtColor

On CUDA tensors each call of a lobe entry point (`eval_diffuse`,
`sample_diffuse`, `eval_specular`, `sample_specular`, `sample_refract`) is
one launch of a kernel of ops/bsdf.py, in which each lane evaluates only
its own material's model; elsewhere the torch code here runs, the plain
version. With the tracer's counters on, every call adds its lanes to
`bsdf_lanes` and, where a kernel handled them, to `bsdf_kernel_lanes`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..bsdf import beckmann, disney, ggx, orennayar
from ..core import tracer, vec3
from ..core.frame import build_frame_polar_v
from ..core.vec3 import V3, v3
from ..ops import bsdf as kernels
from ..scene import texture as texmod
from ..scene.build import MAT_DISNEY, MAT_SKIN, MAT_STANDARD, Materials

# the least world step of bump3d's finite differences (the JAX apply_bump's
# eps_min default)
BUMP_EPS_MIN = 5e-3

# the columns only rlDisney rows read
_DISNEY_FIELDS = ("subsurface", "metallic", "specular", "specular_tint",
                  "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss",
                  "indirect_diffuse_scale", "indirect_specular_scale")


class MatG(NamedTuple):
    """Per-hit gathered material parameters and lobe parameters."""

    mtype: torch.Tensor
    diffuse_color: V3
    diffuse_roughness: torch.Tensor
    spec_weight: V3
    spec_fresnel_mode: torch.Tensor  # 0 dielectric ior, 1 Schlick ksn, 2 none
    spec_ksn: torch.Tensor
    spec_dist: torch.Tensor          # 0 GGX, 1 Beckmann
    ggx: ggx.GGXParams               # GGX lobe (rlGgx, standard, skin)
    ggx2: ggx.GGXParams              # rlSkin's sheen lobe
    spec2_weight: V3                 # sheen lobe multiplier (rlSkin)
    skin_spec_w: torch.Tensor        # specular_weight (rlSkin layering)
    skin_sheen_w: torch.Tensor       # sheen_weight (rlSkin layering)
    sheen_layer: torch.Tensor        # 1 - avgF(sheen) * sheen_weight; 1.0
    #                                  until skin_layer_fields fills it
    dsy: disney.DisneyParams         # rlDisney's lobes
    kt_color: V3                     # KtColor * Kt
    opacity: V3
    emission: V3
    indirect_diffuse_scale: torch.Tensor   # rlDisney's indirect multipliers
    indirect_specular_scale: torch.Tensor
    sss_color: V3
    sss_weight: torch.Tensor
    sss_dist: V3
    cavity_fadeout: torch.Tensor
    has_diffuse: torch.Tensor        # bool masks
    has_spec: torch.Tensor
    has_refract: torch.Tensor


class TexLookup(NamedTuple):
    """What the texture lookups of a hit batch read."""

    stack: texmod.TextureStack
    uv: torch.Tensor      # (N, 2) interpolated mesh uv
    p: V3                 # world hit positions
    fp: torch.Tensor      # (N,) world-space ray-cone footprint
    fp_uv: torch.Tensor   # (N,) the footprint in the triangle's uv
    lod_bias: float
    gamma: float          # texture_gamma, applied after filtering


def _degamma(c: V3, gamma: float) -> V3:
    """The texture_gamma decode, applied after filtering: textures are
    stored and filtered in storage space, as Arnold's mips and bicubic taps
    average pre-decode values."""
    if gamma == 1.0:
        return c
    return V3(*(torch.pow(torch.clamp_min(x, 0.0), gamma) for x in c))


def _proj_uv_scale_table(proj_inv: torch.Tensor) -> torch.Tensor:
    """(M,) uv per world unit of each material's planar projection: local
    = p @ P and uv = (local + 1) / 2, so duv/dp is |P column| / 2 (the mean
    of the two uv axes)."""
    def norm(c):
        return torch.sqrt(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
                          + c[..., 2] * c[..., 2])

    return 0.25 * (norm(proj_inv[..., :3, 0]) + norm(proj_inv[..., :3, 1]))


def _proj_xy(proj_inv_table: torch.Tensor, mid: torch.Tensor, p: V3):
    """(local_x, local_y) of p @ the hit material's projection matrix."""
    def e(i, j):
        return proj_inv_table[:, i, j][mid]

    lx = p.x * e(0, 0) + p.y * e(1, 0) + p.z * e(2, 0) + e(3, 0)
    ly = p.x * e(0, 1) + p.y * e(1, 1) + p.z * e(2, 1) + e(3, 1)
    return lx, ly


def _planar_uv(lx, ly) -> torch.Tensor:
    return torch.stack([(lx + 1.0) * 0.5, (ly + 1.0) * 0.5], dim=-1)


def _inside(lx, ly) -> torch.Tensor:
    return (torch.abs(lx) <= 1.0) & (torch.abs(ly) <= 1.0)


def _luminance(c: V3) -> torch.Tensor:
    return 0.212671 * c.x + 0.71516 * c.y + 0.072169 * c.z


def _textures(mats: Materials, g: Materials, mid, t: TexLookup):
    """(the diffuse texture colour V3, Ks) of the hits' texture links; 1
    and the table's Ks where a hit has none."""
    # planar projection: uv = (local + 1) / 2; outside the unit square
    # proj 2 (`wrap on`) tiles the image, proj 1 gives defaultColor
    lx, ly = _proj_xy(mats.kd_proj_inv, mid, t.p)
    is_proj = g.kd_proj >= 1
    uv = torch.where(is_proj[..., None], _planar_uv(lx, ly), t.uv)
    in_coverage = ~is_proj | (g.kd_proj == 2) | _inside(lx, ly)
    fpu = torch.where(is_proj,
                      t.fp * _proj_uv_scale_table(mats.kd_proj_inv)[mid],
                      t.fp_uv)
    lod = texmod.compute_lod(t.stack, g.kd_tex, fpu, t.lod_bias)
    store = texmod.sample_smart_bicubic(t.stack, g.kd_tex, uv, lod)
    # MayaFile `invert` in storage space, before the decode; gain and
    # offset in linear space after it
    store = vec3.where(g.kd_tex_invs, 1.0 - store, store)
    color = (_degamma(store, t.gamma) * v3(g.kd_tex_gain)
             + v3(g.kd_tex_offset))
    color = vec3.where(in_coverage, color, v3(g.kd_proj_default))
    color = vec3.where(g.kd_tex >= 0, color, 1.0)

    # a Ks texture's alpha: the luminance of an alpha-less image, 0 outside
    # a projection's coverage
    klx, kly = _proj_xy(mats.ks_proj_inv, mid, t.p)
    k_proj = g.ks_proj >= 1
    kuv = torch.where(k_proj[..., None], _planar_uv(klx, kly), uv)
    k_cov = (g.ks_proj != 1) | _inside(klx, kly)
    k_fpu = torch.where(
        k_proj, t.fp * _proj_uv_scale_table(mats.ks_proj_inv)[mid], t.fp_uv)
    k_lod = texmod.compute_lod(t.stack, g.ks_tex, k_fpu, t.lod_bias)
    k_rgb = _degamma(
        texmod.sample_smart_bicubic(t.stack, g.ks_tex, kuv, k_lod), t.gamma)
    k_alpha = torch.where(k_cov, torch.clamp(_luminance(k_rgb), 0.0, 1.0),
                          0.0)
    ks = torch.where(g.ks_tex >= 0, g.ks * k_alpha, g.ks)
    return color, ks


def _absmax(c: V3) -> torch.Tensor:
    return torch.maximum(torch.abs(c.x),
                         torch.maximum(torch.abs(c.y), torch.abs(c.z)))


@tracer.traced("material")
def gather(mats: Materials, mat_id: torch.Tensor, entering: torch.Tensor, *,
           has_skin: bool, has_disney: bool, diffuse_ray: bool = False,
           tex: TexLookup | None = None) -> MatG:
    """Gather the material rows of a hit batch and build lobe parameters.
    `has_skin` and `has_disney` say whether the table has rlSkin and
    rlDisney rows (decided once per table, on the host). Without rlSkin the
    sheen lobe is left out (`ggx2` None), without rlDisney its lobes and
    columns (`dsy` and the indirect scales None): the lobe evaluators then
    skip their arithmetic, which would change no lane. `tex` (None for a
    table without texture links) drives the texture lookups."""
    mid = mat_id.long()
    g = Materials(*(None if f in _DISNEY_FIELDS and not has_disney
                    else a[mid] for f, a in zip(Materials._fields, mats)))
    is_standard = g.mtype == MAT_STANDARD
    is_skin = g.mtype == MAT_SKIN
    base_color = v3(g.kd_color)
    ks = g.ks
    if tex is not None:
        tex_color, ks = _textures(mats, g, mid, tex)
        base_color = base_color * tex_color

    # rlGgx/standard diffuse: Kd * Kd_color (rlGgx.cpp:278-279); rlSkin's
    # on diffuse rays: the albedo sss_color * sss_weight (rlSss.h:172-186);
    # rlDisney's lobe carries its base colour itself
    diffuse_color = vec3.where(is_skin, v3(g.sss_color) * g.sss_weight,
                               base_color * g.kd)
    dsy_p = None
    if has_disney:
        is_disney = g.mtype == MAT_DISNEY
        diffuse_color = vec3.where(is_disney, 1.0, diffuse_color)
        # every field per lane: base_color is the textured kd_color,
        # roughness spec_roughness, anisotropic spec_aniso
        dsy_p = disney.make_params(
            base_color=base_color, subsurface=g.subsurface,
            metallic=g.metallic, specular=g.specular,
            specular_tint=g.specular_tint, roughness=g.spec_roughness,
            anisotropic=g.spec_aniso, sheen=g.sheen, sheen_tint=g.sheen_tint,
            clearcoat=g.clearcoat, clearcoat_gloss=g.clearcoat_gloss)
    spec_weight = vec3.where(is_skin,
                             v3(g.skin_spec_color) * g.skin_spec_weight,
                             v3(g.ks_color) * ks)
    if diffuse_ray:
        # standard with enable_glossy_caustics off kills the whole specular
        # response on diffuse rays; the rl* plugins carry no such gate
        spec_weight = vec3.where(is_standard & ~g.glossy_caustics, 0.0,
                                 spec_weight)
    spec2_weight = v3(g.skin_sheen_color) * g.skin_sheen_weight
    # ior < 1 is legal (near-mirror through TIR); the reference clamps only
    # at 1e-4 (rlGgx.h:139)
    zero = torch.zeros_like(g.spec_aniso)
    ggx_p = ggx.make_params(
        torch.where(is_skin, g.skin_spec_roughness, g.spec_roughness),
        torch.where(is_skin, g.skin_spec_ior, torch.clamp_min(g.ior, 1e-4)),
        torch.where(is_skin, zero, g.spec_aniso), entering)
    ggx2_p = (ggx.make_params(g.skin_sheen_roughness, g.skin_sheen_ior, zero,
                              entering) if has_skin else None)
    kt_color = v3(g.kt_color) * g.kt
    eps = 1e-5
    has_spec = ((_absmax(spec_weight) > eps)
                | (is_skin & (_absmax(spec2_weight) > eps)))
    if has_disney:
        # rlDisney's specular is its own lobe (spec_weight is 0 on its rows)
        has_spec = has_spec | is_disney
    return MatG(
        mtype=g.mtype,
        diffuse_color=diffuse_color,
        diffuse_roughness=g.diffuse_roughness,
        spec_weight=spec_weight,
        spec_fresnel_mode=g.spec_fresnel_mode,
        spec_ksn=g.spec_ksn,
        spec_dist=g.spec_dist,
        ggx=ggx_p,
        ggx2=ggx2_p,
        spec2_weight=spec2_weight,
        skin_spec_w=torch.where(is_skin, g.skin_spec_weight, zero),
        skin_sheen_w=torch.where(is_skin, g.skin_sheen_weight, zero),
        sheen_layer=torch.ones_like(g.skin_spec_weight),
        dsy=dsy_p,
        kt_color=kt_color,
        opacity=v3(g.opacity),
        emission=v3(g.emission),
        indirect_diffuse_scale=g.indirect_diffuse_scale,
        indirect_specular_scale=g.indirect_specular_scale,
        sss_color=v3(g.sss_color),
        sss_weight=g.sss_weight,
        sss_dist=v3(g.sss_dist),
        cavity_fadeout=g.cavity_fadeout,
        has_diffuse=_absmax(diffuse_color) > eps,
        has_spec=has_spec,
        has_refract=_absmax(kt_color) > eps,
    )


@tracer.traced("material")
def apply_bump(mats: Materials, stack: texmod.TextureStack, mat_id, p: V3,
               ns: V3, fp, tex_gamma: float) -> V3:
    """The shading normal perturbed by the hit material's bump3d height
    map (finite differences of its projected luminance along two surface
    tangents); ns where no bump is bound. The differencing step and the
    level of detail follow the world footprint `fp` (at least
    BUMP_EPS_MIN), which band-limits the height field to the pixel
    scale."""
    mid = mat_id.long()
    bump_tex = mats.bump_tex[mid]
    bump_proj = mats.bump_proj[mid]
    eps = torch.clamp_min(fp, BUMP_EPS_MIN)
    scale = _proj_uv_scale_table(mats.bump_proj_inv)[mid]
    lod = texmod.compute_lod(stack, bump_tex, eps * scale)

    def height(q: V3):
        lx, ly = _proj_xy(mats.bump_proj_inv, mid, q)
        rgb = _degamma(texmod.sample_bilinear(stack, bump_tex,
                                              _planar_uv(lx, ly), lod),
                       tex_gamma)
        return torch.where((bump_proj == 2) | _inside(lx, ly),
                           _luminance(rgb), 0.5)

    frame = build_frame_polar_v(ns)
    h0 = height(p)
    gu = (height(p + frame.u * eps) - h0) / eps
    gv = (height(p + frame.v * eps) - h0) / eps
    bumped = vec3.normalize(
        ns - (frame.u * gu + frame.v * gv) * mats.bump_height[mid])
    return vec3.where(bump_tex >= 0, bumped, ns)


@tracer.traced("material")
def skin_layer_fields(m: MatG, wo: V3) -> MatG:
    """Fill rlSkin's view-dependent Fresnel energy layering (rlSkin.cpp:
    204, 228, 231, 238), once per shading point with the local view
    direction:

        sheenFresnel    = avgF(sheen lobe)    * sheen_weight
        specularFresnel = avgF(specular lobe) * specular_weight
        specular       *= 1 - sheenFresnel               -> sheen_layer
        sssWeight      *= 1 - specularFresnel * (1 - sheenFresnel)

    The layered SSS weight also scales the diffuse-ray albedo. Other lanes
    are unchanged."""
    is_skin = m.mtype == MAT_SKIN
    sheen_fres = torch.clamp(ggx.avg_fresnel(m.ggx2, wo) * m.skin_sheen_w,
                             0.0, 1.0)
    spec_fres = torch.clamp(ggx.avg_fresnel(m.ggx, wo) * m.skin_spec_w,
                            0.0, 1.0)
    sss_layer = 1.0 - spec_fres * (1.0 - sheen_fres)
    return m._replace(
        sheen_layer=torch.where(is_skin, 1.0 - sheen_fres, 1.0),
        sss_weight=torch.where(is_skin, m.sss_weight * sss_layer,
                               m.sss_weight),
        diffuse_color=vec3.where(is_skin, m.diffuse_color * sss_layer,
                                 m.diffuse_color),
    )


@tracer.traced("material")
def tile_v(m: MatG, k: int) -> MatG:
    """Repeat a MatG k times along the batch axis (column-major chunks,
    matching vec3.tile's layout)."""
    if k == 1:
        return m

    def f(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return type(a)(*(f(x) for x in a))
        return a.repeat(k)

    return f(m)


def _on_card(wo: V3) -> bool:
    """Whether a lobe call goes to the kernels of ops/bsdf.py (host ints
    counted: no kernel, no synchronization)."""
    card = wo.x.device.type == "cuda"
    if tracer.TRACER.counters_on:
        n = wo.x.shape[0]
        tracer.count("bsdf_lanes", n)
        tracer.count("bsdf_kernel_lanes", n if card else 0)
    return card


@tracer.traced("bsdf")
def eval_diffuse(m: MatG, wo: V3, wi: V3):
    """(f*cos V3, pdf) of the diffuse lobe in the local frame. The pdf is
    the cosine sampler's, also on Disney lanes (clamped at 1e-9, not at
    disney.pdf_diffuse's 1e-4), as the JAX dispatch has it."""
    if _on_card(wo):
        return kernels.eval_diffuse(m, wo, wi)
    f = m.diffuse_color * orennayar.eval_brdf(m.diffuse_roughness, wo, wi)
    if m.dsy is not None:
        f = vec3.where(m.mtype == MAT_DISNEY,
                       disney.eval_diffuse_cos(m.dsy, wo, wi), f)
    pdf = torch.clamp_min(wi.z, 0.0) / math.pi
    return vec3.where(m.has_diffuse, f, 0.0), torch.clamp_min(pdf, 1e-9)


@tracer.traced("bsdf")
def sample_diffuse(m: MatG, wo: V3, rx, ry) -> V3:
    if _on_card(wo):
        return kernels.sample_diffuse(rx, ry)
    return orennayar.sample_v(rx, ry)


@tracer.traced("bsdf")
def eval_specular(m: MatG, wo: V3, wi: V3):
    """(f*cos V3, pdf) of the specular lobe in the local frame; the Fresnel
    mode follows the material (dielectric IOR, Schlick with F0 = Ksn, or
    none), and cook_torrance swaps in the Beckmann D*G and pdf."""
    if _on_card(wo):
        return kernels.eval_specular(m, wo, wi)
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
    f_ggx = m.spec_weight * refl
    p_ggx = torch.where(
        is_beck,
        beckmann.pdf(wo, wi, m.ggx.alpha_g),
        ggx.pdf(m.ggx, wo, wi),
    )
    f, pdf = f_ggx, p_ggx
    if m.ggx2 is not None:
        # rlSkin: the sheen lobe over the specular one, which the
        # view-averaged sheen Fresnel attenuates (sheen_layer,
        # rlSkin.cpp:204-238)
        refl2 = torch.where(valid,
                            ggx.reflection_term(m.ggx2, wo, wi) * wi.z, 0.0)
        f_skin = m.spec2_weight * refl2 + f_ggx * m.sheen_layer
        has_sheen = vec3.maxc(m.spec2_weight) > 1e-5
        p_skin = torch.where(has_sheen,
                             0.5 * (p_ggx + ggx.pdf(m.ggx2, wo, wi)), p_ggx)
        is_skin = m.mtype == MAT_SKIN
        f = vec3.where(is_skin, f_skin, f)
        pdf = torch.where(is_skin, p_skin, pdf)
    if m.dsy is not None:
        # rlDisney: the GTR2 + clearcoat + sheen mixture, clearcoat on (at
        # clearcoat 0 it equals the off branch exactly)
        is_disney = m.mtype == MAT_DISNEY
        f = vec3.where(is_disney, disney.eval_specular_cos(m.dsy, wo, wi), f)
        pdf = torch.where(is_disney, disney.pdf_specular(m.dsy, wo, wi), pdf)
    return vec3.where(m.has_spec, f, 0.0), torch.clamp_min(pdf, 1e-9)


@tracer.traced("bsdf")
def sample_specular(m: MatG, wo: V3, rx, ry) -> V3:
    if _on_card(wo):
        return kernels.sample_specular(m, wo, rx, ry)
    if m.ggx2 is None:
        wi_ggx, _ = ggx.sample(m.ggx, wo, rx, ry)
        wi_beck = beckmann.sample(wo, m.ggx.alpha_g, rx, ry)
        wi = vec3.where(m.spec_dist == 1, wi_beck, wi_ggx)
    else:
        # rlSkin with sheen picks the sheen or the specular lobe 50/50 and
        # remaps rx to [0, 1) for the lobe picked; without sheen the raw rx
        # feeds the specular lobe
        has_sheen = vec3.maxc(m.spec2_weight) > 1e-5
        use_sheen = (rx < 0.5) & has_sheen
        rx_spec = torch.where(has_sheen, (rx - 0.5) * 2.0, rx)
        wi_ggx, _ = ggx.sample(m.ggx, wo, rx_spec, ry)
        wi_beck = beckmann.sample(wo, m.ggx.alpha_g, rx_spec, ry)
        wi_ggx = vec3.where(m.spec_dist == 1, wi_beck, wi_ggx)
        rx_sheen = torch.where(use_sheen, rx * 2.0, rx)
        wi_sheen, _ = ggx.sample(m.ggx2, wo, rx_sheen, ry)
        wi_skin = vec3.where(use_sheen, wi_sheen, wi_ggx)
        wi = vec3.where(m.mtype == MAT_SKIN, wi_skin, wi_ggx)
    if m.dsy is not None:
        wi = vec3.where(m.mtype == MAT_DISNEY,
                        disney.sample_specular(m.dsy, wo, rx, ry), wi)
    return wi


@tracer.traced("bsdf")
def sample_refract(m: MatG, wo: V3, rx, ry):
    """(wi V3, weight V3) of one rough-refraction sample (integrateRefract
    per sample, rlGgx.h:228-243); the weight is 0 where nothing refracts."""
    if _on_card(wo):
        return kernels.sample_refract(m, wo, rx, ry)
    wi, w, _ = ggx.sample_refract(m.ggx, wo, rx, ry)
    return wi, vec3.where(m.has_refract, m.kt_color * w, 0.0)
