"""Wavefront path-tracing integrator.

Counterpart of rlshaders_tpu/integrator/wavefront.py. Each ray generation
is traced as one batch (`accel.trace`), shaded, and lit by a light grid
whose shadow rays are one more batch; BSDF-sampled diffuse, glossy and
refraction families continue the path, their emission pickups tested by
shadow rays, with the depth gates of the reference (rlGgx.cpp:151-154)
unrolled by Python recursion. The JAX version's jit becomes eager torch.

Light transport, as in the JAX version:
* camera hit: direct light by MIS over the light grid (quad and disk
  lights; the dome column is dropped when both BSDF families spawn) +
  diffuse/glossy families of GI_*_samples^2 rays with analytic light and
  dome pickup;
* secondary hits: direct light + depth-gated continuation families for
  `standard` (Arnold recursion), direct-only for rlGgx (its indirect is
  camera-only, rlGgx.cpp:307), and the one-sample BSDF pickup of lights
  for lobes whose depth is exhausted;
* rough refraction (integrateRefract, rlGgx.h:205-246): GI_refraction_
  samples^2 rays at camera hits, one at deeper hits, down to
  GI_refraction_depth, with optional Russian roulette on the chain;
* shadows through transmissive or transparent surfaces: a march of
  SHADOW_HITS nearest queries multiplying each surface's transmission
  (fully opaque scenes keep one any-hit query per segment);
* subsurface scattering (integrator/sss.py): rlSkin's and the `standard`
  shader's Ksss lobe at camera hits, a probe stage per tile over exactly
  its SSS lanes, whose diffuse it replaces; and rlSkin on refracted rays,
  one probe a hit;
* rlDisney's indirect multipliers: the camera-level diffuse and glossy
  families of a Disney hit are scaled by its indirectDiffuseScale and
  indirectSpecularScale, and the direct light of Disney hits inside those
  families (`indirect_scaled`) by the hit's own;
* textures and bump maps (models/dispatch.py): every hit carries a
  ray-cone footprint, the pixel's spread (from the render's width) times
  the distance, widened at grazing incidence; a family ray starts from its
  origin's footprint with the spread of its lobe (1 for diffuse rays, the
  roughness alpha or the pixel's for glossy and refracted ones). Scenes
  without texture links or bump maps skip all of it.

The defaults of the JAX knobs are constants here: MIS renormalization on,
both MIS count scales 1, faceforward by the shading normal, Owen-Sobol
streams at camera hits, a march of 4 hits (RLS_SHADOW_HITS), a level of
detail bias of -0.5 (RLS_LOD_BIAS) and a footprint inflation exponent of
0.5 (RLS_TEX_ANISO_ALPHA). Russian roulette (RLS_RR_START) is `render`'s
`rr_refr_start`, and the per-stage timers (RLS_PROFILE) its `profile`.

`render_progressive` averages independently seeded passes and can flush
the running mean of the beauty to an EXR after each pass.
"""
from __future__ import annotations

import math
import time
from functools import partial
from typing import NamedTuple

import torch

from ..accel import trace as tracemod
from ..core import rng, vec3
from ..core.frame import (
    Frame, build_frame_polar_v, tile_frame, to_local_v, to_world_v,
)
from ..core.vec3 import V3, v3
from ..models import dispatch
from ..scene.build import (
    MAT_DISNEY, MAT_SKIN, MAT_STANDARD, Scene, VIS_CAMERA, VIS_DIFFUSE,
    VIS_GLOSSY, VIS_REFRACTED, VIS_SHADOW,
)
from . import camera as cameramod
from . import lights as lightsmod
from . import splat as splatmod

RAY_EPS = 1e-3
# transparent hits a shadow segment marches through; further stacked
# surfaces count as opaque (the JAX version's RLS_SHADOW_HITS default)
SHADOW_HITS = 4
# texture level of detail bias in levels: the ray cone's footprint is its
# diameter, a level wider than a per-pixel derivative (RLS_LOD_BIAS)
LOD_BIAS = -0.5
# grazing widening of the footprint: fp *= max(cos^-alpha, 1 / (8 cos))
# (RLS_TEX_ANISO_ALPHA)
TEX_ANISO_ALPHA = 0.5

# purpose ids of the per-(pixel, purpose) Sobol streams; light columns add
# their light index
P_QUAD = 101 << 8
P_DISK = 301 << 8
P_SKY = 501 << 8
P_DIFFUSE = 601 << 8
P_GLOSSY = 602 << 8
P_REFRACT = 603 << 8


class DeviceScene(NamedTuple):
    """The scene tables the shading stages read, all on one device, and
    the counts of rays handed to each query."""

    geometry: object       # scene.build.Geometry
    materials: object      # scene.build.Materials
    quad_lights: object    # scene.build.QuadLights
    disk_lights: object    # scene.build.DiskLights
    sky_radiance: torch.Tensor  # (3,)
    textures: object       # scene.texture.TextureStack
    accel: tracemod.Accel
    stats: dict


class SceneStatic(NamedTuple):
    """Per-scene facts the generation tree branches on (host values)."""

    quad_valid: tuple
    quad_samples: tuple
    quad_w_d: tuple        # per light: affect_diffuse * diffuse_weight
    quad_w_s: tuple
    disk_valid: tuple
    disk_samples: tuple
    disk_w_d: tuple        # per light: affect_diffuse
    disk_w_s: tuple
    sky_exists: bool
    sky_samples: int
    sky_w_d: float
    sky_w_s: float
    nb_d: int              # camera-level BSDF-strategy counts for MIS
    nb_g: int
    has_refract: bool      # any material with Kt > 0
    has_transparent: bool  # refraction or opacity < 1: shadows march
    has_skin: bool         # any SSS lobe (rlSkin or standard Ksss)
    has_skin_mat: bool     # an rlSkin material (SSS on secondary rays too)
    has_disney: bool       # an rlDisney material
    has_tex: bool          # a diffuse or Ks texture link
    has_bump: bool         # a bump3d map
    tex_gamma: float       # texture_gamma, applied after filtering

    @staticmethod
    def of(scene: Scene) -> "SceneStatic":
        """Facts of `scene`."""
        mats = scene.materials
        ql, dl = scene.quad_lights, scene.disk_lights
        sky, o = scene.sky, scene.options
        has_refract = bool((mats.kt > 1e-5).any())
        has_skin_mat = bool((mats.mtype == MAT_SKIN).any())
        has_disney = bool((mats.mtype == MAT_DISNEY).any())
        return SceneStatic(
            quad_valid=ql.valid,
            quad_samples=ql.samples,
            quad_w_d=tuple(float(a) * float(b) for a, b in
                           zip(ql.affect_diffuse, ql.diffuse_weight)),
            quad_w_s=tuple(float(a) * float(b) for a, b in
                           zip(ql.affect_specular, ql.specular_weight)),
            disk_valid=dl.valid,
            disk_samples=dl.samples,
            disk_w_d=tuple(float(a) for a in dl.affect_diffuse),
            disk_w_s=tuple(float(a) for a in dl.affect_specular),
            sky_exists=sky.exists,
            sky_samples=sky.samples,
            sky_w_d=float(sky.affect_diffuse),
            sky_w_s=float(sky.affect_specular),
            nb_d=(o.gi_diffuse_samples ** 2 if o.gi_diffuse_depth > 0 else 0),
            nb_g=(o.gi_glossy_samples ** 2 if o.gi_glossy_depth > 0 else 0),
            has_refract=has_refract,
            has_transparent=(has_refract
                             or bool((mats.opacity < 1.0 - 1e-5).any())),
            has_skin=has_skin_mat or bool((mats.sss_weight > 1e-5).any()),
            has_skin_mat=has_skin_mat,
            has_disney=has_disney,
            has_tex=bool((mats.kd_tex >= 0).any() | (mats.ks_tex >= 0).any()),
            has_bump=bool((mats.bump_tex >= 0).any()),
            tex_gamma=float(o.texture_gamma),
        )

    def has_area_lights(self) -> bool:
        return any(self.quad_valid) or any(self.disk_valid)


class RenderConf(NamedTuple):
    """Depth gates and sample splits from the options node."""

    gi_diffuse_depth: int
    gi_glossy_depth: int
    gi_refraction_depth: int
    gi_total_depth: int
    gi_sss_samples: int
    nb_d: int
    nb_g: int
    nb_r: int   # camera-level refraction rays per hit
    n_sub: int  # AA samples per pixel (aa^2)
    # per-unit-distance footprint of one pixel (the ray cone's spread),
    # from the render's width; AA samples share their pixel's
    pix_spread: float
    # Russian roulette on the refraction chain: at refraction depth >= this
    # a continuation survives with p = clip(max channel of its weight,
    # 0.05, 1) and is reweighted 1/p; 99 = off, as in the reference
    rr_refr_start: int


class Surface(NamedTuple):
    p: V3
    ns: V3       # smooth shading normal, not faced
    nf: V3       # shading normal, faced toward the incoming ray
    mat_id: torch.Tensor
    mesh_id: torch.Tensor
    tri: torch.Tensor     # -1 on a miss
    entering: torch.Tensor
    valid: torch.Tensor
    # the texture footprint (None in scenes without textures or bump):
    uv: torch.Tensor | None     # (N, 2) interpolated mesh uv
    fp: torch.Tensor | None     # (N,) world-space ray-cone diameter
    fp_uv: torch.Tensor | None  # (N,) fp through the triangle's uv density


class SampleCtx(NamedTuple):
    """Sampler addressing of the camera-level lanes: flat pixel id and AA
    index per lane, and the render's salt. The Owen-Sobol draws key on
    (pixel, purpose, salt) and index on aa * count + k, so a pixel's whole
    budget of one integral is one jointly stratified sequence."""

    pix: torch.Tensor   # (N,) int32
    aa: torch.Tensor    # (N,) AA-sample index in [0, n_sub)
    salt: int           # uint32


class SSSIn(NamedTuple):
    """The camera-hit fields of a tile that the SSS stage reads."""

    p: torch.Tensor               # (N, 3)
    ns: torch.Tensor              # (N, 3) smooth normal, not faced
    mesh_id: torch.Tensor
    valid: torch.Tensor
    sss_weight: torch.Tensor      # layered by rlSkin's Fresnel
    sss_dist: torch.Tensor        # (N, 3)
    sss_color: torch.Tensor       # (N, 3)
    cavity_fadeout: torch.Tensor
    cubic: torch.Tensor           # `standard` Ksss lanes: cubic falloff
    pix: torch.Tensor             # the tile's sampler addressing
    aa: torch.Tensor
    salt: int


class LightGrid(NamedTuple):
    """K columns x N rays of light samples, column-major (column c = rows
    [c*N, (c+1)*N)); the per-column values are repeated per row."""

    wi: V3
    dist: torch.Tensor
    rad: V3
    pdf: torch.Tensor
    w_d: torch.Tensor     # per-column diffuse weight (affect / samples)
    w_s: torch.Tensor
    nl: torch.Tensor      # per-column light sample counts for MIS
    is_sky: torch.Tensor  # per-column, True for the dome


def _zeros3(like: torch.Tensor) -> V3:
    z = torch.zeros_like(like)
    return V3(z, z, z)


def _row(a: torch.Tensor) -> V3:
    return V3(a[0], a[1], a[2])


def _nearest(sc: DeviceScene, o, d, vis_mask, exclude=None, t_max=None):
    sc.stats["nearest_rays"] += o.shape[0]
    sc.stats["nearest_calls"] += 1
    return tracemod.nearest(sc.accel, o, d, vis_mask=vis_mask,
                            exclude_tri=exclude, t_max=t_max)


def _occluded(sc: DeviceScene, o, d, tmax, ex) -> torch.Tensor:
    sc.stats["shadow_rays"] += o.shape[0]
    sc.stats["shadow_calls"] += 1
    return tracemod.occluded(sc.accel, o, d, tmax, vis_mask=VIS_SHADOW,
                             exclude_tri=ex)


def _shadow_transmission(sc: DeviceScene, static: SceneStatic, sh) -> V3:
    """Per-channel shadow transmission (1 = visible) along the segments of
    `sh` = (o, d, t_max, exclude).

    Fully opaque scenes take one any-hit query. Scenes with transmissive or
    transparent materials march up to SHADOW_HITS nearest hits along each
    segment, multiplying each surface's transmission clip(max(Kt*KtColor,
    1 - opacity), 0, 1) (rlGgx.cpp:264-268). Lanes whose segment is used up,
    or whose transmission fell to 1e-4, take t_max 0 in the later steps:
    dead lanes, which the query returns at once."""
    o, d, tmax, ex = sh
    if not static.has_transparent:
        vis = (~_occluded(sc, o, d, tmax, ex)).to(torch.float32)
        return V3(vis, vis, vis)
    sc.stats["march_segments"] += o.shape[0]
    mats = sc.materials
    one = torch.ones(o.shape[0], device=o.device)
    atten = V3(one, one, one)
    origin, remaining, exclude = o, tmax, ex
    for _ in range(SHADOW_HITS):
        hit = _nearest(sc, origin, d, VIS_SHADOW, exclude=exclude,
                       t_max=torch.clamp_min(remaining, 0.0))
        ok = (hit.tri >= 0) & (hit.t < remaining)
        mid = sc.geometry.mat_id[torch.clamp_min(hit.tri, 0).long()].long()
        kt = v3(mats.kt_color[mid]) * mats.kt[mid]
        trans = vec3.clip(vec3.vmax(kt, 1.0 - v3(mats.opacity[mid])),
                          0.0, 1.0)
        atten = atten * vec3.where(ok, trans, 1.0)
        step = torch.where(ok, hit.t + 2 * RAY_EPS, remaining)
        origin = origin + d * step[:, None]
        remaining = torch.where(vec3.maxc(atten) > 1e-4, remaining - step,
                                0.0)
        exclude = torch.where(ok, hit.tri, -1)
    return atten


def _surface(sc: DeviceScene, t, tri_in, uu, vv, o, d, base_fp=None,
             spread=None) -> Surface:
    """The hit records as surfaces. With `spread` (scenes with textures or
    bump) also the uv and the ray-cone footprint: base_fp + spread * t,
    widened at grazing incidence by max(cos^-alpha, 1 / (8 cos)) and
    mapped to uv by the triangle's uv/world area ratio."""
    g = sc.geometry
    tri = torch.clamp_min(tri_in, 0).long()
    valid = tri_in >= 0
    e1 = v3(g.e1[tri])
    e2 = v3(g.e2[tri])
    dv = v3(d)
    p = v3(o) + dv * t
    ng_un = vec3.cross(e1, e2)
    ng = vec3.normalize(ng_un)
    w = 1.0 - uu - vv
    ns = vec3.normalize(
        v3(g.n0[tri]) * w + v3(g.n1[tri]) * uu + v3(g.n2[tri]) * vv)
    entering = vec3.dot(ng, dv) < 0.0
    # faceforward the shading normal by its own side (ns.d): by the facet's
    # side it flips per facet across grazing zones of curved meshes
    sign = torch.where(vec3.dot(ns, dv) < 0.0, 1.0, -1.0)
    uv = fp = fp_uv = None
    if spread is not None:
        uv0, uv1, uv2 = g.uv0[tri], g.uv1[tri], g.uv2[tri]
        uv = w[..., None] * uv0 + uu[..., None] * uv1 + vv[..., None] * uv2
        tc = torch.where(valid, t, 0.0)
        cosg = torch.clamp_min(torch.abs(vec3.dot(ng, dv)), 0.05)
        inflate = torch.maximum(torch.pow(cosg, -TEX_ANISO_ALPHA),
                                1.0 / (8.0 * cosg))
        fp = (base_fp + spread * tc) * inflate
        duv1 = uv1 - uv0
        duv2 = uv2 - uv0
        area_uv = torch.abs(duv1[..., 0] * duv2[..., 1]
                            - duv1[..., 1] * duv2[..., 0])
        area_w = torch.sqrt(torch.clamp_min(vec3.dot(ng_un, ng_un), 0.0))
        fp_uv = fp * torch.sqrt(area_uv / torch.clamp_min(area_w, 1e-20))
    return Surface(
        p=p, ns=ns, nf=ns * sign, mat_id=g.mat_id[tri],
        mesh_id=g.mesh_id[tri],
        tri=torch.where(valid, tri_in, -1), entering=entering, valid=valid,
        uv=uv, fp=fp, fp_uv=fp_uv,
    )


def _light_grid(sc: DeviceScene, static: SceneStatic, pv: V3, nfv: V3, key,
                camera_level: bool, include_sky: bool,
                ctx: SampleCtx | None) -> LightGrid | None:
    """One chunk of N rows per (light, sample) column. include_sky=False
    drops the dome: with both camera-level BSDF families spawning, its
    cosine pdf duplicates the diffuse family's."""
    n = pv.x.shape[0]
    dev = pv.x.device
    samples, cols = [], []

    def add(ls, k, w_d, w_s, s, sky):
        samples.append(ls)
        cols.extend([(w_d / s, w_s / s, float(s), sky)] * k)

    ql = sc.quad_lights
    for li, valid in enumerate(static.quad_valid):
        if not valid:
            continue
        s_per = static.quad_samples[li] if camera_level else 1
        s = s_per * s_per
        if ctx is not None:
            u = rng.sobol2_flat(ctx.pix, ctx.aa, s, P_QUAD + li, ctx.salt)
        elif s > 1:
            u = rng.stratified2_flat(rng.fold(key, 101, li), n, s_per, dev)
        else:
            u = rng.uniform2(rng.fold(key, 101, li), (n,), dev)
        ls = lightsmod.sample_quad_flat(
            ql.verts[li], ql.normal[li], ql.area[li], ql.radiance[li],
            vec3.tile(pv, s), u)
        add(ls, s, static.quad_w_d[li], static.quad_w_s[li], s, False)

    dl = sc.disk_lights
    for li, valid in enumerate(static.disk_valid):
        if not valid:
            continue
        s_per = static.disk_samples[li] if camera_level else 1
        s = s_per * s_per
        if ctx is not None:
            u = rng.sobol2_flat(ctx.pix, ctx.aa, s, P_DISK + li, ctx.salt)
        elif s > 1:
            u = rng.stratified2_flat(rng.fold(key, 301, li), n, s_per, dev)
        else:
            u = rng.uniform2(rng.fold(key, 301, li), (n,), dev)
        ls = lightsmod.sample_disk_flat(
            dl.center[li], dl.u[li], dl.v[li], dl.normal[li], dl.area[li],
            dl.radiance[li], vec3.tile(pv, s), u)
        add(ls, s, static.disk_w_d[li], static.disk_w_s[li], s, False)

    if static.sky_exists and include_sky:
        s = max(static.sky_samples, 1) if camera_level else 1
        if ctx is not None:
            u = rng.sobol2_flat(ctx.pix, ctx.aa, s, P_SKY, ctx.salt)
        else:
            u = rng.uniform2(rng.fold(key, 501), (s * n,), dev)
        ls = lightsmod.sample_sky_flat(sc.sky_radiance, vec3.tile(nfv, s), u)
        add(ls, s, static.sky_w_d, static.sky_w_s, s, True)

    if not samples:
        return None

    cat = torch.cat

    def col(i, dtype=torch.float32):
        vals = torch.tensor([c[i] for c in cols], dtype=dtype, device=dev)
        return vals.repeat_interleave(n)

    return LightGrid(
        wi=V3(*(cat([ls.direction[c] for ls in samples]) for c in range(3))),
        dist=cat([ls.dist for ls in samples]),
        rad=V3(*(cat([ls.radiance[c] for ls in samples]) for c in range(3))),
        pdf=cat([ls.pdf for ls in samples]),
        w_d=col(0), w_s=col(1), nl=col(2), is_sky=col(3, torch.bool),
    )


def _direct_eval(matv, frame: Frame, wo: V3, grid: LightGrid, nb_d, nb_g,
                 sky_nb_d, sky_nb_g):
    """MIS-weighted per-column light contributions before shadowing:
    (contrib_d V3, contrib_s V3, live), flat (k*N,). `live` marks columns
    with a nonzero contribution; the others get no shadow ray.

    nb_* are the BSDF-strategy counts competing with quad columns, sky_nb_*
    those competing with dome columns: a depth-exhausted secondary hit has
    no dome strategy on the BSDF side, so its dome column takes full weight.
    """
    n = wo.x.shape[0]
    k = grid.pdf.shape[0] // n
    wi_l = to_local_v(tile_frame(frame, k), grid.wi)
    matv_k = dispatch.tile_v(matv, k)
    wo_k = vec3.tile(wo, k)
    fd, pd = dispatch.eval_diffuse(matv_k, wo_k, wi_l)
    fs, ps = dispatch.eval_specular(matv_k, wo_k, wi_l)

    inv_pdf = torch.where(grid.pdf > 0.0,
                          1.0 / torch.clamp_min(grid.pdf, 1e-12), 0.0)
    nbd = torch.where(grid.is_sky, float(sky_nb_d), float(nb_d))
    nbg = torch.where(grid.is_sky, float(sky_nb_g), float(nb_g))
    wl_d = lightsmod.mis_weight(grid.nl * grid.pdf, nbd * pd)
    wl_s = lightsmod.mis_weight(grid.nl * grid.pdf, nbg * ps)
    contrib_d = grid.rad * (inv_pdf * wl_d * grid.w_d) * fd
    contrib_s = grid.rad * (inv_pdf * wl_s * grid.w_s) * fs
    live = (contrib_d.x + contrib_d.y + contrib_d.z
            + contrib_s.x + contrib_s.y + contrib_s.z) > 0.0
    return contrib_d, contrib_s, live


def _area_lights(sc, static, lobe):
    """Every valid area light, quads then disks, as (intersect, normal,
    area, radiance, samples, factor): `intersect(o, d)` gives (hit, t) of
    BSDF rays, `factor` is the light's weight for `lobe`."""
    ql, dl = sc.quad_lights, sc.disk_lights
    for li, valid in enumerate(static.quad_valid):
        if valid:
            yield (partial(lightsmod.intersect_quad_flat, ql.verts[li],
                           ql.normal[li]),
                   ql.normal[li], ql.area[li], ql.radiance[li],
                   static.quad_samples[li],
                   static.quad_w_d[li] if lobe == "diffuse"
                   else static.quad_w_s[li])
    for li, valid in enumerate(static.disk_valid):
        if valid:
            yield (partial(lightsmod.intersect_disk_flat, dl.center[li],
                           dl.u[li], dl.v[li], dl.normal[li]),
                   dl.normal[li], dl.area[li], dl.radiance[li],
                   static.disk_samples[li],
                   static.disk_w_d[li] if lobe == "diffuse"
                   else static.disk_w_s[li])


def _light_pickup(sc, static, o: V3, d: V3, lobe_pdf, nb, camera_level,
                  lobe):
    """Analytic emission of the nearest area light along BSDF rays, MIS
    weighted against the light strategy: (emission V3, t_light). The caller
    tests occlusion with a shadow segment to t_light: shadow-invisible
    geometry in front of a light must not kill the pickup."""
    out = _zeros3(lobe_pdf)
    t_light = torch.full_like(lobe_pdf, 1e30)
    for intersect, normal, area, radiance, samples, fac in _area_lights(
            sc, static, lobe):
        if fac == 0.0:
            continue
        nl = float(samples ** 2) if camera_level else 1
        hit, t = intersect(o, d)
        cos_l = torch.abs(vec3.dot(d, _row(normal)))
        p_l = (t * t) / torch.clamp_min(cos_l * area, 1e-12)
        w = lightsmod.mis_weight(nb * lobe_pdf, nl * p_l)
        take = hit & (t < t_light)
        out = vec3.where(take, _row(radiance) * (fac * w), out)
        t_light = torch.where(take, t, t_light)
    return out, t_light


def _sky_pickup(sc, static, nf_at_origin: V3, d: V3, vis: V3, lobe_pdf, nb,
                lobe, full_weight) -> V3:
    """Dome radiance picked up by BSDF-family directions; `vis` is the
    shadow-ray transmission along the direction."""
    fac = static.sky_w_d if lobe == "diffuse" else static.sky_w_s
    if not static.sky_exists or fac == 0.0:
        return _zeros3(lobe_pdf)
    if full_weight:
        # the light grid skipped the dome column: the BSDF strategy carries
        # all of its energy
        w = 1.0
    else:
        p_l = lightsmod.pdf_sky_v(nf_at_origin, d)
        w = lightsmod.mis_weight(nb * lobe_pdf, 1.0 * p_l)
    return _row(sc.sky_radiance) * vis * (fac * w)


def _spawn(sc, static, surf: Surface, pv, matv, frame, wo, key, lobe, nb,
           ctx: SampleCtx | None):
    """BSDF-sample nb rays per hit for one lobe: flat V3 rays and per-sample
    weights and pdfs in sample-major chunks (sample s = rows [s*N,
    (s+1)*N))."""
    n = pv.x.shape[0]
    if ctx is not None:
        purpose = P_DIFFUSE if lobe == "diffuse" else P_GLOSSY
        u = rng.sobol2_flat(ctx.pix, ctx.aa, nb, purpose, ctx.salt)
    else:
        u = rng.stratified2_flat(key, n, int(round(nb ** 0.5)), pv.x.device)
    matv_b = dispatch.tile_v(matv, nb)
    wo_b = vec3.tile(wo, nb)
    if lobe == "diffuse":
        wi_l = dispatch.sample_diffuse(matv_b, wo_b, u[:, 0], u[:, 1])
        f, pdf = dispatch.eval_diffuse(matv_b, wo_b, wi_l)
        active = matv.has_diffuse
        if static.has_skin:
            # rlSkin's diffuse is the SSS stage's
            active = active & (matv.mtype != MAT_SKIN)
    else:
        wi_l = dispatch.sample_specular(matv_b, wo_b, u[:, 0], u[:, 1])
        f, pdf = dispatch.eval_specular(matv_b, wo_b, wi_l)
        active = matv.has_spec
    wi_w = to_world_v(tile_frame(frame, nb), wi_l)
    ok = ((active & surf.valid).repeat(nb) & (wo_b.z > 1e-4)
          & (wi_l.z > 1e-5) & (pdf > 1e-9))
    w = vec3.where(ok, f / torch.clamp_min(pdf, 1e-9), 0.0)
    if nb > 1:
        # valid-sample renormalization (the Arnold host zeroes
        # below-hemisphere samples and divides by the valid count)
        n_valid = ok.reshape(nb, n).sum(0).to(torch.float32)
        w = w * (nb / torch.clamp_min(n_valid, 1.0)).repeat(nb)
    o = vec3.tile(pv, nb) + wi_w * RAY_EPS
    return o, wi_w, w, torch.where(ok, pdf, 0.0), ok


def _spec_direct_t(sc, static, surf: Surface, pv, matv, frame, wo, key,
                   lobes) -> V3:
    """One BSDF sample per hit for each lobe in `lobes` (depth exhausted):
    analytic nearest-light emission, MIS against the one-sample light
    strategy, and a shadow segment to the light."""
    n = pv.x.shape[0]
    out = _zeros3(pv.x)
    for i, lobe in enumerate(("specular", "diffuse")):
        if lobe not in lobes:
            continue
        u = rng.uniform2(rng.fold(key, 4242 + i), (n,), pv.x.device)
        if lobe == "specular":
            wi_l = dispatch.sample_specular(matv, wo, u[:, 0], u[:, 1])
            f, pdf = dispatch.eval_specular(matv, wo, wi_l)
            active = matv.has_spec
        else:
            wi_l = dispatch.sample_diffuse(matv, wo, u[:, 0], u[:, 1])
            f, pdf = dispatch.eval_diffuse(matv, wo, wi_l)
            active = matv.has_diffuse
        wi_w = to_world_v(frame, wi_l)
        ok = (active & surf.valid & (wi_l.z > 1e-5) & (pdf > 1e-9)
              & (wo.z > 1e-4))
        emit = _zeros3(pv.x)
        t_light = torch.full((n,), 1e30, device=pv.x.device)
        # lights whose factor is 0 still take the nearest hit here
        for intersect, normal, area, radiance, _, fac in _area_lights(
                sc, static, lobe):
            hq, tq = intersect(pv, wi_w)
            cos_l = torch.abs(vec3.dot(wi_w, _row(normal)))
            p_l = (tq * tq) / torch.clamp_min(cos_l * area, 1e-12)
            w_b = lightsmod.mis_weight(1.0 * pdf, 1.0 * p_l)
            take = hq & (tq < t_light)
            emit = vec3.where(take, _row(radiance) * (fac * w_b), emit)
            t_light = torch.where(take, tq, t_light)
        w_over_pdf = vec3.where(ok, f / torch.clamp_min(pdf, 1e-9), 0.0)
        any_emit = vec3.maxc(emit) > 0.0
        # normal + direction origin offset and a 3*RAY_EPS margin, so the
        # segment ends in front of the light plane at grazing incidence
        blocked = _occluded(
            sc, (pv + frame.n * RAY_EPS + wi_w * RAY_EPS).aos(), wi_w.aos(),
            torch.where(t_light < 1e30, t_light - 3 * RAY_EPS, 0.0),
            surf.tri)
        lit = ok & any_emit & ~blocked
        out = out + vec3.where(lit, w_over_pdf * emit, 0.0)
    return out


def _footprint(static, conf, n, base_fp, spread, device):
    """(base_fp, spread) of a generation's rays: None in scenes without
    textures or bump, else a camera generation's defaults (no base, the
    pixel's spread) where the caller gives none."""
    if not (static.has_tex or static.has_bump):
        return None, None
    if base_fp is None:
        base_fp = torch.zeros(n, device=device)
    if spread is None:
        spread = torch.full((n,), conf.pix_spread, device=device)
    return base_fp, spread


def _lobe_spread(conf, matv, lobe: str, nb: int, surf: Surface):
    """The spread of family rays leaving `surf` by `lobe`: 1 for diffuse
    rays, else the larger of the roughness alpha and the pixel's; None in
    scenes without a footprint."""
    if surf.fp is None:
        return None
    if lobe == "diffuse":
        return torch.ones(surf.fp.shape[0] * nb, device=surf.fp.device)
    return torch.clamp_min(matv.ggx.alpha_g, conf.pix_spread).repeat(nb)


def _tiled_fp(surf: Surface, nb: int):
    return None if surf.fp is None else surf.fp.repeat(nb)


def _gen_shade_t(sc, static, conf, o, d, key, vis, camera_level,
                 indirect_scaled, base_fp=None, spread=None,
                 trace_pack=None, ctx: SampleCtx | None = None,
                 ray_lobe="camera", rr=(0, 0, 0, 0)):
    """Trace (unless `trace_pack` holds the hits) and shade one generation:
    surface, bump, material with its textures, light grid with shadow
    rays, MIS direct light. `indirect_scaled` scales the direct light of
    Disney hits by their indirect multipliers (generations inside a
    camera-level family); `base_fp` and `spread` are the rays' footprint
    at their origin and its growth per unit distance."""
    n = o.shape[0]
    if trace_pack is None:
        hit = _nearest(sc, o, d, vis)
        trace_pack = (hit.t, hit.tri, hit.u, hit.v)
    t, tri, uu, vv = trace_pack

    base_fp, spread = _footprint(static, conf, n, base_fp, spread, o.device)
    surf = _surface(sc, t, tri, uu, vv, o, d, base_fp, spread)
    if static.has_bump:
        ns = dispatch.apply_bump(sc.materials, sc.textures, surf.mat_id,
                                 surf.p, surf.ns, fp=surf.fp,
                                 tex_gamma=static.tex_gamma)
        sign = torch.where(vec3.dot(ns, v3(d)) < 0.0, 1.0, -1.0)
        surf = surf._replace(ns=ns, nf=ns * sign)
    tex = None
    if static.has_tex:
        tex = dispatch.TexLookup(sc.textures, surf.uv, surf.p, surf.fp,
                                 surf.fp_uv, LOD_BIAS, static.tex_gamma)
    matv = dispatch.gather(sc.materials, surf.mat_id, surf.entering,
                           has_skin=static.has_skin_mat,
                           has_disney=static.has_disney,
                           diffuse_ray=(ray_lobe == "diffuse"), tex=tex)
    pv = surf.p
    nfv = surf.nf
    frame = build_frame_polar_v(nfv)
    wo = to_local_v(frame, -v3(d))
    if static.has_skin_mat:
        # rlSkin's view-averaged Fresnel layering (rlSkin.cpp:204-238): the
        # specular under the sheen, the SSS weight and the diffuse-ray albedo
        matv = dispatch.skin_layer_fields(matv, wo)
    sky_in_grid = not (camera_level and static.nb_d > 0 and static.nb_g > 0)
    grid = _light_grid(sc, static, pv, nfv, key, camera_level,
                       include_sky=sky_in_grid, ctx=ctx)
    if grid is not None:
        k = grid.pdf.shape[0] // n
        # camera level: the BSDF strategies are the spawned families; at
        # secondary hits both lobes compete with a one-sample strategy, and
        # the dome's BSDF-side strategy exists only where a continuation
        # family spawns
        if camera_level:
            nb_d, nb_g = static.nb_d, static.nb_g
            sky_nb_d, sky_nb_g = nb_d, nb_g
        else:
            nb_d = nb_g = 1
            rd, rg, _, rt = rr
            cont_d = rd < conf.gi_diffuse_depth and rt < conf.gi_total_depth
            cont_g = (ray_lobe != "diffuse" and rg < conf.gi_glossy_depth
                      and rt < conf.gi_total_depth)
            sky_nb_d = 1 if cont_d else 0
            sky_nb_g = 1 if cont_g else 0
        contrib_d, contrib_s, live = _direct_eval(
            matv, frame, wo, grid, nb_d, nb_g, sky_nb_d, sky_nb_g)
        # receive_shadows off: the surface is lit as if unoccluded
        rcv = sc.geometry.receive_shadows[
            torch.clamp_min(tri, 0).long()].repeat(k)
        # shadow origins offset along the normal as well as the ray: a
        # ray-only offset self-occludes grazing segments of curved geometry
        sh_o = (vec3.tile(pv, k) + vec3.tile(nfv, k) * RAY_EPS
                + grid.wi * RAY_EPS).aos()
        # dead columns get t_max 0 and cost the kernel nothing
        sh_t = torch.where(live & rcv, grid.dist - 3 * RAY_EPS, 0.0)
        shadowed = _shadow_transmission(
            sc, static, (sh_o, grid.wi.aos(), sh_t, surf.tri.repeat(k)))
        shadowed = vec3.where(rcv, shadowed, 1.0)
        diffuse = vec3.ksum(contrib_d * shadowed, k)
        specular = vec3.ksum(contrib_s * shadowed, k)
    else:
        diffuse = _zeros3(pv.x)
        specular = _zeros3(pv.x)
    if camera_level and static.has_skin:
        # rlSkin's diffuse at camera hits is the SSS stage's
        diffuse = vec3.where(matv.mtype == MAT_SKIN, 0.0, diffuse)
    if indirect_scaled and static.has_disney:
        is_dsy = matv.mtype == MAT_DISNEY
        diffuse = vec3.where(is_dsy, diffuse * matv.indirect_diffuse_scale,
                             diffuse)
        specular = vec3.where(is_dsy,
                              specular * matv.indirect_specular_scale,
                              specular)
    radiance = diffuse + specular + matv.emission
    valid = surf.valid
    return (
        surf, matv, pv, nfv, frame, wo,
        vec3.where(valid, radiance, 0.0),
        vec3.where(valid, diffuse, 0.0),
        vec3.where(valid, specular, 0.0),
    )


def _family_t(sc, static, conf, surf, pv, nfv, matv, frame, wo, key, lobe,
              nb, cam_pickup, ctx: SampleCtx | None = None):
    """Spawn + trace + analytic light and dome pickup of one lobe family.
    Returns (o, d, weight V3, pickup V3, hits)."""
    oV, dV, w1, pdf1, _ = _spawn(sc, static, surf, pv, matv, frame, wo, key,
                                 lobe, nb, ctx)
    o1 = oV.aos()
    d1 = dV.aos()
    hit = _nearest(sc, o1, d1,
                   VIS_DIFFUSE if lobe == "diffuse" else VIS_GLOSSY)
    emit, t_light = _light_pickup(sc, static, oV, dV, pdf1, nb, cam_pickup,
                                  lobe)
    ex = surf.tri.repeat(nb)
    # normal + ray offset for shadow segments; the family ray keeps the
    # plain direction offset
    sh_o1 = (vec3.tile(pv, nb) + vec3.tile(nfv, nb) * RAY_EPS
             + dV * RAY_EPS).aos()
    if static.has_area_lights():
        # the BSDF-side light strategy is a shadow query to the light hit,
        # not the family ray's own geometry hit
        sh_t = torch.where(t_light < 1e30, t_light - 3 * RAY_EPS, 0.0)
        trans = _shadow_transmission(sc, static, (sh_o1, d1, sh_t, ex))
        rcv = sc.geometry.receive_shadows[
            torch.clamp_min(surf.tri, 0).long()].repeat(nb)
        pick = emit * vec3.where(rcv, trans, 1.0)
    else:
        pick = emit
    sky_full = cam_pickup and static.nb_d > 0 and static.nb_g > 0
    sky_fac = static.sky_w_d if lobe == "diffuse" else static.sky_w_s
    if static.sky_exists and sky_fac != 0.0:
        # dome visibility along the family direction is a shadow query:
        # misses see the dome, hits on shadow-visible opaque geometry do
        # not, and only hits on shadow-invisible or non-opaque geometry
        # need the trace (the other lanes carry t_max 0)
        miss = hit.tri < 0
        htc = torch.clamp_min(hit.tri, 0).long()
        passes = (((sc.geometry.visibility[htc] & VIS_SHADOW) == 0)
                  | ~sc.geometry.opaque[htc])
        maybe = ~miss & passes
        sky_t = torch.where(maybe, 1e12, 0.0)
        trans_sky = _shadow_transmission(sc, static, (sh_o1, d1, sky_t, ex))
        sky_vis = vec3.where(miss, 1.0, vec3.where(maybe, trans_sky, 0.0))
    else:
        one = torch.ones_like(pdf1)
        sky_vis = V3(one, one, one)
    pick = pick + _sky_pickup(sc, static, vec3.tile(nfv, nb), dV, sky_vis,
                              pdf1, nb, lobe, full_weight=sky_full)
    return o1, d1, w1, pick, (hit.t, hit.tri, hit.u, hit.v)


def _refr_t(sc, static, conf, surf: Surface, pv, matv, frame, wo, key, nb,
            ctx: SampleCtx | None = None, rrf: int = 0):
    """Rough-refraction spawn (Walter Eq.41 weights) + trace, nb rays per
    hit in sample-major chunks as in `_spawn`. At refraction depth
    rrf >= conf.rr_refr_start, Russian roulette kills low-weight
    continuations (survive with p = clip(maxc(weight), 0.05, 1), reweight
    1/p); killed lanes carry zero weight and are traced with t_max 0.
    Returns (o, d, weight V3, ok, hits)."""
    n = pv.x.shape[0]
    dev = pv.x.device
    if ctx is not None:
        u = rng.sobol2_flat(ctx.pix, ctx.aa, nb, P_REFRACT, ctx.salt)
    else:
        u = rng.stratified2_flat(key, n, int(round(nb ** 0.5)), dev)
    wi_l, wgt = dispatch.sample_refract(dispatch.tile_v(matv, nb),
                                        vec3.tile(wo, nb), u[:, 0], u[:, 1])
    ok = (surf.valid & matv.has_refract).repeat(nb)
    t_max = None
    if rrf >= conf.rr_refr_start:
        p_surv = torch.clamp(vec3.maxc(wgt), 0.05, 1.0)
        survive = rng.uniform(rng.fold(key, 777), (n * nb,), dev) < p_surv
        wgt = wgt * torch.where(survive, 1.0 / p_surv, 0.0)
        ok = ok & survive
        t_max = torch.where(ok, 1e30, 0.0)
    wi_w = to_world_v(tile_frame(frame, nb), wi_l)
    o1 = (vec3.tile(pv, nb) + wi_w * RAY_EPS).aos()
    d1 = wi_w.aos()
    hit = _nearest(sc, o1, d1, VIS_REFRACTED, t_max=t_max)
    return (o1, d1, vec3.where(ok, wgt, 0.0), ok,
            (hit.t, hit.tri, hit.u, hit.v))


def _lobe_family_full(sc, static, conf, surf, pv, nfv, matv, frame, wo, key,
                      lobe, nb, rr, indirect_scaled, cam_pickup=False,
                      ctx: SampleCtx | None = None) -> V3:
    """Family + one-deeper generation. At secondary hits the deeper
    radiance counts only for `standard` materials: the rl* plugins
    integrate indirect light at camera hits only (rlGgx.cpp:307-323)."""
    o1, d1, w1, pick, tp1 = _family_t(
        sc, static, conf, surf, pv, nfv, matv, frame, wo, key, lobe, nb,
        cam_pickup, ctx=ctx)
    _, sub_rgb, _, _ = _shade_generation_t(
        sc, static, conf, o1, d1, rng.fold(key, 7),
        VIS_DIFFUSE if lobe == "diffuse" else VIS_GLOSSY,
        camera_level=False, indirect_scaled=indirect_scaled, rr=rr,
        ray_lobe=lobe, base_fp=_tiled_fp(surf, nb),
        spread=_lobe_spread(conf, matv, lobe, nb, surf), trace_pack=tp1)
    if cam_pickup:
        sub = pick + sub_rgb
    else:
        is_std = (matv.mtype == MAT_STANDARD).repeat(nb)
        sub = pick + vec3.where(is_std, sub_rgb, 0.0)
    return vec3.kmean(w1 * sub, nb)


def _secondary_indirect_t(sc, static, conf, surf, pv, nfv, matv, frame, wo,
                          key, ray_lobe, rr, indirect_scaled) -> V3:
    """Indirect + BSDF-sampled direct light at a secondary hit under the GI
    depth gates; lobes whose depth is exhausted keep the one-sample light
    pickup."""
    rd, rg, rrf, rt = rr
    out = _zeros3(pv.x)
    fallback = []
    # no glossy continuation from diffuse rays (standard's glossy caustics
    # are off)
    if (ray_lobe != "diffuse" and rg < conf.gi_glossy_depth
            and rt < conf.gi_total_depth):
        out = out + _lobe_family_full(
            sc, static, conf, surf, pv, nfv, matv, frame, wo,
            rng.fold(key, 62), "specular", 1, (rd, rg + 1, rrf, rt + 1),
            indirect_scaled)
    else:
        fallback.append("specular")
    if rd < conf.gi_diffuse_depth and rt < conf.gi_total_depth:
        out = out + _lobe_family_full(
            sc, static, conf, surf, pv, nfv, matv, frame, wo,
            rng.fold(key, 61), "diffuse", 1, (rd + 1, rg, rrf, rt + 1),
            indirect_scaled)
    else:
        fallback.append("diffuse")
    if fallback and static.has_area_lights():
        out = out + _spec_direct_t(sc, static, surf, pv, matv, frame, wo,
                                   key, tuple(fallback))
    return out


def _shade_generation_t(sc, static, conf, o, d, key, vis, camera_level,
                        indirect_scaled, is_refraction=False,
                        rr=(0, 0, 0, 0), ray_lobe="camera", base_fp=None,
                        spread=None, trace_pack=None,
                        ctx: SampleCtx | None = None):
    """Trace + fully shade one ray generation; returns (surface pack, rgb,
    aov_d, aov_s). `rr` = (diffuse, glossy, refraction, total) depths at
    this hit. Refracted rays that miss see the dome."""
    surf, matv, pv, nfv, frame, wo, rgb, aov_d, aov_s = _gen_shade_t(
        sc, static, conf, o, d, key, vis, camera_level, indirect_scaled,
        base_fp, spread, trace_pack, ctx=ctx, ray_lobe=ray_lobe, rr=rr)
    if not camera_level:
        rgb = rgb + _secondary_indirect_t(
            sc, static, conf, surf, pv, nfv, matv, frame, wo, key, ray_lobe,
            rr, indirect_scaled)
        # rlSkin evaluates its BSSRDF on non-diffuse rays (rlSss.h:170-199),
        # one probe deep here. The reference gates on ray_lobe "glossy" or
        # "refracted"; its glossy families carry ray_lobe "specular", as
        # here, so only refracted generations take it.
        if (static.has_skin_mat and ray_lobe in ("glossy", "refracted")
                and conf.gi_sss_samples > 0):
            from . import sss as sssmod

            is_sss = (matv.sss_weight > 1e-5) & surf.valid
            rgb = rgb + v3(sssmod.sss_eval(
                sc, static, sssmod.sss_fields(surf, matv, is_sss),
                rng.fold(key, 5), n_sss=1,
                gi_diffuse=conf.gi_diffuse_depth))
    if is_refraction and static.sky_exists:
        rgb = rgb + vec3.where(
            ~surf.valid, _row(sc.sky_radiance) * torch.ones_like(rgb.x), 0.0)
    rd, rg, rrf, rt = rr
    if (rrf < conf.gi_refraction_depth and rt < conf.gi_total_depth
            and static.has_refract):
        o2, d2, wgt, ok, tp2 = _refr_t(
            sc, static, conf, surf, pv, matv, frame, wo, rng.fold(key, 900),
            1, rrf=rrf + 1)
        _, sub_rgb, _, _ = _shade_generation_t(
            sc, static, conf, o2, d2, rng.fold(key, 33), VIS_REFRACTED,
            camera_level=False, indirect_scaled=indirect_scaled,
            is_refraction=True, rr=(rd, rg, rrf + 1, rt + 1),
            ray_lobe="refracted", base_fp=surf.fp,
            spread=_lobe_spread(conf, matv, "refracted", 1, surf),
            trace_pack=tp2)
        rgb = rgb + vec3.where(ok, wgt * sub_rgb, 0.0)
    return (surf, matv, pv, nfv, frame, wo), rgb, aov_d, aov_s


def _tile(sc, static, conf, origin, direction, pixel, start, key):
    """The whole generation tree of one tile of camera rays but the SSS
    stage; returns (rgb (N, 3), aovs {name: (N, 3)}, the stage's inputs or
    None in a scene without SSS)."""
    n0 = origin.shape[0]
    lane = start + torch.arange(n0, dtype=torch.int32, device=origin.device)
    ctx = SampleCtx(pix=pixel, aa=lane % conf.n_sub,
                    salt=rng.bits_scalar(rng.fold(key, 3141)))
    pack, rgb, aov_dd, aov_ds = _shade_generation_t(
        sc, static, conf, origin, direction, rng.fold(key, 0), VIS_CAMERA,
        camera_level=True, indirect_scaled=False, rr=(99, 99, 99, 99),
        ray_lobe="camera", ctx=ctx)
    surf0, matv0, pv0, nfv0, frame0, wo0 = pack
    if static.sky_exists:
        rgb = rgb + vec3.where(
            ~surf0.valid, _row(sc.sky_radiance) * torch.ones_like(rgb.x), 0.0)
    zero = torch.zeros((n0, 3), device=origin.device)
    aovs = {"direct_diffuse": aov_dd.aos(), "direct_specular": aov_ds.aos(),
            "indirect_diffuse": zero, "indirect_specular": zero,
            "refraction": zero, "sss": zero}
    for nb, lobe, aov, fold_id, rr in (
            (conf.nb_d, "diffuse", "indirect_diffuse", 1, (1, 0, 0, 1)),
            (conf.nb_g, "specular", "indirect_specular", 2, (0, 1, 0, 1))):
        if nb:
            c = _lobe_family_full(
                sc, static, conf, surf0, pv0, nfv0, matv0, frame0, wo0,
                rng.fold(key, fold_id), lobe, nb, rr, indirect_scaled=True,
                cam_pickup=True, ctx=ctx)
            if static.has_disney:
                # rlDisney's indirectDiffuseScale / indirectSpecularScale
                s = (matv0.indirect_diffuse_scale if lobe == "diffuse"
                     else matv0.indirect_specular_scale)
                c = c * torch.where(matv0.mtype == MAT_DISNEY, s, 1.0)
            aovs[aov] = c.aos()
            rgb = rgb + c
    if conf.nb_r:
        o1, d1, wgt, ok, tp1 = _refr_t(
            sc, static, conf, surf0, pv0, matv0, frame0, wo0,
            rng.fold(key, 3), conf.nb_r, ctx=ctx, rrf=1)
        _, sub_rgb, _, _ = _shade_generation_t(
            sc, static, conf, o1, d1, rng.fold(key, 13), VIS_REFRACTED,
            camera_level=False, indirect_scaled=False, is_refraction=True,
            rr=(0, 0, 1, 1), ray_lobe="refracted",
            base_fp=_tiled_fp(surf0, conf.nb_r),
            spread=_lobe_spread(conf, matv0, "refracted", conf.nb_r, surf0),
            trace_pack=tp1)
        c = vec3.kmean(vec3.where(ok, wgt, 0.0) * sub_rgb, conf.nb_r)
        aovs["refraction"] = c.aos()
        rgb = rgb + c
    sss_in = None
    if static.has_skin:
        sss_in = SSSIn(
            p=surf0.p.aos(), ns=surf0.ns.aos(), mesh_id=surf0.mesh_id,
            valid=surf0.valid, sss_weight=matv0.sss_weight,
            sss_dist=matv0.sss_dist.aos(), sss_color=matv0.sss_color.aos(),
            cavity_fadeout=matv0.cavity_fadeout,
            cubic=matv0.mtype == MAT_STANDARD, pix=ctx.pix, aa=ctx.aa,
            salt=ctx.salt)
    return rgb.aos(), aovs, sss_in


class TileRenderer:
    """Renders tiles of camera rays of one scene. `stats` counts the rays
    handed to each query (and the calls), and the shadow segments that
    marched (their steps are nearest queries). With `profile`, each call
    of the "tile" and "sss" stages is timed on the host clock between two
    synchronizations of the card (on a CUDA scene), into
    stats["t_<stage>"] (seconds) and stats["n_<stage>"] (calls)."""

    def __init__(self, scene: Scene, accel: tracemod.Accel, aa_samples: int,
                 rr_refr_start: int = 99, xres: int | None = None,
                 profile: bool = False):
        self.profile = profile
        self.static = SceneStatic.of(scene)
        self.stats = {"nearest_rays": 0, "nearest_calls": 0,
                      "shadow_rays": 0, "shadow_calls": 0,
                      "march_segments": 0, "tiles": 0}
        self.sc = DeviceScene(
            geometry=scene.geometry, materials=scene.materials,
            quad_lights=scene.quad_lights, disk_lights=scene.disk_lights,
            sky_radiance=(scene.sky.radiance if scene.sky.exists
                          else torch.zeros(3, device=scene.device)),
            textures=scene.textures, accel=accel, stats=self.stats,
        )
        o = scene.options
        self.conf = RenderConf(
            gi_diffuse_depth=o.gi_diffuse_depth,
            gi_glossy_depth=o.gi_glossy_depth,
            gi_refraction_depth=o.gi_refraction_depth,
            gi_total_depth=o.gi_total_depth,
            gi_sss_samples=o.gi_sss_samples,
            nb_d=self.static.nb_d, nb_g=self.static.nb_g,
            nb_r=(o.gi_refraction_samples ** 2
                  if o.gi_refraction_depth > 0 and self.static.has_refract
                  else 0),
            n_sub=aa_samples * aa_samples,
            # the render's width, not the camera's: a reduced render keeps
            # each pixel's footprint
            pix_spread=float(
                2.0 * math.tan(math.radians(scene.camera.fov_deg) * 0.5)
                / max(xres or scene.camera.xres, 1)),
            rr_refr_start=rr_refr_start,
        )

    def render_tile_at(self, rays: cameramod.CameraRays, start: int,
                       tile_rays: int, key):
        self.stats["tiles"] += 1
        sl = slice(start, start + tile_rays)
        rgb, aovs, sss_in = self._run(
            "tile", _tile, self.sc, self.static, self.conf, rays.origin[sl],
            rays.direction[sl], rays.pixel[sl], start, key)
        if self.static.has_skin and self.conf.gi_sss_samples > 0:
            from . import sss as sssmod

            c = self._run("sss", sssmod.sss_stage, self.sc, self.static,
                          self.conf, sss_in, rng.fold(key, 4))
            aovs["sss"] = c
            rgb = rgb + c
        return rgb, aovs

    def _run(self, name: str, fn, *args):
        if not self.profile:
            return fn(*args)
        _sync(self.sc.geometry.v0.device)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(self.sc.geometry.v0.device)
        dt = time.perf_counter() - t0
        self.stats[f"t_{name}"] = self.stats.get(f"t_{name}", 0.0) + dt
        self.stats[f"n_{name}"] = self.stats.get(f"n_{name}", 0) + 1
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pad_rays(rays: cameramod.CameraRays, pad: int) -> cameramod.CameraRays:
    """Pad so every tile is full; padding samples carry pixel -1 and are
    dropped by the splat."""
    if pad == 0:
        return rays
    z = torch.nn.functional.pad
    return cameramod.CameraRays(
        origin=z(rays.origin, (0, 0, 0, pad)),
        direction=z(rays.direction, (0, 0, 0, pad), value=1.0),
        pixel=z(rays.pixel, (0, pad), value=-1),
        sub_xy=z(rays.sub_xy, (0, 0, 0, pad)),
    )


def render(scene: Scene, accel: tracemod.Accel, *, seed: int = 0,
           tile_pixels: int = 16384, aa_samples: int | None = None,
           xres: int | None = None, yres: int | None = None,
           rr_refr_start: int = 99, profile: bool = False) -> dict:
    """Render the frame on the scene's device, where the accel must live
    too. `rr_refr_start` turns on Russian roulette on the refraction chain
    from that refraction depth (99 = off); `profile` times each stage call
    (`TileRenderer`). Returns {"RGBA": (H, W, 3), aov_name: (H, W, 3), ...,
    "__stats__": dict}, the planes as float32 tensors on the scene's
    device."""
    device = scene.device
    if accel.tree.bbox_min.device != device:
        raise ValueError(f"accel is on {accel.tree.bbox_min.device}, the "
                         f"scene on {device}")
    opts = scene.options
    aa = aa_samples or opts.aa_samples
    xres = xres or opts.xres
    yres = yres or opts.yres
    n_pix = xres * yres
    n_sub = aa * aa

    key = rng.stream(opts.aa_seed + seed)
    rays = cameramod.generate(scene.camera, rng.fold(key, 77), aa, xres, yres)
    tr = TileRenderer(scene, accel, aa, rr_refr_start, xres=xres,
                      profile=profile)

    n_rays = n_pix * n_sub
    tile_rays = min(tile_pixels * n_sub, n_rays)
    n_tiles = (n_rays + tile_rays - 1) // tile_rays
    rays = _pad_rays(rays, n_tiles * tile_rays - n_rays)

    image = wsum = names = None
    for ti in range(n_tiles):
        start = ti * tile_rays
        rgb, aovs = tr.render_tile_at(rays, start, tile_rays,
                                      rng.fold(key, 1000 + ti))
        vals, names = splatmod.pack_aovs(rgb, aovs)
        if image is None:
            image = torch.zeros((n_pix, vals.shape[1]), device=device)
            wsum = torch.zeros((n_pix,), device=device)
        sl = slice(start, start + tile_rays)
        splatmod.splat_accum(vals, rays.pixel[sl], rays.sub_xy[sl], image,
                             wsum, xres, yres, float(opts.filter_width))

    norm = torch.clamp_min(wsum, 1e-12)[:, None]
    planes = splatmod.unpack_aovs(image / norm, names)
    out = {name: p.reshape(yres, xres, 3) for name, p in planes.items()}
    out["__stats__"] = dict(tr.stats)
    return out


def render_progressive(scene: Scene, accel: tracemod.Accel, passes: int,
                       seed: int = 0, tile_pixels: int = 16384,
                       aa_samples: int | None = None, xres: int | None = None,
                       yres: int | None = None, flush_path: str | None = None,
                       verbose: bool = True, profile: bool = False) -> dict:
    """The mean of `passes` renders, pass p seeded `seed + 7919 p`: a
    running float64 sum per plane on the scene's device. After each pass
    the running mean of the beauty is written to `flush_path` (an EXR),
    so a long render always leaves a usable frame on disk; `verbose`
    prints each pass's seconds. Returns the planes as float32 numpy arrays
    and the `__stats__` of the last pass."""
    from ..io import exr as exrmod

    acc = stats = None
    for p in range(passes):
        t0 = time.perf_counter()
        out = render(scene, accel, seed=seed + p * 7919,
                     tile_pixels=tile_pixels, aa_samples=aa_samples,
                     xres=xres, yres=yres, profile=profile)
        stats = out.pop("__stats__")
        if acc is None:
            acc = {k: v.double() for k, v in out.items()}
        else:
            for k in acc:
                acc[k] += out[k]
        _sync(scene.device)
        dt = time.perf_counter() - t0
        if flush_path is not None:
            exrmod.write_rgb(flush_path, (acc["RGBA"] / (p + 1)).float()
                             .cpu().numpy())
        if verbose:
            print(f"[rls] pass {p + 1}/{passes} done in {dt:.4f}s",
                  flush=True)
    result = {k: (v / passes).float().cpu().numpy() for k, v in acc.items()}
    result["__stats__"] = stats
    return result
