"""Wavefront path-tracing integrator: the opaque path.

Counterpart of rlshaders_tpu/integrator/wavefront.py for opaque scenes.
Each ray generation is traced as one batch (`accel.trace`), shaded, and
lit by a light grid whose shadow rays are one more batch; BSDF-sampled
diffuse and glossy families continue the path, their emission pickups
tested by shadow rays, with the depth gates of the reference
(rlGgx.cpp:151-154) unrolled by Python recursion. The JAX version's jit
becomes eager torch.

Light transport, as in the JAX version:
* camera hit: direct light by MIS over the light grid (quad lights; the
  dome column is dropped when both BSDF families spawn) + diffuse/glossy
  families of GI_*_samples^2 rays with analytic light and dome pickup;
* secondary hits: direct light + depth-gated continuation families for
  `standard` (Arnold recursion), direct-only for rlGgx (its indirect is
  camera-only, rlGgx.cpp:307), and the one-sample BSDF pickup of lights
  for lobes whose depth is exhausted.

The defaults of the JAX knobs are constants here: MIS renormalization on,
both MIS count scales 1, faceforward by the shading normal, Owen-Sobol
streams at camera hits. Refraction, transparent shadows, Russian roulette,
SSS, Disney, textures and disk lights are later slices; `TileRenderer`
raises NotImplementedError on a scene that needs them.
"""
from __future__ import annotations

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
    MAT_STANDARD, Scene, VIS_CAMERA, VIS_DIFFUSE, VIS_GLOSSY,
    VIS_SHADOW,
)
from . import camera as cameramod
from . import lights as lightsmod
from . import splat as splatmod

RAY_EPS = 1e-3

# purpose ids of the per-(pixel, purpose) Sobol streams; light columns add
# their light index
P_QUAD = 101 << 8
P_SKY = 501 << 8
P_DIFFUSE = 601 << 8
P_GLOSSY = 602 << 8


class DeviceScene(NamedTuple):
    """The scene tables the shading stages read, all on one device, and
    the counts of rays handed to each query."""

    geometry: object       # scene.build.Geometry
    materials: object      # scene.build.Materials
    quad_lights: object    # scene.build.QuadLights
    sky_radiance: torch.Tensor  # (3,)
    accel: tracemod.Accel
    stats: dict


class SceneStatic(NamedTuple):
    """Per-scene facts the generation tree branches on (host values)."""

    quad_valid: tuple
    quad_samples: tuple
    quad_w_d: tuple        # per light: affect_diffuse * diffuse_weight
    quad_w_s: tuple
    sky_exists: bool
    sky_samples: int
    sky_w_d: float
    sky_w_s: float
    nb_d: int              # camera-level BSDF-strategy counts for MIS
    nb_g: int

    @staticmethod
    def of(scene: Scene) -> "SceneStatic":
        """Facts of `scene`; raises NotImplementedError on features of
        later slices."""
        mats = scene.materials
        if bool((mats.kt > 1e-5).any()):
            raise NotImplementedError("refraction (Kt > 0) is not ported yet")
        if bool((mats.opacity < 1.0 - 1e-5).any()):
            raise NotImplementedError(
                "transparent shadows (opacity < 1) are not ported yet")
        if bool((mats.sss_weight > 1e-5).any()):
            raise NotImplementedError(
                "subsurface scattering is not ported yet")
        ql, sky, o = scene.quad_lights, scene.sky, scene.options
        return SceneStatic(
            quad_valid=ql.valid,
            quad_samples=ql.samples,
            quad_w_d=tuple(float(a) * float(b) for a, b in
                           zip(ql.affect_diffuse, ql.diffuse_weight)),
            quad_w_s=tuple(float(a) * float(b) for a, b in
                           zip(ql.affect_specular, ql.specular_weight)),
            sky_exists=sky.exists,
            sky_samples=sky.samples,
            sky_w_d=float(sky.affect_diffuse),
            sky_w_s=float(sky.affect_specular),
            nb_d=(o.gi_diffuse_samples ** 2 if o.gi_diffuse_depth > 0 else 0),
            nb_g=(o.gi_glossy_samples ** 2 if o.gi_glossy_depth > 0 else 0),
        )


class RenderConf(NamedTuple):
    """Depth gates and sample splits from the options node."""

    gi_diffuse_depth: int
    gi_glossy_depth: int
    gi_total_depth: int
    nb_d: int
    nb_g: int
    n_sub: int  # AA samples per pixel (aa^2)


class Surface(NamedTuple):
    p: V3
    nf: V3       # shading normal, faced toward the incoming ray
    mat_id: torch.Tensor
    tri: torch.Tensor     # -1 on a miss
    entering: torch.Tensor
    valid: torch.Tensor


class SampleCtx(NamedTuple):
    """Sampler addressing of the camera-level lanes: flat pixel id and AA
    index per lane, and the render's salt. The Owen-Sobol draws key on
    (pixel, purpose, salt) and index on aa * count + k, so a pixel's whole
    budget of one integral is one jointly stratified sequence."""

    pix: torch.Tensor   # (N,) int32
    aa: torch.Tensor    # (N,) AA-sample index in [0, n_sub)
    salt: int           # uint32


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


def _nearest(sc: DeviceScene, o, d, vis_mask):
    sc.stats["nearest_rays"] += o.shape[0]
    sc.stats["nearest_calls"] += 1
    return tracemod.nearest(sc.accel, o, d, vis_mask=vis_mask)


def _occluded(sc: DeviceScene, o, d, tmax, ex) -> torch.Tensor:
    sc.stats["shadow_rays"] += o.shape[0]
    sc.stats["shadow_calls"] += 1
    return tracemod.occluded(sc.accel, o, d, tmax, vis_mask=VIS_SHADOW,
                             exclude_tri=ex)


def _shadow_transmission(sc: DeviceScene, sh) -> V3:
    """Shadow visibility (1 = visible) along the segments of `sh` = (o, d,
    t_max, exclude): one any-hit query, opaque scenes only."""
    vis = (~_occluded(sc, *sh)).to(torch.float32)
    return V3(vis, vis, vis)


def _surface(sc: DeviceScene, t, tri_in, uu, vv, o, d) -> Surface:
    g = sc.geometry
    tri = torch.clamp_min(tri_in, 0).long()
    valid = tri_in >= 0
    e1 = v3(g.e1[tri])
    e2 = v3(g.e2[tri])
    dv = v3(d)
    p = v3(o) + dv * t
    ng = vec3.normalize(vec3.cross(e1, e2))
    w = 1.0 - uu - vv
    ns = vec3.normalize(
        v3(g.n0[tri]) * w + v3(g.n1[tri]) * uu + v3(g.n2[tri]) * vv)
    entering = vec3.dot(ng, dv) < 0.0
    # faceforward the shading normal by its own side (ns.d): by the facet's
    # side it flips per facet across grazing zones of curved meshes
    sign = torch.where(vec3.dot(ns, dv) < 0.0, 1.0, -1.0)
    return Surface(
        p=p, nf=ns * sign, mat_id=g.mat_id[tri],
        tri=torch.where(valid, tri_in, -1), entering=entering, valid=valid,
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


def _light_pickup(sc, static, o: V3, d: V3, lobe_pdf, nb, camera_level,
                  lobe):
    """Analytic emission of the nearest quad light along BSDF rays, MIS
    weighted against the light strategy: (emission V3, t_light). The caller
    tests occlusion with a shadow segment to t_light: shadow-invisible
    geometry in front of a light must not kill the pickup."""
    out = _zeros3(lobe_pdf)
    t_light = torch.full_like(lobe_pdf, 1e30)
    ql = sc.quad_lights
    for li, valid in enumerate(static.quad_valid):
        if not valid:
            continue
        fac = static.quad_w_d[li] if lobe == "diffuse" else static.quad_w_s[li]
        if fac == 0.0:
            continue
        nl = float(static.quad_samples[li] ** 2) if camera_level else 1
        hit, t = lightsmod.intersect_quad_flat(ql.verts[li], ql.normal[li],
                                               o, d)
        cos_l = torch.abs(vec3.dot(d, _row(ql.normal[li])))
        p_l = (t * t) / torch.clamp_min(cos_l * ql.area[li], 1e-12)
        w = lightsmod.mis_weight(nb * lobe_pdf, nl * p_l)
        take = hit & (t < t_light)
        out = vec3.where(take, _row(ql.radiance[li]) * (fac * w), out)
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
        ql = sc.quad_lights
        for li, valid in enumerate(static.quad_valid):
            if not valid:
                continue
            fac = (static.quad_w_d[li] if lobe == "diffuse"
                   else static.quad_w_s[li])
            hq, tq = lightsmod.intersect_quad_flat(ql.verts[li],
                                                   ql.normal[li], pv, wi_w)
            cos_l = torch.abs(vec3.dot(wi_w, _row(ql.normal[li])))
            p_l = (tq * tq) / torch.clamp_min(cos_l * ql.area[li], 1e-12)
            w_b = lightsmod.mis_weight(1.0 * pdf, 1.0 * p_l)
            take = hq & (tq < t_light)
            emit = vec3.where(take, _row(ql.radiance[li]) * (fac * w_b), emit)
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


def _gen_shade_t(sc, static, conf, o, d, key, vis, camera_level,
                 trace_pack=None, ctx: SampleCtx | None = None,
                 ray_lobe="camera", rr=(0, 0, 0)):
    """Trace (unless `trace_pack` holds the hits) and shade one generation:
    surface, material, light grid with shadow rays, MIS direct light."""
    n = o.shape[0]
    if trace_pack is None:
        hit = _nearest(sc, o, d, vis)
        trace_pack = (hit.t, hit.tri, hit.u, hit.v)
    t, tri, uu, vv = trace_pack

    surf = _surface(sc, t, tri, uu, vv, o, d)
    matv = dispatch.gather(sc.materials, surf.mat_id, surf.entering,
                           diffuse_ray=(ray_lobe == "diffuse"))
    pv = surf.p
    nfv = surf.nf
    frame = build_frame_polar_v(nfv)
    wo = to_local_v(frame, -v3(d))
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
            rd, rg, rt = rr
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
            sc, (sh_o, grid.wi.aos(), sh_t, surf.tri.repeat(k)))
        shadowed = vec3.where(rcv, shadowed, 1.0)
        diffuse = vec3.ksum(contrib_d * shadowed, k)
        specular = vec3.ksum(contrib_s * shadowed, k)
    else:
        diffuse = _zeros3(pv.x)
        specular = _zeros3(pv.x)
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
    if any(static.quad_valid):
        # the BSDF-side light strategy is a shadow query to the light hit,
        # not the family ray's own geometry hit
        sh_t = torch.where(t_light < 1e30, t_light - 3 * RAY_EPS, 0.0)
        trans = _shadow_transmission(sc, (sh_o1, d1, sh_t, ex))
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
        trans_sky = _shadow_transmission(sc, (sh_o1, d1, sky_t, ex))
        sky_vis = vec3.where(miss, 1.0, vec3.where(maybe, trans_sky, 0.0))
    else:
        one = torch.ones_like(pdf1)
        sky_vis = V3(one, one, one)
    pick = pick + _sky_pickup(sc, static, vec3.tile(nfv, nb), dV, sky_vis,
                              pdf1, nb, lobe, full_weight=sky_full)
    return o1, d1, w1, pick, (hit.t, hit.tri, hit.u, hit.v)


def _lobe_family_full(sc, static, conf, surf, pv, nfv, matv, frame, wo, key,
                      lobe, nb, rr, cam_pickup=False,
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
        camera_level=False, rr=rr, ray_lobe=lobe, trace_pack=tp1)
    if cam_pickup:
        sub = pick + sub_rgb
    else:
        is_std = (matv.mtype == MAT_STANDARD).repeat(nb)
        sub = pick + vec3.where(is_std, sub_rgb, 0.0)
    return vec3.kmean(w1 * sub, nb)


def _secondary_indirect_t(sc, static, conf, surf, pv, nfv, matv, frame, wo,
                          key, ray_lobe, rr) -> V3:
    """Indirect + BSDF-sampled direct light at a secondary hit under the GI
    depth gates; lobes whose depth is exhausted keep the one-sample light
    pickup."""
    rd, rg, rt = rr
    out = _zeros3(pv.x)
    fallback = []
    # no glossy continuation from diffuse rays (standard's glossy caustics
    # are off)
    if (ray_lobe != "diffuse" and rg < conf.gi_glossy_depth
            and rt < conf.gi_total_depth):
        out = out + _lobe_family_full(
            sc, static, conf, surf, pv, nfv, matv, frame, wo,
            rng.fold(key, 62), "specular", 1, (rd, rg + 1, rt + 1))
    else:
        fallback.append("specular")
    if rd < conf.gi_diffuse_depth and rt < conf.gi_total_depth:
        out = out + _lobe_family_full(
            sc, static, conf, surf, pv, nfv, matv, frame, wo,
            rng.fold(key, 61), "diffuse", 1, (rd + 1, rg, rt + 1))
    else:
        fallback.append("diffuse")
    if fallback and any(static.quad_valid):
        out = out + _spec_direct_t(sc, static, surf, pv, matv, frame, wo,
                                   key, tuple(fallback))
    return out


def _shade_generation_t(sc, static, conf, o, d, key, vis, camera_level,
                        rr=(0, 0, 0), ray_lobe="camera", trace_pack=None,
                        ctx: SampleCtx | None = None):
    """Trace + fully shade one ray generation; returns (surface pack, rgb,
    aov_d, aov_s). `rr` = (diffuse, glossy, total) depths at this hit."""
    surf, matv, pv, nfv, frame, wo, rgb, aov_d, aov_s = _gen_shade_t(
        sc, static, conf, o, d, key, vis, camera_level, trace_pack, ctx=ctx,
        ray_lobe=ray_lobe, rr=rr)
    if not camera_level:
        rgb = rgb + _secondary_indirect_t(
            sc, static, conf, surf, pv, nfv, matv, frame, wo, key, ray_lobe,
            rr)
    return (surf, matv, pv, nfv, frame, wo), rgb, aov_d, aov_s


def _tile(sc, static, conf, origin, direction, pixel, start, key):
    """The whole generation tree of one tile of camera rays; returns (rgb
    (N, 3), aovs {name: (N, 3)})."""
    n0 = origin.shape[0]
    lane = start + torch.arange(n0, dtype=torch.int32, device=origin.device)
    ctx = SampleCtx(pix=pixel, aa=lane % conf.n_sub,
                    salt=rng.bits_scalar(rng.fold(key, 3141)))
    pack, rgb, aov_dd, aov_ds = _shade_generation_t(
        sc, static, conf, origin, direction, rng.fold(key, 0), VIS_CAMERA,
        camera_level=True, rr=(99, 99, 99), ray_lobe="camera", ctx=ctx)
    surf0, matv0, pv0, nfv0, frame0, wo0 = pack
    if static.sky_exists:
        rgb = rgb + vec3.where(
            ~surf0.valid, _row(sc.sky_radiance) * torch.ones_like(rgb.x), 0.0)
    zero = torch.zeros((n0, 3), device=origin.device)
    aovs = {"direct_diffuse": aov_dd.aos(), "direct_specular": aov_ds.aos(),
            "indirect_diffuse": zero, "indirect_specular": zero,
            "refraction": zero, "sss": zero}
    for nb, lobe, aov, fold_id, rr in (
            (conf.nb_d, "diffuse", "indirect_diffuse", 1, (1, 0, 1)),
            (conf.nb_g, "specular", "indirect_specular", 2, (0, 1, 1))):
        if nb:
            c = _lobe_family_full(
                sc, static, conf, surf0, pv0, nfv0, matv0, frame0, wo0,
                rng.fold(key, fold_id), lobe, nb, rr, cam_pickup=True,
                ctx=ctx)
            aovs[aov] = c.aos()
            rgb = rgb + c
    return rgb.aos(), aovs


class TileRenderer:
    """Renders tiles of camera rays of one scene. `stats` counts the rays
    handed to each query (and the calls)."""

    def __init__(self, scene: Scene, accel: tracemod.Accel, aa_samples: int):
        dispatch.check_supported(scene.materials)
        self.static = SceneStatic.of(scene)
        self.stats = {"nearest_rays": 0, "nearest_calls": 0,
                      "shadow_rays": 0, "shadow_calls": 0, "tiles": 0}
        self.sc = DeviceScene(
            geometry=scene.geometry, materials=scene.materials,
            quad_lights=scene.quad_lights,
            sky_radiance=(scene.sky.radiance if scene.sky.exists
                          else torch.zeros(3, device=scene.device)),
            accel=accel, stats=self.stats,
        )
        o = scene.options
        self.conf = RenderConf(
            gi_diffuse_depth=o.gi_diffuse_depth,
            gi_glossy_depth=o.gi_glossy_depth,
            gi_total_depth=o.gi_total_depth,
            nb_d=self.static.nb_d, nb_g=self.static.nb_g,
            n_sub=aa_samples * aa_samples,
        )

    def render_tile_at(self, rays: cameramod.CameraRays, start: int,
                       tile_rays: int, key):
        self.stats["tiles"] += 1
        sl = slice(start, start + tile_rays)
        return _tile(self.sc, self.static, self.conf, rays.origin[sl],
                     rays.direction[sl], rays.pixel[sl], start, key)


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


def render(scene: Scene, accel: tracemod.Accel, *, device, seed: int = 0,
           tile_pixels: int = 16384, aa_samples: int | None = None,
           xres: int | None = None, yres: int | None = None) -> dict:
    """Render the frame on `device`, where the scene and accel must live.
    Returns {"RGBA": (H, W, 3), aov_name: (H, W, 3), ..., "__stats__":
    dict}, the planes as float32 tensors on `device`."""
    device = torch.device(device)
    for name, t in (("scene", scene.geometry.v0),
                    ("accel", accel.tree.bbox_min)):
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, render asked for "
                             f"{device}")
    opts = scene.options
    aa = aa_samples or opts.aa_samples
    xres = xres or opts.xres
    yres = yres or opts.yres
    n_pix = xres * yres
    n_sub = aa * aa

    key = rng.stream(opts.aa_seed + seed)
    rays = cameramod.generate(scene.camera, rng.fold(key, 77), aa, xres, yres)
    tr = TileRenderer(scene, accel, aa)

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
