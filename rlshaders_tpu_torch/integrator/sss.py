"""BSSRDF probe-ray subsurface scattering: rlSkin's SSS integral and the
`standard` shader's Ksss lobe.

Counterpart of rlshaders_tpu/integrator/sss.py (the reference's SssSampler,
src/rlSss.h:100-554), on (..., 3) rows as the JAX version writes it:

1. per hit on a subsurface material, GI_sss_samples^2 probe rays: the axis
   N/U/V picked with probability 0.5/0.25/0.25, the entry offset on a disk
   at a radius drawn from the normalized-diffusion inverse CDF, the segment
   length 2*sqrt(rmax^2 - r^2) (rlSss.h:487-533);
2. each probe segment marched through K_PROBE nearest queries
   (kMaxProbeDepth, rlSss.h:105), shading only same-mesh hits within the
   profile radius and ending at the first hit on another mesh;
3. every accepted hit shaded: Lambert direct light x R(r) with the optional
   cavity fade sqrt((1 + cos)/2) (rlSss.h:401-413), plus one cosine bounce
   x R(r)/pi (rlSss.h:456-483) whose hit shades with the unlayered albedo
   sss_color * sss_weight;
4. the 3-axis MIS pdf (rlSss.h:251-263) and the mean over the probes.

The JAX version's fused program becomes eager torch ops; its fori_loop over
the march is a Python loop. Every query goes through the wavefront's
`_nearest` / `_occluded`, which count the rays.
"""
from __future__ import annotations

import math
import torch

from ..bsdf import sss_profiles as sp
from ..core import rng
from ..core.frame import build_frame_polar, to_world
from ..core.vecmath import cosine_sample_hemisphere, dot, normalize
from ..scene.build import MAT_STANDARD
from . import lights as lightsmod
from . import wavefront as wf

K_PROBE = 12  # probe chain length (kMaxProbeDepth = 12, rlSss.h:105)
RAY_EPS = wf.RAY_EPS
# Fitted, not derived: the JAX package calibrated this exitance factor of
# Arnold 4's raytraced standard-shader SSS on the cubic falloff against one
# golden image (testsuite case 0004's logo disc). Kept as it is for parity.
STD_SSS_ENERGY = 0.567
P_SSS = 604 << 8  # purpose of the probe-disk Owen-Sobol stream
M32 = 0xFFFFFFFF


def _probe_rays(profile: sp.NDProfile, frame, p, u1, u2):
    """Probe segments (origin, direction, length, radius) as rlSss.h:487-533
    builds them."""
    idx = torch.where(u1 < 0.5, 0, torch.where(u1 < 0.75, 2, 3))
    rx = torch.where(
        u1 < 0.5,
        u1 / 0.5,
        torch.where(u1 < 0.75, (u1 - 0.5) / 0.25, (u1 - 0.75) / 0.25),
    )
    r = sp.nd_sample_radius(profile, rx)
    rmax = profile.max_radius
    phi = 2.0 * math.pi * u2
    off_x = torch.cos(phi) * r
    off_z = torch.sin(phi) * r
    off_y = torch.sqrt(torch.clamp_min(rmax * rmax - r * r, 0.0))
    maxdist = off_y * 2.0

    un, vn, nn = frame.u, frame.v, frame.n
    ox, oy, oz = off_x[..., None], off_y[..., None], off_z[..., None]
    # axis N: direction -N, offset in (U, N, V)
    o_n = ox * un + oy * nn + oz * vn
    # axis U: direction +U, offset in (V, -U, N)
    o_u = ox * vn - oy * un + oz * nn
    # axis V: direction +V, offset in (N, -V, U)
    o_v = ox * nn - oy * vn + oz * un

    is_n = (idx < 2)[..., None]
    is_u = (idx == 2)[..., None]
    off = torch.where(is_n, o_n, torch.where(is_u, o_u, o_v))
    dirs = torch.where(is_n, -nn, torch.where(is_u, un, vn))
    return p + off, dirs, maxdist, r


def _columns(sizes, value, device) -> torch.Tensor:
    """Per-column constants: value(s) repeated s times for each s."""
    return torch.cat([torch.full((s,), value(s), dtype=torch.float32,
                                 device=device) for s in sizes])


def _lambert_direct(sc, static, surf_p, surf_n, exclude_tri, key, sq=None,
                    cam_budget=False) -> torch.Tensor:
    """Lambert irradiance-reflectance at probe hits, (N, 3): per-light area
    samples MIS-combined with one cosine-hemisphere sample (the two
    strategies of the reference's light loop, rlSss.h:439-454). Its shadow
    tests are any-hit queries, also in transparent scenes.

    cam_budget draws each light's camera-level budget (samples^2 area
    samples) instead of one. sq = (pix, sidx, salt, purpose_base) switches
    the draws to the per-pixel Owen-Sobol streams: lane i's draw for slot s
    comes from stream (pix[i], purpose) at index sidx[i]."""
    n = surf_p.shape[0]
    dev = surf_p.device
    out = torch.zeros((n, 3), device=dev)

    def draw(slot, k):
        """(n, k, 1, 2) sample pairs for k light columns."""
        if sq is None:
            return rng.uniform2(rng.fold(key, slot), (n, k, 1), dev)
        pix, sidx, salt, pb = sq
        col = torch.arange(k, dtype=torch.int64, device=dev)
        purpose = ((pb * 0x1003) & M32) ^ ((slot * 0x10007 + col) & M32)
        return rng.sobol2_at(pix, sidx, purpose, salt).reshape(n, k, 1, 2)

    dirs, dists, rads, pdfs, sizes = [], [], [], [], []

    def columns(valid, samples, w_d):
        """The lights of one kind that light diffuse: {light: its MIS
        sample count}."""
        return {li: (max(samples[li], 1) ** 2 if cam_budget else 1)
                for li, v in enumerate(valid) if v and w_d[li] != 0.0}

    def add(ls, k):
        dirs.append(ls.direction.reshape(n, k, 3))
        dists.append(ls.dist.reshape(n, k))
        rads.append(ls.radiance.reshape(n, k, 3))
        pdfs.append(ls.pdf.reshape(n, k))

    ql, dl = sc.quad_lights, sc.disk_lights
    quad_nl = columns(static.quad_valid, static.quad_samples,
                      static.quad_w_d)
    disk_nl = columns(static.disk_valid, static.disk_samples,
                      static.disk_w_d)
    for slot, nls, w_d, table, radiance, sampler in (
            (11, quad_nl, static.quad_w_d, (ql.verts, ql.normal, ql.area),
             ql.radiance, lightsmod.sample_quads_batched),
            (12, disk_nl, static.disk_w_d,
             (dl.center, dl.u, dl.v, dl.normal, dl.area), dl.radiance,
             lightsmod.sample_disks_batched)):
        if not nls:
            continue
        reps = list(nls.values())
        k = sum(reps)
        u = draw(slot, k)

        def per_col(t):
            return torch.cat([t[li:li + 1].expand((s,) + t.shape[1:])
                              for li, s in nls.items()])

        rad = torch.cat([(radiance[li] * w_d[li])[None].expand(s, 3)
                         for li, s in nls.items()])
        add(sampler(*(per_col(t) for t in table), rad, surf_p, u), k)
        sizes += reps
    sky = static.sky_exists and static.sky_w_d != 0.0
    if sky:
        ls = lightsmod.sample_sky_batched(sc.sky_radiance * static.sky_w_d,
                                          surf_n, draw(13, 1))
        add(ls, 1)
        sizes.append(1)
    if not dirs:
        return out

    wi = torch.cat(dirs, dim=1)
    dist = torch.cat(dists, dim=1)
    rad = torch.cat(rads, dim=1)
    pdf_l = torch.cat(pdfs, dim=1)
    k = wi.shape[1]
    col_w = _columns(sizes, lambda s: 1.0 / s, dev)[None, :]
    col_nl = _columns(sizes, float, dev)[None, :]

    cos_i = torch.clamp_min(dot(wi, surf_n[:, None, :]), 0.0)
    f_cos = cos_i / math.pi
    p_cos = cos_i / math.pi  # the cosine strategy's pdf at the light samples
    w_l = (col_nl * pdf_l) / torch.clamp_min(col_nl * pdf_l + p_cos,
                                             1e-12) * col_w

    # origins offset along the normal and the ray, and a 3 * RAY_EPS margin
    # at the light, as the light grid's shadow rays (wavefront._gen_shade_t)
    p_off = surf_p + surf_n * RAY_EPS
    p_flat = torch.broadcast_to(p_off[:, None, :], (n, k, 3)).reshape(-1, 3)
    ex_flat = torch.broadcast_to(exclude_tri[:, None], (n, k)).reshape(-1)
    shadowed = wf._occluded(
        sc, p_flat + wi.reshape(-1, 3) * RAY_EPS, wi.reshape(-1, 3),
        dist.reshape(-1) - 3 * RAY_EPS, ex_flat).reshape(n, k)

    inv_pdf = torch.where(pdf_l > 0, 1.0 / torch.clamp_min(pdf_l, 1e-12), 0.0)
    unshadowed = (~shadowed).to(torch.float32)
    out = torch.sum(rad * (f_cos * w_l * inv_pdf * unshadowed)[..., None],
                    dim=1)

    # the cosine strategy: one sample; area-light emission picked up
    # analytically with the complementary MIS weight
    ub = draw(77, 1)[:, 0, 0]
    local = cosine_sample_hemisphere(ub[..., 0], ub[..., 1])
    bdir = to_world(build_frame_polar(surf_n), local)
    p_b = torch.clamp_min(local[..., 2], 0.0) / math.pi

    emit = torch.zeros((n, 3), device=dev)
    hit_t = torch.full((n,), 1e30, device=dev)
    for li, nl in quad_nl.items():
        hq, tq = lightsmod.intersect_quad(ql.verts[li], ql.normal[li],
                                          surf_p, bdir)
        pl_q = lightsmod.pdf_quad(ql.verts[li], ql.normal[li], ql.area[li],
                                  surf_p, bdir, tq)
        w_b = p_b / torch.clamp_min(p_b + float(nl) * pl_q, 1e-12)
        take = hq & (tq < hit_t)
        emit = torch.where(
            take[..., None],
            ql.radiance[li] * (static.quad_w_d[li] * w_b)[..., None], emit)
        hit_t = torch.where(take, tq, hit_t)
    for li, nl in disk_nl.items():
        hq, tq = lightsmod.intersect_disk(dl.center[li], dl.u[li], dl.v[li],
                                          dl.normal[li], surf_p, bdir)
        cos_l = torch.abs(torch.sum(-bdir * dl.normal[li], -1))
        pl_q = (tq * tq) / torch.clamp_min(cos_l * dl.area[li], 1e-12)
        w_b = p_b / torch.clamp_min(p_b + float(nl) * pl_q, 1e-12)
        take = hq & (tq < hit_t)
        emit = torch.where(
            take[..., None],
            dl.radiance[li] * (static.disk_w_d[li] * w_b)[..., None], emit)
        hit_t = torch.where(take, tq, hit_t)

    any_emit = hit_t < 1e30
    b_shadow = wf._occluded(
        sc, p_off + bdir * RAY_EPS, bdir,
        torch.where(any_emit, hit_t, 0.0) - 3 * RAY_EPS, exclude_tri)
    # f / p for a cosine sample of Lambert is exactly 1
    out = out + torch.where((any_emit & ~b_shadow)[..., None], emit, 0.0)
    if sky:
        # the dome seen by the cosine sample (MIS against the dome's cosine
        # sampler: equal pdfs, weight 1/2)
        sky_vis = ~wf._occluded(
            sc, p_off + bdir * RAY_EPS, bdir,
            torch.full((n,), 1e12, device=dev), exclude_tri) & ~any_emit
        out = out + torch.where(sky_vis[..., None],
                                sc.sky_radiance * (0.5 * static.sky_w_d), 0.0)
    return out


def _interp_normal(g, tri, hit):
    w = 1.0 - hit.u - hit.v
    return normalize(w[..., None] * g.n0[tri] + hit.u[..., None] * g.n1[tri]
                     + hit.v[..., None] * g.n2[tri])


def _j_sss(sc, static, surf_p, surf_ns, surf_mesh, is_sss, sss_dist,
           sss_color, sss_weight, cavity_flag, cubic_flag, key, pix=None,
           aa=None, salt=None, *, n_sss, gi_diffuse, k_probe,
           use_sobol=False, cam_budget=False) -> torch.Tensor:
    """The probe march of N0 hits: (N0, 3) SSS radiance, zero on the lanes
    that are not `is_sss`."""
    dev = surf_p.device
    n0 = surf_p.shape[0]
    # Arnold 4's cubic falloff on `standard` Ksss lanes, Burley on rlSkin
    profile0 = sp.make_nd_profile(sss_dist, cubic_flag)
    # the probe frame: smooth normal up (rlSss.h:147-158)
    frame0 = build_frame_polar(surf_ns)

    # the (N0, S) probe batch, lane-major
    s_total = n_sss

    def rep(a):
        return a.repeat_interleave(s_total, dim=0)

    prof_f = sp.NDProfile(*(rep(a) for a in profile0))
    frame_f = type(frame0)(*(rep(a) for a in frame0))
    p_f = rep(surf_p)
    ns_f = rep(surf_ns)
    mesh_f = rep(surf_mesh)
    skin_f = rep(is_sss)
    cav_f = rep(cavity_flag)
    nf_total = n0 * s_total

    if use_sobol:
        # per-pixel jointly stratified disk samples, keyed on (pixel, aa):
        # the same draws whichever lanes the batch holds
        u = rng.sobol2_rep(pix, aa, s_total, P_SSS, salt)
        # lane i*S + c draws the light samples of pixel pix[i] at index
        # aa[i]*S + c: the pixel's whole (AA x S) probe budget shares each
        # (pixel, step, slot) stream
        pix_f = rep(pix)
        sidx_f = (rep(aa).to(torch.int64) * s_total + torch.arange(
            nf_total, dtype=torch.int64, device=dev) % s_total) & M32
    else:
        u = rng.stratified2(rng.fold(key, 1), (n0,), int(n_sss ** 0.5),
                            dev).reshape(nf_total, 2)
    o_probe, d_probe, maxdist, _ = _probe_rays(prof_f, frame_f, p_f,
                                               u[:, 0], u[:, 1])

    def sq_of(base, k_step):
        if not use_sobol:
            return None
        return (pix_f, sidx_f, salt, (base + k_step) & M32)

    def key_of(slot):
        return None if use_sobol else rng.fold(key, slot)

    g = sc.geometry
    mats = sc.materials
    accum = torch.zeros((nf_total, 3), device=dev)
    origin = o_probe
    remaining = maxdist
    exclude = torch.full((nf_total,), -1, dtype=torch.int32, device=dev)
    for k_step in range(k_probe):
        hit = wf._nearest(sc, origin + d_probe * RAY_EPS, d_probe, 0xFF,
                          exclude=exclude)
        seg_ok = skin_f & (hit.tri >= 0) & (hit.t < remaining)
        tri = torch.clamp_min(hit.tri, 0).long()
        hp = origin + d_probe * (hit.t[..., None] + RAY_EPS)
        hn = _interp_normal(g, tri, hit)
        same_mesh = g.mesh_id[tri] == mesh_f

        disp = hp - p_f
        r_hit = torch.sqrt(torch.clamp_min(dot(disp, disp), 1e-20))
        within = r_hit <= prof_f.max_radius
        shade_ok = seg_ok & same_mesh & within
        shade_tri = torch.where(shade_ok, hit.tri, -1)

        # the hit normal aligned with the geometric reference (rlSss.h:
        # 393-399)
        hn = torch.where(dot(hn, g.n0[tri])[..., None] < 0.0, -hn, hn)

        # the cavity fade (rlSss.h:401-413)
        disp_dir = disp / r_hit[..., None]
        cos_cav_out = torch.abs(dot(hn, ns_f))
        cos_cav_in = torch.clamp(dot(hn, ns_f), -1.0, 1.0)
        inward = dot(ns_f, disp_dir) < 0.0
        cos_cav = torch.where(inward, cos_cav_out, cos_cav_in)
        fade = torch.sqrt(torch.clamp((1.0 + cos_cav) * 0.5, 0.0, 1.0))
        cavity = torch.where(cav_f, fade, 1.0)

        # direct Lambert at the probe hit (the camera-level light budget at
        # camera hits; the bounce below keeps one sample)
        direct = _lambert_direct(sc, static, hp, hn, shade_tri,
                                 key_of(100 + k_step), sq=sq_of(100, k_step),
                                 cam_budget=cam_budget)

        # one cosine-sampled indirect bounce (rlSss.h:456-483)
        if gi_diffuse > 0:
            if use_sobol:
                ub = rng.sobol2_at(pix_f, sidx_f, 200 + k_step, salt)
            else:
                ub = rng.uniform2(rng.fold(key, 200 + k_step),
                                  (nf_total, 1), dev)[:, 0]
            local = cosine_sample_hemisphere(ub[..., 0], ub[..., 1])
            bdir = to_world(build_frame_polar(hn), local)
            bhit = wf._nearest(sc, hp + bdir * RAY_EPS, bdir, 0xFF,
                               exclude=shade_tri)
            btri = torch.clamp_min(bhit.tri, 0).long()
            bp = hp + bdir * bhit.t[..., None]
            bn = _interp_normal(g, btri, bhit)
            bn = torch.where(dot(bn, -bdir)[..., None] < 0.0, -bn, bn)
            b_direct = _lambert_direct(
                sc, static, bp, bn, torch.where(bhit.tri >= 0, bhit.tri, -1),
                key_of(300 + k_step), sq=sq_of(300, k_step))
            # the bounce hit shades with the unlayered albedo
            bmat = g.mat_id[btri].long()
            b_albedo = mats.sss_color[bmat] * mats.sss_weight[bmat][..., None]
            # cos / pdf = 1: the estimator is the incoming light itself
            indirect = torch.where((bhit.tri >= 0)[..., None],
                                   b_direct * b_albedo, 0.0)
        else:
            indirect = torch.zeros((nf_total, 3), device=dev)

        r_prof = sp.nd_eval(prof_f, r_hit)
        irr = (direct + indirect) * r_prof * cavity[..., None]

        # the 3-axis MIS pdf (rlSss.h:251-263)
        off_u = dot(disp, frame_f.u)
        off_v = dot(disp, frame_f.v)
        off_n = dot(disp, frame_f.n)
        rr_u = torch.sqrt(torch.clamp_min(off_v * off_v + off_n * off_n,
                                          1e-20))
        rr_v = torch.sqrt(torch.clamp_min(off_u * off_u + off_n * off_n,
                                          1e-20))
        rr_n = torch.sqrt(torch.clamp_min(off_u * off_u + off_v * off_v,
                                          1e-20))
        pdf = (sp.nd_pdf(prof_f, rr_u) * torch.abs(dot(frame_f.u, hn)) * 0.25
               + sp.nd_pdf(prof_f, rr_v) * torch.abs(dot(frame_f.v, hn))
               * 0.25
               + sp.nd_pdf(prof_f, rr_n) * torch.abs(dot(frame_f.n, hn))
               * 0.5)
        contrib = irr / torch.clamp_min(pdf, 1e-9)[..., None]
        accum = accum + torch.where(shade_ok[..., None], contrib, 0.0)

        # march past this hit. A hit on another mesh ends the probe: the
        # reference `continue`s without re-arming the ray (rlSss.h:298-314),
        # so its probe returns that hit until the trial budget is spent.
        foreign = seg_ok & ~same_mesh
        step = torch.where(seg_ok, hit.t + 2 * RAY_EPS, remaining)
        origin = origin + d_probe * step[..., None]
        remaining = torch.where(foreign, 0.0, remaining - step)
        exclude = torch.where(seg_ok, hit.tri, -1)

    sss = accum.reshape(n0, s_total, 3).mean(dim=1)
    albedo = sss_color * sss_weight[..., None]
    # rlSkin keeps the reference's Burley estimator (mass 0.7117); the
    # `standard` lanes take the fitted STD_SSS_ENERGY on the cubic falloff
    albedo = albedo * torch.where(cubic_flag, STD_SSS_ENERGY, 1.0)[..., None]
    return torch.where(is_sss[..., None], sss * albedo, 0.0)


def sss_eval(sc, static, fields, key, n_sss, gi_diffuse, k_probe=K_PROBE):
    """The SSS of secondary hits (rlSkin on refracted rays): threefry draws
    by flat lane index, so it runs on every lane of its generation, as the
    JAX version does; compacting it would change every draw. `fields` =
    (p, ns, mesh_id, is_sss, sss_dist, sss_color, sss_weight,
    cavity_fadeout, cubic), rows."""
    s = max(int(math.sqrt(n_sss)) ** 2, 1)
    return _j_sss(sc, static, *fields, key, n_sss=s,
                  gi_diffuse=int(gi_diffuse), k_probe=k_probe)


def sss_stage(sc, static, conf, sss_in: wf.SSSIn, key,
              k_probe=K_PROBE) -> torch.Tensor:
    """The SSS radiance of a tile's camera hits on subsurface materials,
    (N, 3), zero elsewhere: conf.gi_sss_samples^2 probes a hit.

    The probe batch holds exactly the SSS lanes: its Owen-Sobol draws key
    on (pixel, aa), so they do not depend on which lanes it holds. A tile
    with no SSS lane returns zeros and launches nothing."""
    n0 = sss_in.p.shape[0]
    s = max(conf.gi_sss_samples, 1) ** 2
    is_sss = (sss_in.sss_weight > 1e-5) & sss_in.valid
    out = torch.zeros((n0, 3), device=sss_in.p.device)
    idx = torch.nonzero(is_sss).reshape(-1)
    if idx.numel() == 0:
        return out
    fields = [a[idx] for a in (
        sss_in.p, sss_in.ns, sss_in.mesh_id, is_sss, sss_in.sss_dist,
        sss_in.sss_color, sss_in.sss_weight, sss_in.cavity_fadeout,
        sss_in.cubic)]
    res = _j_sss(sc, static, *fields, key, sss_in.pix[idx], sss_in.aa[idx],
                 sss_in.salt, n_sss=s, gi_diffuse=conf.gi_diffuse_depth,
                 k_probe=k_probe, use_sobol=True, cam_budget=True)
    return out.index_copy(0, idx, res)


def sss_fields(surf, matv, is_sss):
    """The rows `sss_eval` reads, from a generation's surface and its
    (layered) material view."""
    return (surf.p.aos(), surf.ns.aos(), surf.mesh_id, is_sss,
            matv.sss_dist.aos(), matv.sss_color.aos(), matv.sss_weight,
            matv.cavity_fadeout, matv.mtype == MAT_STANDARD)
