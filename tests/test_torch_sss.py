"""The SSS slice's modules against the JAX package on the CPU, on inputs
made with numpy: the diffusion profiles, the probe rays, rlSkin's layering
and lobes, the samplers, the row-form light samplers, the probe-hit
lighting and a 2-step probe march.

Tolerances (measured, torch 2.13 CPU vs jax 0.9 CPU): the refraction
slice's RTOL 2e-5 / ATOL 2e-6 for well-conditioned outputs, where XLA's and
torch's transcendentals and fusion differ in the last bits. Outputs that
pass through the VNDF sampler (the Fresnel quadrature of rlSkin's layering,
sampled directions) are ill-conditioned on a few lanes: all within 1e-3
relative / 1e-4 absolute and 99% within RTOL/ATOL (measured: 6 of 4,096
quadrature lanes beyond RTOL/ATOL, at most 1.5e-4 relative). The samplers
are bit for bit. Where a measured figure is smaller, the test says so.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.bsdf import ggx as jggx
from rlshaders_tpu.bsdf import sss_profiles as jsp
from rlshaders_tpu.core import frame as jframe
from rlshaders_tpu.core import rng as jrng
from rlshaders_tpu.core import vec3 as jvec3
from rlshaders_tpu.core import vecmath as jvm
from rlshaders_tpu.integrator import lights as jlights
from rlshaders_tpu.integrator import sss as jsss
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.models import dispatch as jdispatch
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.bsdf import ggx as tggx
from rlshaders_tpu_torch.bsdf import sss_profiles as tsp
from rlshaders_tpu_torch.core import frame as tframe
from rlshaders_tpu_torch.core import rng as trng
from rlshaders_tpu_torch.core import vec3 as tvec3
from rlshaders_tpu_torch.core import vecmath as tvm
from rlshaders_tpu_torch.integrator import lights as tlights
from rlshaders_tpu_torch.integrator import sss as tsss
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.models import dispatch as tdispatch
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()

SKIN = "scenes/skin_closeup.ass"
N = 4096
RTOL = 2e-5
ATOL = 2e-6
LOOSE_RTOL = 1e-3
LOOSE_ATOL = 1e-4
TIGHT_SHARE = 0.99


def _np(x):
    if isinstance(x, tvec3.V3):
        return x.aos().numpy()
    if isinstance(x, jvec3.V3):
        return np.asarray(x.aos())
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


def close_conditioned(t, j):
    a, b = _np(t), _np(j)
    np.testing.assert_allclose(a, b, rtol=LOOSE_RTOL, atol=LOOSE_ATOL)
    tight = np.abs(a - b) <= ATOL + RTOL * np.abs(b)
    assert tight.mean() >= TIGHT_SHARE, tight.mean()


def _dirs(rs, n=N, z_sign=1.0):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = z_sign * np.abs(d[:, 2])
    return d


# ---------------------------------------------------------------------------
# the diffusion profiles
# ---------------------------------------------------------------------------


def _profile_inputs(seed):
    """Scatter distances with zero channels and all-zero lanes (d = 0),
    Burley and cubic lanes, and radii down to 0."""
    rs = np.random.default_rng(seed)
    dist = rs.uniform(0.01, 1.0, (N, 3)).astype(np.float32)
    dist[rs.random((N, 3)) < 0.05] = 0.0
    dist[:64] = 0.0
    cubic = rs.random(N) < 0.5
    rx = rs.random(N).astype(np.float32)
    r = (rs.random(N) * 3.0 * dist.max(1)).astype(np.float32)
    r[64:128] = 0.0
    r[128:192] = 1e-9
    r[192:256] = 5e-8
    return dist, cubic, rx, r


@pytest.mark.parametrize("cubic_share", [0.0, 1.0, 0.5])
def test_profiles_match_jax(cubic_share):
    dist, cubic, rx, r = _profile_inputs(1)
    cubic = np.random.default_rng(2).random(N) < cubic_share
    jp = jsp.make_nd_profile(jnp.asarray(dist), jnp.asarray(cubic))
    tp = tsp.make_nd_profile(torch.tensor(dist), torch.tensor(cubic))
    for a, b in zip(tp, jp):
        close(a, b)
    close(tsp.nd_sample_radius(tp, torch.tensor(rx)),
          jsp.nd_sample_radius(jp, jnp.asarray(rx)))
    close(tsp.nd_pdf(tp, torch.tensor(r)), jsp.nd_pdf(jp, jnp.asarray(r)))
    close(tsp.nd_eval(tp, torch.tensor(r)), jsp.nd_eval(jp, jnp.asarray(r)))
    # the degenerate lanes take the same branch: d = 0 samples radius 0 and
    # evaluates to 0 (max_radius 0), r -> 0 evaluates to 1
    assert (tsp.nd_sample_radius(tp, torch.tensor(rx))[:64] == 0).all()
    ev = tsp.nd_eval(tp, torch.tensor(r)).numpy()
    assert (ev[:64] == 0).all()
    assert (ev[64:256][dist[64:256].min(1) > 0] == 1.0).all()


def test_select_dist_lobe_and_cubic_inverse_match_jax():
    rs = np.random.default_rng(3)
    x = rs.random(N).astype(np.float32)
    x[:6] = [0.0, 0.3333, 0.33331, 0.6666, 0.66661, 0.99999994]
    ti, tx = tsp.select_dist_lobe(torch.tensor(x))
    ji, jx = jsp.select_dist_lobe(jnp.asarray(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tx, jx)
    close(tsp._cubic_inv_cdf(torch.tensor(x)),
          jsp._cubic_inv_cdf(jnp.asarray(x)))


def test_gaussian_profile_matches_jax():
    dist, _, rx, r = _profile_inputs(4)
    jp = jsp.make_gaussian_profile(jnp.asarray(dist))
    tp = tsp.make_gaussian_profile(torch.tensor(dist))
    for a, b in zip(tp, jp):
        close(a, b)
    live = dist[:, 0] > 0
    close(tsp.gaussian_sample_radius(tp, torch.tensor(rx))[live],
          np.asarray(jsp.gaussian_sample_radius(jp, jnp.asarray(rx)))[live])
    close(tsp.gaussian_pdf(tp, torch.tensor(r)),
          jsp.gaussian_pdf(jp, jnp.asarray(r)))
    close(tsp.gaussian_eval(tp, torch.tensor(r)),
          jsp.gaussian_eval(jp, jnp.asarray(r)))


# ---------------------------------------------------------------------------
# frames, the cosine sampler and the probe rays
# ---------------------------------------------------------------------------


def test_row_forms_match_jax():
    """The row-form frame, cosine sampler and vector helpers the probe
    stage uses (they round differently from the V3 forms)."""
    rs = np.random.default_rng(5)
    n = rs.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:8] = [0.0, 0.0, 1.0]
    n[8:16] = [0.0, 0.0, -1.0]
    u = rs.random((N, 2)).astype(np.float32)
    u[:4] = 0.5
    tf = tframe.build_frame_polar(torch.tensor(n))
    jf = jframe.build_frame_polar(jnp.asarray(n))
    for a, b in zip(tf, jf):
        close(a, b)
    tl = tvm.cosine_sample_hemisphere(torch.tensor(u[:, 0]),
                                      torch.tensor(u[:, 1]))
    jl = jvm.cosine_sample_hemisphere(jnp.asarray(u[:, 0]),
                                      jnp.asarray(u[:, 1]))
    close(tl, jl)
    close(tframe.to_world(tf, tl), jframe.to_world(jf, jl))
    a = torch.tensor(rs.normal(size=(N, 3)).astype(np.float32))
    b = torch.tensor(rs.normal(size=(N, 3)).astype(np.float32))
    close(tvm.dot(a, b), jvm.dot(jnp.asarray(a.numpy()),
                                 jnp.asarray(b.numpy())))
    close(tvm.cross(a, b), jvm.cross(jnp.asarray(a.numpy()),
                                     jnp.asarray(b.numpy())))
    close(tvm.linearstep(0.2, 0.7, a), jvm.linearstep(
        0.2, 0.7, jnp.asarray(a.numpy())))


def test_probe_rays_match_jax():
    dist, cubic, _, _ = _profile_inputs(6)
    rs = np.random.default_rng(7)
    ns = rs.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    p = rs.uniform(-2, 2, (N, 3)).astype(np.float32)
    u1 = rs.random(N).astype(np.float32)
    u1[:6] = [0.0, 0.49999997, 0.5, 0.74999994, 0.75, 0.99999994]
    u2 = rs.random(N).astype(np.float32)
    jp = jsp.make_nd_profile(jnp.asarray(dist), jnp.asarray(cubic))
    tp = tsp.make_nd_profile(torch.tensor(dist), torch.tensor(cubic))
    jo = jsss._probe_rays(jp, jframe.build_frame_polar(jnp.asarray(ns)),
                          jnp.asarray(p), jnp.asarray(u1), jnp.asarray(u2))
    to = tsss._probe_rays(tp, tframe.build_frame_polar(torch.tensor(ns)),
                          torch.tensor(p), torch.tensor(u1),
                          torch.tensor(u2))
    for a, b in zip(to, jo):
        close(a, b)
    # the axis pick: N at half the draws, U and V at a quarter each
    d = to[1].numpy()
    along_n = np.isclose(np.abs((d * ns).sum(1)), 1.0, atol=1e-5)
    assert abs(along_n.mean() - 0.5) < 0.03


# ---------------------------------------------------------------------------
# rlSkin's layering and lobes
# ---------------------------------------------------------------------------


def test_avg_fresnel_matches_jax():
    rs = np.random.default_rng(8)
    rough = rs.uniform(0.02, 0.9, N).astype(np.float32)
    ior = rs.uniform(1.1, 2.0, N).astype(np.float32)
    ent = rs.random(N) < 0.7
    wo = _dirs(rs)
    jp = jggx.make_params(jnp.ones((N, 3)), jnp.asarray(rough),
                          jnp.asarray(ior), 0.0, jnp.asarray(ent))
    tp = tggx.make_params(torch.tensor(rough), torch.tensor(ior),
                          torch.zeros(N), torch.tensor(ent))
    tf = tggx.avg_fresnel(tp, tvec3.v3(torch.tensor(wo)))
    close_conditioned(tf, jggx.avg_fresnel(jp, jvec3.v3(jnp.asarray(wo))))
    assert ((tf > 0) & (tf <= 1)).all()


SKIN_MATS = """
options
{
 AA_samples 1
 xres 4
 yres 4
 camera "cam"
}
persp_camera
{
 name cam
 fov 45
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 5 1
}
rlSkin
{
 name sheen
 sss_color 0.92 0.78 0.62
 sss_weight 0.8
 sss_scatter_dist 0.25 0.14 0.08
 specular_weight 0.35
 specular_roughness 0.35
 specular_ior 1.44
 sheen_weight 0.2
 sheen_roughness 0.3
}
rlSkin
{
 name bare
 sss_color 0.5 0.6 0.7
 sss_dist_multiplier 2
 sss_scatter_dist 0.1 0.2 0.3
 sss_cavity_fadeout off
 specular_color 0.9 0.8 0.7
 specular_weight 0.6
 specular_roughness 0.5
 sheen_weight 0
}
rlGgx
{
 name ggx
 Kd 0.4
 Ks 0.6
 specularRoughness 0.3
 ior 1.5
}
standard
{
 name std
 Kd 0.5
 Ks 0.3
 Ksss 0.4
 Ksss_color 0.9 0.5 0.4
 sss_radius 0.2 0.3 0.4
}
"""


def _mesh(i, shader):
    return (f"polymesh\n{{\n name m{i}\n nsides 1 1 UINT\n3\n"
            f" vidxs 3 1 UINT\n0 1 2\n vlist 3 1 POINT\n"
            f"{i} 0 0 {i + 1} 0 0 {i} 1 0\n shader \"{shader}\"\n}}\n")


@pytest.fixture(scope="module")
def skin_materials(tmp_path_factory):
    text = SKIN_MATS + "".join(
        _mesh(i, s) for i, s in enumerate(["sheen", "bare", "ggx", "std"]))
    path = str(tmp_path_factory.mktemp("skin") / "mats.ass")
    with open(path, "w") as f:
        f.write(text)
    return jbuild.build(path), tbuild.build(path, device="cpu")


def test_build_fills_the_skin_and_ksss_fields(skin_materials):
    js, ts = skin_materials
    for f in tbuild.Materials._fields:
        np.testing.assert_array_equal(
            getattr(ts.materials, f).numpy(),
            np.asarray(getattr(js.materials, f)), err_msg=f)
    m = ts.materials
    np.testing.assert_allclose(m.sss_dist[1].numpy(), [0.2, 0.4, 0.6])
    assert m.cavity_fadeout.tolist() == [True, False, True, False]


def _gathered(skin_materials, seed):
    js, ts = skin_materials
    rs = np.random.default_rng(seed)
    mat_id = rs.integers(0, 4, N).astype(np.int32)
    entering = rs.random(N) < 0.8
    jm = jdispatch.gather(
        js.materials, js.textures, jnp.asarray(mat_id),
        jnp.zeros((N, 2)), jnp.asarray(entering),
        p=jnp.zeros((N, 3)), fp=jnp.zeros(N), fp_uv=jnp.zeros(N),
        lod_bias=-0.5, tex_gamma=1.0)
    tm = tdispatch.gather(ts.materials, torch.tensor(mat_id),
                          torch.tensor(entering), has_skin=True,
                          has_disney=False)
    wo = _dirs(rs)
    jm = jdispatch.skin_layer_fields(jm, jvec3.v3(jnp.asarray(wo)))
    tm = tdispatch.skin_layer_fields(tm, tvec3.v3(torch.tensor(wo)))
    return jm, tm, wo, mat_id, rs


def test_skin_layer_fields_match_jax(skin_materials):
    jm, tm, _, mat_id, _ = _gathered(skin_materials, 9)
    for f in ("spec_weight", "spec2_weight", "skin_spec_w", "skin_sheen_w",
              "sss_color", "sss_dist"):
        close(getattr(tm, f), getattr(jm, f))
    # the layered fields read the Fresnel quadrature
    for f in ("sheen_layer", "sss_weight", "diffuse_color"):
        close_conditioned(getattr(tm, f), getattr(jm, f))
    for f in ("has_diffuse", "has_spec", "cavity_fadeout"):
        np.testing.assert_array_equal(_np(getattr(tm, f)),
                                      _np(getattr(jm, f)))
    sl = tm.sheen_layer.numpy()
    assert (sl[mat_id == 1] == 1.0).all() and (sl[mat_id >= 2] == 1.0).all()
    assert (sl[mat_id == 0] < 1.0).all()
    # the layered SSS weight is below the table's on skin lanes only
    w = tm.sss_weight.numpy()
    assert (w[mat_id == 0] < 0.8).all() and (w[mat_id == 3] == np.float32(0.4)).all()


@pytest.mark.parametrize("with_sheen", [True, False])
def test_skin_specular_lobes_match_jax(skin_materials, with_sheen):
    """The skin branches of eval_specular and sample_specular, with the
    sheen lobe ("sheen") and without it ("bare"), beside GGX and standard
    lanes."""
    jm, tm, wo, mat_id, rs = _gathered(skin_materials, 10 + with_sheen)
    keep = mat_id != (1 if with_sheen else 0)
    wi = _dirs(rs)
    tf, tp = tdispatch.eval_specular(tm, tvec3.v3(torch.tensor(wo)),
                                     tvec3.v3(torch.tensor(wi)))
    jf, jp = jdispatch.eval_specular(jm, jvec3.v3(jnp.asarray(wo)),
                                     jvec3.v3(jnp.asarray(wi)))
    close_conditioned(_np(tf)[keep], _np(jf)[keep])
    close_conditioned(_np(tp)[keep], _np(jp)[keep])
    rx = rs.random(N).astype(np.float32)
    ry = rs.random(N).astype(np.float32)
    ts = tdispatch.sample_specular(tm, tvec3.v3(torch.tensor(wo)),
                                   torch.tensor(rx), torch.tensor(ry))
    js_ = jdispatch.sample_specular(jm, jvec3.v3(jnp.asarray(wo)),
                                    jnp.asarray(rx), jnp.asarray(ry))
    close_conditioned(_np(ts)[keep], _np(js_)[keep])
    # in a table without rlSkin the sheen arithmetic is left out
    mats = skin_materials[1].materials
    no_skin = mats._replace(mtype=torch.where(mats.mtype == tbuild.MAT_SKIN,
                                              tbuild.MAT_GGX, mats.mtype))
    t2 = tdispatch.gather(no_skin, torch.tensor(mat_id),
                          torch.ones(N, dtype=torch.bool), has_skin=False,
                          has_disney=False)
    assert t2.ggx2 is None and tm.ggx2 is not None


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------


def test_stratified2_and_sobol2_rep_are_bit_exact():
    key = jrng.fold(jrng.stream(5), 1)
    tkey = trng.fold(trng.stream(5), 1)
    for n in (1, 2, 3):
        a = trng.stratified2(tkey, (37,), n).numpy()
        b = np.asarray(jrng.stratified2(key, (37,), n))
        assert a.shape == b.shape == (37, n * n, 2)
        np.testing.assert_array_equal(a, b)
    rs = np.random.default_rng(12)
    pix = rs.integers(-1, 5000, 300).astype(np.int32)
    aa = rs.integers(0, 4, 300).astype(np.int32)
    for s in (1, 4, 9):
        a = trng.sobol2_rep(torch.tensor(pix), torch.tensor(aa), s,
                            604 << 8, 0x9E3779B9).numpy()
        b = np.asarray(jrng.sobol2_rep(jnp.asarray(pix), jnp.asarray(aa), s,
                                       604 << 8, jnp.uint32(0x9E3779B9)))
        np.testing.assert_array_equal(a, b)
    # a purpose tensor that broadcasts against the pixels, as the probe-hit
    # lighting's per-column streams use it
    purpose = (np.arange(10, dtype=np.uint32) * np.uint32(0x10007)
               ^ np.uint32(311 * 0x1003))
    a = trng._stream_seed(torch.tensor(pix)[:, None],
                          torch.tensor(purpose.astype(np.int64))[None, :],
                          12345).numpy()
    b = np.asarray(jrng._stream_seed(jnp.asarray(pix)[:, None],
                                     jnp.asarray(purpose)[None, :],
                                     jnp.uint32(12345)))
    np.testing.assert_array_equal(a, b.astype(np.int64))


# ---------------------------------------------------------------------------
# the row-form light samplers and the probe-hit lighting
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def skin_scene():
    js = jbuild.build(SKIN)
    ja = jtrace.build(js.geometry)
    scene, accel = interop.scene_from_numpy(interop.scene_tables(js, ja),
                                            "cpu")
    tr = twave.TileRenderer(scene, accel, 1)
    return (jwave.device_scene(js, ja), jwave.SceneStatic.of(js)), tr


def test_row_form_light_samplers_match_jax(skin_scene):
    (jsc, _), tr = skin_scene
    ql = tr.sc.quad_lights
    jql = jsc.quad_lights
    rs = np.random.default_rng(13)
    p = rs.uniform(-1, 1, (512, 3)).astype(np.float32)
    u = rs.random((512, 3, 4, 2)).astype(np.float32)
    idx = [0, 0, 0]
    tls = tlights.sample_quads_batched(
        ql.verts[idx], ql.normal[idx], ql.area[idx], ql.radiance[idx],
        torch.tensor(p), torch.tensor(u))
    jls = jlights.sample_quads_batched(
        jql.verts[jnp.asarray(idx)], jql.normal[jnp.asarray(idx)],
        jql.area[jnp.asarray(idx)], jql.radiance[jnp.asarray(idx)],
        jnp.asarray(p), jnp.asarray(u))
    for a, b in zip(tls, jls):
        close(a, b)
    n = _dirs(rs, 512)
    tls = tlights.sample_sky_batched(tr.sc.sky_radiance, torch.tensor(n),
                                     torch.tensor(u[:, :1]))
    jls = jlights.sample_sky_batched(jsc.sky_radiance, jnp.asarray(n),
                                     jnp.asarray(u[:, :1]))
    for a, b in zip(tls, jls):
        close(a, b)
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:256, 1] = np.abs(d[:256, 1]) + 2.0  # toward the light, above
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    th, tt = tlights.intersect_quad(ql.verts[0], ql.normal[0],
                                    torch.tensor(p), torch.tensor(d))
    jh, jt = jlights.intersect_quad(jql.verts[0], jql.normal[0],
                                    jnp.asarray(p), jnp.asarray(d))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.any()
    close(tt, jt)
    close(tlights.pdf_quad(ql.verts[0], ql.normal[0], ql.area[0],
                           torch.tensor(p), torch.tensor(d), tt),
          jlights.pdf_quad(jql.verts[0], jql.normal[0], jql.area[0],
                           jnp.asarray(p), jnp.asarray(d), jt))


def _sheet_points(rs, n):
    """Points on and near the skin sheet, with upward normals that tilt as
    the sheet's do, and excluded triangles on some lanes."""
    x = rs.uniform(-1, 1, n)
    z = rs.uniform(-0.5, 0.5, n)
    y = 0.2 * np.cos(x * np.pi / 2) * 0.9 + rs.uniform(0, 0.02, n)
    p = np.stack([x, y, z], 1).astype(np.float32)
    nrm = np.stack([0.3 * x, np.ones(n), np.zeros(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ex = np.where(rs.random(n) < 0.5, rs.integers(0, 16, n), -1)
    return p, nrm.astype(np.float32), ex.astype(np.int32)


@pytest.mark.parametrize("sobol,cam_budget", [(False, False), (True, False),
                                              (True, True)])
def test_lambert_direct_matches_jax(skin_scene, sobol, cam_budget):
    """Measured: within 2e-6 relative of the JAX values (the any-hit
    queries agree lane for lane)."""
    (jsc, jstatic), tr = skin_scene
    rs = np.random.default_rng(14 + 2 * sobol + cam_budget)
    n = 600
    p, nrm, ex = _sheet_points(rs, n)
    pix = rs.integers(0, 4096, n).astype(np.int32)
    sidx = rs.integers(0, 36, n).astype(np.uint32)
    jkey, tkey = jrng.fold(jrng.stream(3), 7), trng.fold(trng.stream(3), 7)
    jsq = tsq = None
    if sobol:
        jsq = (jnp.asarray(pix), jnp.asarray(sidx), jnp.uint32(777),
               jnp.uint32(103))
        tsq = (torch.tensor(pix), torch.tensor(sidx.astype(np.int64)), 777,
               103)
    b = np.asarray(jsss._lambert_direct(
        jsc, jstatic, jnp.asarray(p), jnp.asarray(nrm), jnp.asarray(ex),
        jkey, sq=jsq, cam_budget=cam_budget))
    before = dict(tr.stats)
    a = tsss._lambert_direct(
        tr.sc, tr.static, torch.tensor(p), torch.tensor(nrm),
        torch.tensor(ex), tkey, sq=tsq, cam_budget=cam_budget).numpy()
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert (a > 0).mean() > 0.5
    # one any-hit query of the light columns (the quad light's samples and
    # the dome), one of the cosine sample's emitter and one of its dome
    k = (9 if cam_budget else 1) + 1
    assert tr.stats["shadow_calls"] - before["shadow_calls"] == 3
    assert tr.stats["shadow_rays"] - before["shadow_rays"] == (k + 2) * n


@pytest.mark.parametrize("sobol", [False, True])
def test_probe_march_matches_jax(skin_scene, sobol):
    """Two steps of the probe march on camera-like hits of the sheet, the
    camera-level stage's draws (Owen-Sobol, camera light budget) and the
    secondary path's (threefry by lane). Measured: within 1e-6 relative."""
    (jsc, jstatic), tr = skin_scene
    rs = np.random.default_rng(20 + sobol)
    n0 = 200
    p, nrm, _ = _sheet_points(rs, n0)
    mesh = np.zeros(n0, np.int32)
    is_sss = rs.random(n0) < 0.9
    dist = np.tile(np.array([0.25, 0.14, 0.08], np.float32), (n0, 1))
    color = np.tile(np.array([0.92, 0.78, 0.62], np.float32), (n0, 1))
    weight = rs.uniform(0.6, 0.9, n0).astype(np.float32)
    cav = rs.random(n0) < 0.5
    cubic = rs.random(n0) < 0.3
    pix = rs.integers(0, 4096, n0).astype(np.int32)
    aa = rs.integers(0, 4, n0).astype(np.int32)
    s = 4
    args = (p, nrm, mesh, is_sss, dist, color, weight, cav, cubic)
    kw = dict(n_sss=s, gi_diffuse=1, k_probe=2, use_sobol=sobol,
              cam_budget=sobol)
    jkey, tkey = jrng.fold(jrng.stream(9), 4), trng.fold(trng.stream(9), 4)
    with jax.disable_jit():
        b = np.asarray(jsss._j_sss(
            jsc, jstatic, *(jnp.asarray(a) for a in args), jkey,
            jnp.asarray(pix), jnp.asarray(aa), jnp.asarray([4242], jnp.uint32),
            **kw))
    before = dict(tr.stats)
    a = tsss._j_sss(tr.sc, tr.static, *(torch.tensor(x) for x in args), tkey,
                    torch.tensor(pix), torch.tensor(aa), 4242, **kw).numpy()
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert (a[~is_sss] == 0).all() and (a[is_sss] > 0).mean() > 0.5
    # per step: the probe and the bounce (nearest), the probe hit's light
    # columns, emitter and dome tests, and the bounce hit's (any-hit)
    k = (9 if sobol else 1) + 1
    assert tr.stats["nearest_calls"] - before["nearest_calls"] == 2 * 2
    assert tr.stats["nearest_rays"] - before["nearest_rays"] == 2 * 2 * n0 * s
    assert tr.stats["shadow_calls"] - before["shadow_calls"] == 2 * 6
    assert (tr.stats["shadow_rays"] - before["shadow_rays"]
            == 2 * ((k + 2) + (1 + 1 + 2)) * n0 * s)


def test_sss_eval_matches_jax(skin_scene):
    """The secondary path: one probe a hit, threefry draws by lane (2 march
    steps). Measured: within 1e-6 relative."""
    (jsc, jstatic), tr = skin_scene
    rs = np.random.default_rng(30)
    n0 = 300
    p, nrm, _ = _sheet_points(rs, n0)
    fields = (p, nrm, np.zeros(n0, np.int32), rs.random(n0) < 0.8,
              np.tile(np.array([0.25, 0.14, 0.08], np.float32), (n0, 1)),
              np.tile(np.array([0.92, 0.78, 0.62], np.float32), (n0, 1)),
              rs.uniform(0.6, 0.9, n0).astype(np.float32),
              np.ones(n0, bool), np.zeros(n0, bool))
    jkey, tkey = jrng.fold(jrng.stream(2), 5), trng.fold(trng.stream(2), 5)
    with jax.disable_jit():
        b = np.asarray(jsss.sss_eval(
            jsc, jstatic, tuple(jnp.asarray(a) for a in fields), jkey,
            n_sss=1, gi_diffuse=1, k_probe=2))
    a = tsss.sss_eval(tr.sc, tr.static, tuple(torch.tensor(x) for x in fields),
                      tkey, n_sss=1, gi_diffuse=1, k_probe=2).numpy()
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert (a > 0).any()


GLASS_OVER_SKIN = """
rlGgx
{
 name pane
 Kd 0
 Ks 1
 specularRoughness 0.1
 KtColor 1 1 1
 Kt 1
 ior 1.3
}
polymesh
{
 name glass
 nsides 1 1 UINT
4
 vidxs 4 1 UINT
0 1 3 2
 vlist 4 1 POINT
-3 0.5 3 3 0.5 3 -3 0.5 -3 3 0.5 -3
 shader "pane"
 opaque off
}
"""


def test_secondary_sss_runs_on_refracted_skin_hits(tmp_path, monkeypatch):
    """rlSkin seen through a glass pane: the refracted generations run
    sss_eval (one probe a hit, on every lane of the generation). Without
    the pane it never runs: the glossy families' generations carry
    ray_lobe "specular", which the reference's gate does not name."""
    from rlshaders_tpu_torch.accel import trace as ttrace

    calls = []
    real = tsss.sss_eval

    def spy(sc, static, fields, key, n_sss, gi_diffuse, k_probe=12):
        out = real(sc, static, fields, key, n_sss, gi_diffuse, k_probe)
        calls.append((fields[0].shape[0], int(fields[3].sum()),
                      float(out.sum())))
        return out

    monkeypatch.setattr(tsss, "sss_eval", spy)
    with open(SKIN) as f:
        src = f.read().replace(" GI_sss_samples 3\n", " GI_sss_samples 1\n"
                               " GI_refraction_depth 1\n"
                               " GI_refraction_samples 1\n")
    for extra in ("", GLASS_OVER_SKIN):
        path = tmp_path / f"s{len(extra)}.ass"
        path.write_text(src + extra)
        scene = tbuild.build(str(path), device="cpu")
        out = twave.render(scene, ttrace.build(scene.geometry),
                           aa_samples=1, xres=6, yres=6)
        if not extra:
            assert calls == [] and float(out["sss"].mean()) > 0.0
    # the camera-level refracted generation (36 lanes, one ray each) and
    # those at the glass hits of the diffuse and glossy families (4 rays
    # a lane)
    assert {n for n, _, _ in calls} == {36, 144}
    cam = [c for c in calls if c[0] == 36]
    assert len(cam) == 1 and cam[0][1] > 0 and cam[0][2] > 0.0
    assert float(out["refraction"].mean()) > 0.0
