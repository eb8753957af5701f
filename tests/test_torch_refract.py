"""Rough refraction, the transparent-shadow march and Russian roulette:
the port against the JAX package on the CPU, on inputs made with numpy.

Tolerances (measured, torch 2.13 CPU vs jax 0.9 CPU):

* BSDF functions: the same float32 expressions on both sides; XLA's
  sqrt/rsqrt and fusion differ from torch's in the last bits. Well
  conditioned outputs are held to RTOL 2e-5 / ATOL 2e-6 (as
  tests/test_torch_core_bsdf.py). Outputs that pass through the VNDF
  sampler or normalise a near-zero half vector are ill-conditioned: all
  elements within 1e-3 relative / 1e-4 absolute and 99% within
  RTOL/ATOL (measured: sampled directions and weights within 1.6e-4, at
  least 99.5% within RTOL/ATOL; the rest within RTOL/ATOL). TIR masks may
  flip only where cos^2 of the refracted angle is within rounding of 0: at
  most 0.1% of lanes (measured: none).
* The march: hits come from the same BVH rules, so the transmissions
  agree to 1e-6 (measured: exactly, or within one ulp).
* Frame A (a copy of scenes/glass_sphere.ass at refraction depth 2, no
  diffuse or glossy depth, one sample of each, 16x16, AA 1): measured
  every pixel of every plane within 1.5e-6 of the JAX frame, through both
  the port's build and interop, with Russian roulette off and on. Stated:
  1e-5 absolute per pixel and channel, at most 4 pixels beyond it and none
  beyond 1e-3; plane means within 1e-5 relative.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.bsdf import ggx as jggx
from rlshaders_tpu.core import vec3 as jvec3
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.models import dispatch as jdispatch
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.bsdf import ggx as tggx
from rlshaders_tpu_torch.core import vec3 as tvec3
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.models import dispatch as tdispatch
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()

GLASS = "scenes/glass_sphere.ass"
N = 4096
RTOL = 2e-5
ATOL = 2e-6
LOOSE_RTOL = 1e-3
LOOSE_ATOL = 1e-4
TIGHT_SHARE = 0.99
TIR_FLIP_SHARE = 1e-3
MARCH_ATOL = 1e-6
RES = 16
PIX_ATOL = 1e-5
OUTLIER_ATOL = 1e-3
MAX_OUTLIERS = 4
MEAN_RTOL = 1e-5
PLANES = ("RGBA", "direct_diffuse", "direct_specular", "indirect_diffuse",
          "indirect_specular", "refraction", "sss")


def glass_copy(path, **opts) -> str:
    """scenes/glass_sphere.ass with options replaced, written to `path`."""
    with open(GLASS) as f:
        src = f.read()
    for k, v in opts.items():
        src, n = re.subn(rf"^ {k} \d+$", f" {k} {v}", src, flags=re.M)
        assert n == 1, k
    with open(path, "w") as f:
        f.write(src)
    return str(path)


FRAME_A = dict(GI_refraction_depth=2, GI_diffuse_depth=0, GI_glossy_depth=0,
               GI_diffuse_samples=1, GI_glossy_samples=1,
               GI_refraction_samples=1)


def frames_agree(port, ref, name, res):
    a = port[name].numpy()
    b = np.asarray(ref[name])
    assert a.shape == b.shape == (res, res, 3)
    assert np.isfinite(a).all()
    err = np.abs(a - b)
    assert err.max() <= OUTLIER_ATOL, (name, err.max())
    outliers = (err > PIX_ATOL).any(-1).sum()
    assert outliers <= MAX_OUTLIERS, (name, outliers)
    ma, mb = float(a.mean()), float(b.mean())
    assert abs(ma - mb) <= max(MEAN_RTOL * abs(mb), 1e-7), (name, ma, mb)


def render_both(path, res, rr_start):
    """(JAX frame, port frame via its own build, port frame via interop)
    of the scene at `path`, res x res, AA 1, seed 0, Russian roulette from
    refraction depth `rr_start`."""
    kw = dict(seed=0, aa_samples=1, xres=res, yres=res)
    js = jbuild.build(path)
    ja = jtrace.build(js.geometry)
    with pytest.MonkeyPatch.context() as m:
        # read when the JAX TileRenderer is built
        m.setenv("RLS_RR_START", str(rr_start))
        jout = jwave.render(js, ja, **kw)
    ts = tbuild.build(path, device="cpu")
    own = twave.render(ts, ttrace.build(ts.geometry), rr_refr_start=rr_start,
                       **kw)
    iscene, iaccel = interop.scene_from_numpy(
        interop.scene_tables(js, ja), "cpu")
    via = twave.render(iscene, iaccel, rr_refr_start=rr_start, **kw)
    return jout, own, via


# ---------------------------------------------------------------------------
# (a) the GGX refraction functions
# ---------------------------------------------------------------------------


def _dirs(rs, n=N, z_sign=1.0):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = z_sign * np.abs(d[:, 2])
    return d


def _params(rs, ior, entering):
    rough = rs.uniform(0.02, 0.9, N).astype(np.float32)
    aniso = np.where(rs.random(N) < 0.3, rs.uniform(0, 0.8, N),
                     0.0).astype(np.float32)
    ent = np.full(N, entering)
    iors = np.full(N, ior, np.float32)
    jp = jggx.make_params(jnp.ones((N, 3)), jnp.asarray(rough),
                          jnp.asarray(iors), jnp.asarray(aniso),
                          jnp.asarray(ent))
    tp = tggx.make_params(torch.tensor(rough), torch.tensor(iors),
                          torch.tensor(aniso), torch.tensor(ent))
    return jp, tp


def J(a):
    return jvec3.v3(jnp.asarray(a))


def T(a):
    return tvec3.v3(torch.tensor(a))


def _np(x):
    if isinstance(x, tvec3.V3):
        return x.aos().numpy()
    if isinstance(x, jvec3.V3):
        return np.asarray(x.aos())
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(t, j):
    np.testing.assert_allclose(_np(t), _np(j), rtol=RTOL, atol=ATOL)


def close_conditioned(t, j, where=None):
    a, b = _np(t), _np(j)
    if where is not None:
        a, b = a[where], b[where]
    np.testing.assert_allclose(a, b, rtol=LOOSE_RTOL, atol=LOOSE_ATOL)
    tight = np.abs(a - b) <= ATOL + RTOL * np.abs(b)
    assert tight.mean() >= TIGHT_SHARE, tight.mean()


def tir_agree(t, j):
    flips = (_np(t) != _np(j)).mean()
    assert flips <= TIR_FLIP_SHARE, flips
    return _np(t) == _np(j)


CASES = [(1.5, True), (1.5, False), (0.47, True), (0.47, False)]


@pytest.mark.parametrize("ior,entering", CASES)
def test_refract_direction(ior, entering):
    seed = int(ior * 100) + entering
    jp, tp = _params(np.random.default_rng(seed), ior, entering)
    rs = np.random.default_rng(seed + 1)
    wo = _dirs(rs)
    m = _dirs(rs)
    m[:, 2] += 2.0  # microfacet normals near +z, as the VNDF draws them
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    twi, ttir = tggx.refract_direction(T(m), T(wo), tp.ior_in, tp.ior_out)
    jwi, jtir = jggx.refract_direction(J(m), J(wo), jp.ior_in, jp.ior_out)
    same = tir_agree(ttir, jtir)
    # TIR only from the denser side: exiting ior 1.5, entering ior 0.47
    if (ior > 1.0) != entering:
        assert 0 < _np(ttir).mean() < 1
    else:
        assert not _np(ttir).any()
    close(twi.aos()[torch.tensor(same & ~_np(ttir))],
          np.asarray(jwi.aos())[same & ~_np(ttir)])
    # the transmitted direction crosses the microfacet
    cross = tvec3.dot(twi, T(m)).numpy()[~_np(ttir)]
    assert (cross <= 1e-6).all()
    # sign(0) is 1: a grazing wo (z = +-0) refracts like z > 0
    z = np.zeros((2, 3), np.float32)
    z[:, 0] = 1.0
    z[1, 2] = -0.0
    mm = np.tile(np.array([[0, 0, 1]], np.float32), (2, 1))
    one = torch.ones(2)
    wz, _ = tggx.refract_direction(T(mm), T(z), one, 1.2 * one)
    jz, _ = jggx.refract_direction(J(mm), J(z), jnp.ones(2), 1.2 * jnp.ones(2))
    close(wz, jz)


@pytest.mark.parametrize("ior,entering", CASES)
def test_refraction_term_and_sample_weight(ior, entering):
    seed = 7 + int(ior * 100) + entering
    jp, tp = _params(np.random.default_rng(seed), ior, entering)
    rs = np.random.default_rng(seed + 1)
    wo = _dirs(rs)
    wi = _dirs(rs, z_sign=-1.0)
    m = _dirs(rs)
    close_conditioned(tggx.refraction_term(tp, T(wo), T(wi)),
                      jggx.refraction_term(jp, J(wo), J(wi)))
    close_conditioned(tggx.bsdf_sample_weight(tp, T(wo), T(wi), T(m)),
                      jggx.bsdf_sample_weight(jp, J(wo), J(wi), J(m)))


@pytest.mark.parametrize("ior,entering", CASES)
def test_sample_refract(ior, entering):
    seed = 11 + int(ior * 100) + entering
    jp, tp = _params(np.random.default_rng(seed), ior, entering)
    rs = np.random.default_rng(seed + 1)
    wo = _dirs(rs)
    rx = rs.random(N).astype(np.float32)
    ry = rs.random(N).astype(np.float32)
    twi, tw, ttir = tggx.sample_refract(tp, T(wo), torch.tensor(rx),
                                        torch.tensor(ry))
    jwi, jw, jtir = jggx.sample_refract(jp, J(wo), jnp.asarray(rx),
                                        jnp.asarray(ry))
    same = tir_agree(ttir, jtir)
    close_conditioned(twi, jwi, same)
    close_conditioned(tw, jw, same)
    if ior == 0.47 and entering:
        # testsuite 0003's ior: total internal reflection on most lanes
        assert _np(ttir).mean() > 0.5


# ---------------------------------------------------------------------------
# (b) dispatch: refraction fields and the refraction lobe
# ---------------------------------------------------------------------------

MATERIALS_ASS = """
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
rlGgx
{
 name glass
 Kd 0
 Ks 1
 specularRoughness 0.08
 KtColor 0.97 0.99 0.97
 Kt 1
 ior 1.5
}
rlGgx
{
 name tir
 Kd 0.2
 Ks 0.5
 specularRoughness 0.3
 anisotropic 0.4
 KtColor 0.8 0.9 1.0
 Kt 0.5
 ior 0.47
}
rlGgx
{
 name veil
 Kd 0.5
 Ks 0.5
 specularRoughness 0.5
 opacity 0.5
 opacity_color 1 0.5 0.25
}
standard
{
 name floor
 Kd 0.8
 opacity 0.3 0.6 0.9
}
"""


def _mesh(i, shader):
    return (f"polymesh\n{{\n name m{i}\n nsides 1 1 UINT\n3\n"
            f" vidxs 3 1 UINT\n0 1 2\n vlist 3 1 POINT\n"
            f"{i} 0 0 {i + 1} 0 0 {i} 1 0\n shader \"{shader}\"\n}}\n")


@pytest.fixture(scope="module")
def materials(tmp_path_factory):
    text = MATERIALS_ASS + "".join(
        _mesh(i, s) for i, s in enumerate(["glass", "tir", "veil", "floor"]))
    path = str(tmp_path_factory.mktemp("refr") / "mats.ass")
    with open(path, "w") as f:
        f.write(text)
    return jbuild.build(path), tbuild.build(path, device="cpu")


def test_dispatch_refraction_fields_and_lobe(materials):
    js, ts = materials
    np.testing.assert_array_equal(ts.materials.kt_color.numpy(),
                                  np.asarray(js.materials.kt_color))
    rs = np.random.default_rng(30)
    mat_id = rs.integers(0, 4, N).astype(np.int32)
    entering = rs.random(N) < 0.6
    jm = jdispatch.gather(
        js.materials, js.textures, jnp.asarray(mat_id),
        jnp.zeros((N, 2)), jnp.asarray(entering),
        p=jnp.zeros((N, 3)), fp=jnp.zeros(N), fp_uv=jnp.zeros(N),
        lod_bias=-0.5, tex_gamma=1.0)
    tm = tdispatch.gather(ts.materials, torch.tensor(mat_id),
                          torch.tensor(entering), has_skin=False,
                          has_disney=False)
    for f in ("kt_color", "opacity"):
        close(getattr(tm, f), getattr(jm, f))
    np.testing.assert_array_equal(tm.has_refract.numpy(),
                                  np.asarray(jm.has_refract))
    assert tm.has_refract.numpy()[mat_id < 2].all()
    assert not tm.has_refract.numpy()[mat_id >= 2].any()
    wo = _dirs(rs)
    rx = rs.random(N).astype(np.float32)
    ry = rs.random(N).astype(np.float32)
    twi, tw = tdispatch.sample_refract(tm, T(wo), torch.tensor(rx),
                                       torch.tensor(ry))
    jwi, jw = jdispatch.sample_refract(jm, J(wo), jnp.asarray(rx),
                                       jnp.asarray(ry))
    close_conditioned(twi, jwi)
    close_conditioned(tw, jw)
    assert (tw.aos().numpy()[mat_id >= 2] == 0).all()


# ---------------------------------------------------------------------------
# (c) the transparent-shadow march
# ---------------------------------------------------------------------------


def _segments(n, seed):
    """Shadow segments through and around the glass sphere (center
    (0, 1.05, 0), radius about 1): from above to the floor, from inside the
    sphere, short ones that end before a surface, dead ones and ones that
    exclude a triangle."""
    rs = np.random.default_rng(seed)
    o = np.stack([rs.uniform(-1.5, 1.5, n), rs.uniform(2.5, 4.0, n),
                  rs.uniform(-1.5, 1.5, n)], 1)
    inside = rs.random(n) < 0.2
    o[inside] = [0.0, 1.05, 0.0] + rs.uniform(-0.3, 0.3, (inside.sum(), 3))
    target = np.stack([rs.uniform(-1.5, 1.5, n), np.zeros(n),
                       rs.uniform(-1.5, 1.5, n)], 1)
    d = target - o
    length = np.linalg.norm(d, axis=1)
    d /= length[:, None]
    kind = rs.random(n)
    t_max = np.where(kind < 0.3, length - 3e-3,          # stops at the floor
                     np.where(kind < 0.5, length + 1.0,  # reaches the floor
                              np.where(kind < 0.7, 0.3 * length,  # short
                                       np.where(kind < 0.8, 0.0,  # dead
                                                1e12))))
    t_max[(kind >= 0.8) & (kind < 0.85)] = -1.0
    ex = np.where(rs.random(n) < 0.2, rs.integers(0, 1026, n), -1)
    return (o.astype(np.float32), d.astype(np.float32),
            t_max.astype(np.float32), ex.astype(np.int32))


def test_shadow_march_matches_jax():
    js = jbuild.build(GLASS)
    ja = jtrace.build(js.geometry)
    jsc = jwave.device_scene(js, ja)
    jstatic = jwave.SceneStatic.of(js)
    scene, accel = interop.scene_from_numpy(interop.scene_tables(js, ja),
                                            "cpu")
    tr = twave.TileRenderer(scene, accel, 1)
    assert tr.static.has_transparent and jstatic.has_transparent
    o, d, t_max, ex = _segments(6000, 40)
    ja_ = jwave._shadow_transmission(
        jsc, jstatic, tuple(jnp.asarray(a) for a in (o, d, t_max, ex)))
    ta = twave._shadow_transmission(
        tr.sc, tr.static, tuple(torch.tensor(a) for a in (o, d, t_max, ex)))
    a, b = ta.aos().numpy(), np.asarray(ja_.aos())
    np.testing.assert_allclose(a, b, rtol=0, atol=MARCH_ATOL)
    # one nearest query per march step, none of the any-hit kind
    assert tr.stats["nearest_calls"] == twave.SHADOW_HITS
    assert tr.stats["shadow_calls"] == 0
    assert tr.stats["march_segments"] == len(o)
    kt = np.array([0.97, 0.99, 0.97], np.float32)
    dead = t_max <= 0
    assert (a[dead] == 1.0).all()
    # the mix covers: blocked by the floor, through both glass surfaces,
    # through one (from inside), and unobstructed
    assert (a.max(1) == 0).any()
    assert np.isclose(a, kt * kt, atol=1e-6).all(1).any()
    assert np.isclose(a, kt, atol=1e-6).all(1).any()
    assert ((a == 1.0).all(1) & ~dead).any()


# ---------------------------------------------------------------------------
# (d, e, f) frame A: the slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame_a_path(tmp_path_factory):
    return glass_copy(tmp_path_factory.mktemp("glass") / "a.ass", **FRAME_A)


@pytest.fixture(scope="module")
def frame_a(frame_a_path):
    return render_both(frame_a_path, RES, 99)


@pytest.fixture(scope="module")
def frame_a_rr(frame_a_path):
    return render_both(frame_a_path, RES, 1)


@pytest.mark.parametrize("name", PLANES)
def test_frame_a_matches_jax(frame_a, name):
    jout, own, via = frame_a
    frames_agree(own, jout, name, RES)
    frames_agree(via, jout, name, RES)


@pytest.mark.parametrize("name", PLANES)
def test_frame_a_russian_roulette_matches_jax(frame_a_rr, name):
    jout, own, via = frame_a_rr
    frames_agree(own, jout, name, RES)
    frames_agree(via, jout, name, RES)


def test_russian_roulette_changes_the_frame(frame_a, frame_a_rr):
    off, on = frame_a[1], frame_a_rr[1]
    assert not torch.equal(off["refraction"], on["refraction"])
    # roulette kills lanes, it does not add queries: the dead lanes are
    # still handed to the kernel, with t_max 0
    assert off["__stats__"] == on["__stats__"]


def test_frame_a_refracts_and_counts_rays(frame_a):
    _, own, _ = frame_a
    assert float(own["refraction"].mean()) > 0.01
    n = RES * RES
    stats = own["__stats__"]
    # per camera ray: the camera ray and 10 light-grid segments (9 quad
    # samples + the dome) of 4 march steps; then two refraction generations
    # (depth 2), each one refraction ray + 2 segments of 4 steps
    assert stats["nearest_rays"] == (1 + 10 * 4 + 2 * (1 + 2 * 4)) * n
    assert stats["march_segments"] == (10 + 2 * 2) * n
    # every light-grid segment marches; the only any-hit queries are the
    # depth-exhausted lobes' one-sample light pickup at the two refracted
    # hits (specular and diffuse), which the reference tests with an
    # any-hit query even in a transparent scene (wavefront.py:821)
    assert stats["shadow_rays"] == 2 * 2 * n
    assert stats["shadow_calls"] == 4
