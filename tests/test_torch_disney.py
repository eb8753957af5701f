"""The port's Disney principled BRDF (bsdf/disney.py), its lanes in
dispatch and its material fields, against the JAX package at fixed
float32 inputs made with numpy; and the port's versions of the property
tests of tests/test_disney.py.

Tolerances, as measured on these inputs:

* Well-conditioned outputs (the parameters, the NDFs, Smith G, the diffuse
  lobe, the specular lobe and its pdf with the clearcoat off): RTOL 2e-5 /
  ATOL 2e-6, as tests/test_torch_core_bsdf.py. Measured: the parameters
  equal but alpha (one ulp of sqrt), the rest within 2e-6 relative.
* The clearcoat on: GTR1 at gloss near 1 (alpha 1e-3) divides by
  1 + (a2 - 1) mdotn2, which cancels near the peak, so one ulp of the half
  vector moves it by up to 1e-3 relative. Every element within 1e-3
  relative and 99% within RTOL/ATOL (measured: 6.9e-4 at most, 99.97%).
* Sampled directions (unit vectors): the VNDF and GTR1 samplers near their
  degenerate branches and the reflection about the sampled normal amplify
  the last bits of sqrt, log, exp, sin and cos. Every component within
  DIR_ATOL 1e-3 absolute and 99% within RTOL/ATOL (measured: 3.0e-4 at
  most, 99.6%).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.bsdf import disney as jd
from rlshaders_tpu.core import vec3 as jv
from rlshaders_tpu.models import dispatch as jdispatch
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.bsdf import disney as td
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.core import vec3 as tv
from rlshaders_tpu_torch.models import dispatch as tdispatch
from rlshaders_tpu_torch.scene import build as tbuild

N = 4096
RTOL = 2e-5
ATOL = 2e-6
LOOSE_RTOL = 1e-3
LOOSE_ATOL = 1e-4
DIR_ATOL = 1e-3
TIGHT_SHARE = 0.99
SCENE = "scenes/disney_spheres.ass"

cpu_math.settle()


def _np(x):
    if isinstance(x, tv.V3):
        return x.aos().numpy()
    if isinstance(x, jv.V3):
        return np.asarray(x.aos())
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(t, j):
    np.testing.assert_allclose(_np(t), _np(j), rtol=RTOL, atol=ATOL)


def _tight_share(a, b):
    tight = np.abs(a - b) <= ATOL + RTOL * np.abs(b)
    assert tight.mean() >= TIGHT_SHARE, tight.mean()


def close_conditioned(t, j):
    a, b = _np(t), _np(j)
    np.testing.assert_allclose(a, b, rtol=LOOSE_RTOL, atol=LOOSE_ATOL)
    _tight_share(a, b)


def close_direction(t, j):
    a, b = _np(t), _np(j)
    np.testing.assert_allclose(a, b, rtol=0.0, atol=DIR_ATOL)
    _tight_share(a, b)


def J(a):
    return jv.v3(jnp.asarray(a))


def T(a):
    return tv.v3(torch.tensor(a))


def _dirs(rs, upper=True):
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if upper:
        d[:, 2] = np.abs(d[:, 2])
    return d


def _lanes(seed, clearcoat=True):
    """Random per-lane parameters, a share of each weight 0: every lobe on
    and off, metallic and sheen tint included."""
    rs = np.random.default_rng(seed)

    def u(lo=0.0, hi=1.0, zero=0.0):
        a = rs.uniform(lo, hi, N).astype(np.float32)
        a[rs.random(N) < zero] = 0.0
        return a

    base = rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    base[:16] = 0.0  # black: the tint's lum > 0 branch
    kw = dict(subsurface=u(zero=.3), metallic=u(zero=.3), specular=u(),
              specular_tint=u(zero=.3), roughness=u(0.02, 1.0),
              anisotropic=u(0.0, 0.9, zero=.4), sheen=u(zero=.3),
              sheen_tint=u(zero=.3),
              clearcoat=u(zero=.3) if clearcoat else np.zeros(N, np.float32),
              clearcoat_gloss=u())
    jp = jd.make_params(J(base), **{k: jnp.asarray(v) for k, v in kw.items()})
    tp = td.make_params(T(base), **{k: torch.tensor(v) for k, v in kw.items()})
    return jp, tp, rs


def test_make_params_matches_jax():
    jp, tp, _ = _lanes(1)
    for f in td.DisneyParams._fields:
        close(getattr(tp, f), getattr(jp, f))
    # the reference's F0 remap and the tint's reciprocal multiply: exact
    for f in ("base_color", "sheen_color", "spec_f0", "clearcoat",
              "spec_roughness"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      _np(getattr(jp, f)), err_msg=f)
    assert tv.luminance(T(np.eye(3, dtype=np.float32))).tolist() == \
        pytest.approx([0.2126, 0.7152, 0.0722])


def test_lobe_terms_match_jax():
    jp, tp, rs = _lanes(2)
    wo, wi = _dirs(rs), _dirs(rs)
    mz2 = wi[:, 2] * wi[:, 2]
    close(td.d_gtr1(tp, torch.tensor(mz2)), jd.d_gtr1(jp, jnp.asarray(mz2)))
    close(td.d_gtr2_aniso(tp, T(wi), torch.tensor(mz2)),
          jd.d_gtr2_aniso(jp, J(wi), jnp.asarray(mz2)))
    close(td.smith_g_over_2ndotv(torch.tensor(wo[:, 2]), tp.spec_roughness),
          jd.smith_g_over_2ndotv(jnp.asarray(wo[:, 2]), jp.spec_roughness))
    close(td.eval_diffuse(tp, T(wo), T(wi)), jd.eval_diffuse(jp, J(wo), J(wi)))
    close(td.eval_diffuse_cos(tp, T(wo), T(wi)),
          jd.eval_diffuse_cos(jp, J(wo), J(wi)))
    close(td.pdf_diffuse(tp, T(wo), T(wi)), jd.pdf_diffuse(jp, J(wo), J(wi)))


@pytest.mark.parametrize("with_clearcoat", [True, False])
def test_specular_lobe_matches_jax(with_clearcoat):
    jp, tp, rs = _lanes(3, clearcoat=with_clearcoat)
    wo, wi = _dirs(rs), _dirs(rs)
    check = close_conditioned if with_clearcoat else close
    for t_fn, j_fn in ((td.eval_specular, jd.eval_specular),
                       (td.eval_specular_cos, jd.eval_specular_cos),
                       (td.pdf_specular, jd.pdf_specular)):
        check(t_fn(tp, T(wo), T(wi), with_clearcoat),
              j_fn(jp, J(wo), J(wi), with_clearcoat))
    # at clearcoat 0 the clearcoat-on path equals the off branch
    if not with_clearcoat:
        for fn in (td.eval_specular, td.pdf_specular):
            np.testing.assert_array_equal(_np(fn(tp, T(wo), T(wi), True)),
                                          _np(fn(tp, T(wo), T(wi), False)))


@pytest.mark.parametrize("with_clearcoat", [True, False])
def test_samplers_match_jax(with_clearcoat):
    jp, tp, rs = _lanes(4, clearcoat=with_clearcoat)
    wo = _dirs(rs)
    rx = rs.random(N).astype(np.float32)
    ry = rs.random(N).astype(np.float32)
    trx, try_ = torch.tensor(rx), torch.tensor(ry)
    jrx, jry = jnp.asarray(rx), jnp.asarray(ry)
    close_direction(td.sample_specular(tp, T(wo), trx, try_, with_clearcoat),
                    jd.sample_specular(jp, J(wo), jrx, jry, with_clearcoat))
    close_direction(td.sample_diffuse(tp, T(wo), trx, try_),
                    jd.sample_diffuse(jp, J(wo), jrx, jry))
    close_direction(td._sample_gtr1(tp, trx, try_),
                    jd._sample_gtr1(jp, jrx, jry))
    close_direction(td._sample_gtr2_aniso_vndf(tp, T(wo), trx, try_),
                    jd._sample_gtr2_aniso_vndf(jp, J(wo), jrx, jry))
    assert td.has_clearcoat(tp) == jd.has_clearcoat(jp) == with_clearcoat


def test_gtr1_degenerate_branch():
    """roughness 1: a2 = 1 takes the sqrt(1 - ry) branch of the GTR1
    sampler, in both packages."""
    rs = np.random.default_rng(5)
    rx = rs.random(N).astype(np.float32)
    ry = rs.random(N).astype(np.float32)
    base = np.full((N, 3), 0.5, np.float32)
    jp = jd.make_params(J(base), roughness=jnp.ones(N), clearcoat=jnp.ones(N))
    tp = td.make_params(T(base), roughness=torch.ones(N),
                        clearcoat=torch.ones(N))
    m = td._sample_gtr1(tp, torch.tensor(rx), torch.tensor(ry))
    close_direction(m, jd._sample_gtr1(jp, jnp.asarray(rx), jnp.asarray(ry)))
    np.testing.assert_allclose(m.z.numpy(), np.sqrt(1.0 - ry), rtol=1e-6)


# ---------------------------------------------------------------------------
# dispatch: Disney lanes beside GGX, standard and skin lanes in one table
# ---------------------------------------------------------------------------

MATS_ASS = """
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
 name ggx
 Kd 0.4
 KdColor 0.7 0.3 0.2
 Ks 0.6
 specularRoughness 0.3
 anisotropic 0.5
 ior 1.5
}
standard
{
 name std
 Kd 0.8
 Kd_color 0.6 0.6 0.6
 Ks 0.3
 specular_roughness 0.2
}
rlSkin
{
 name skin
 sss_color 0.92 0.78 0.62
 sss_weight 0.8
 specular_weight 0.35
 specular_roughness 0.35
 sheen_weight 0.2
 sheen_roughness 0.3
}
rlDisney
{
 name coat
 base_color 0.6 0.1 0.1
 roughness 0.5
 sheen 1
 sheen_tint 0.5
 clearcoat 1
 clearcoat_gloss 0.8
 indirectDiffuseScale 0.5
 indirectSpecularScale 2
}
rlDisney
{
 name aniso
 base_color 0.7 0.7 0.7
 metallic 0.5
 roughness 0.4
 anisotropic 0.8
 specular 0.5
 specular_tint 0.3
 subsurface 0.6
}
"""
MAT_NAMES = ["ggx", "std", "skin", "coat", "aniso"]


def _mesh(i, shader):
    return (f"polymesh\n{{\n name m{i}\n nsides 1 1 UINT\n3\n"
            f" vidxs 3 1 UINT\n0 1 2\n vlist 3 1 POINT\n"
            f"{i} 0 0 {i + 1} 0 0 {i} 1 0\n shader \"{shader}\"\n}}\n")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    text = MATS_ASS + "".join(_mesh(i, s) for i, s in enumerate(MAT_NAMES))
    path = str(tmp_path_factory.mktemp("dsy") / "mats.ass")
    with open(path, "w") as f:
        f.write(text)
    return jbuild.build(path), tbuild.build(path, device="cpu")


def _gathered(mixed, seed, diffuse_ray=False):
    js, ts = mixed
    rs = np.random.default_rng(seed)
    mat_id = rs.integers(0, len(MAT_NAMES), N).astype(np.int32)
    entering = rs.random(N) < 0.8
    jm = jdispatch.gather(
        js.materials, js.textures, jnp.asarray(mat_id),
        jnp.zeros((N, 2)), jnp.asarray(entering),
        p=jnp.zeros((N, 3)), fp=jnp.zeros(N), fp_uv=jnp.zeros(N),
        lod_bias=-0.5, tex_gamma=1.0, diffuse_ray=diffuse_ray)
    tm = tdispatch.gather(ts.materials, torch.tensor(mat_id),
                          torch.tensor(entering), has_skin=True,
                          has_disney=True, diffuse_ray=diffuse_ray)
    wo = _dirs(rs)
    jm = jdispatch.skin_layer_fields(jm, J(wo))
    tm = tdispatch.skin_layer_fields(tm, T(wo))
    return jm, tm, wo, mat_id, rs


def test_build_reads_disney_rows(mixed):
    js, ts = mixed
    for f in tbuild.Materials._fields:
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      np.asarray(getattr(js.materials, f)),
                                      err_msg=f)
    m = ts.materials
    coat = MAT_NAMES.index("coat")
    assert m.mtype[coat] == tbuild.MAT_DISNEY
    np.testing.assert_allclose(m.kd_color[coat].numpy(), [0.6, 0.1, 0.1])
    assert float(m.indirect_diffuse_scale[coat]) == 0.5
    assert float(m.indirect_specular_scale[coat]) == 2.0
    assert float(m.spec_aniso[MAT_NAMES.index("aniso")]) == \
        pytest.approx(0.8)
    # the other rows keep the JAX defaults
    assert m.indirect_diffuse_scale[:3].tolist() == [1.0] * 3
    assert m.clearcoat[:3].tolist() == [0.0] * 3


@pytest.mark.parametrize("diffuse_ray", [False, True])
def test_gather_disney_lanes_match_jax(mixed, diffuse_ray):
    jm, tm, _, mat_id, _ = _gathered(mixed, 6, diffuse_ray)
    for f in td.DisneyParams._fields:
        close(getattr(tm.dsy, f), getattr(jm.dsy, f))
    for f in ("indirect_diffuse_scale", "indirect_specular_scale",
              "spec_weight", "emission"):
        close(getattr(tm, f), getattr(jm, f))
    for f in ("has_diffuse", "has_spec", "mtype"):
        np.testing.assert_array_equal(_np(getattr(tm, f)),
                                      _np(getattr(jm, f)), err_msg=f)
    close_conditioned(tm.diffuse_color, jm.diffuse_color)
    is_dsy = tm.mtype.numpy() == tbuild.MAT_DISNEY
    assert (tm.diffuse_color.aos().numpy()[is_dsy] == 1.0).all()
    # every field is per lane, so tile_v repeats every lane
    t3 = tdispatch.tile_v(tm, 3)
    assert t3.dsy.alpha_x.shape == t3.dsy.base_color.x.shape == (3 * N,)
    assert t3.indirect_diffuse_scale.shape == (3 * N,)


def test_dispatch_lobes_match_jax(mixed):
    """eval_diffuse, eval_specular (clearcoat on, as the JAX dispatch
    calls it) and the specular mixture sample on a table of rlGgx,
    standard, rlSkin and two rlDisney rows."""
    jm, tm, wo, mat_id, rs = _gathered(mixed, 7)
    wi = _dirs(rs)
    for t_fn, j_fn in ((tdispatch.eval_diffuse, jdispatch.eval_diffuse),
                       (tdispatch.eval_specular, jdispatch.eval_specular)):
        tf, tp = t_fn(tm, T(wo), T(wi))
        jf, jp = j_fn(jm, J(wo), J(wi))
        close_conditioned(tf, jf)
        close_conditioned(tp, jp)
    # the diffuse pdf is the cosine sampler's, clamped at 1e-9
    _, tp = tdispatch.eval_diffuse(tm, T(wo), T(wi))
    np.testing.assert_allclose(
        tp.numpy(), np.maximum(np.maximum(wi[:, 2], 0) / np.pi, 1e-9),
        rtol=1e-6)
    rx = rs.random(N).astype(np.float32)
    ry = rs.random(N).astype(np.float32)
    close_direction(
        tdispatch.sample_specular(tm, T(wo), torch.tensor(rx),
                                  torch.tensor(ry)),
        jdispatch.sample_specular(jm, J(wo), jnp.asarray(rx),
                                  jnp.asarray(ry)))


def test_tables_without_disney_leave_it_out(mixed):
    _, ts = mixed
    m = ts.materials
    no_dsy = m._replace(mtype=torch.where(m.mtype == tbuild.MAT_DISNEY,
                                          tbuild.MAT_GGX, m.mtype))
    ids = torch.arange(len(MAT_NAMES), dtype=torch.int32)
    ent = torch.ones(len(MAT_NAMES), dtype=torch.bool)
    g = tdispatch.gather(no_dsy, ids, ent, has_skin=True, has_disney=False)
    assert g.dsy is None and g.indirect_diffuse_scale is None
    wo = tv.V3(*(torch.full((len(MAT_NAMES),), c) for c in (0.3, 0.1, 0.9)))
    wi = tv.V3(*(torch.full((len(MAT_NAMES),), c) for c in (-0.2, 0.4, 0.8)))
    f, pdf = tdispatch.eval_specular(g, wo, wi)
    # the same rows with the Disney lanes computed give the same values
    g2 = tdispatch.gather(no_dsy, ids, ent, has_skin=True, has_disney=True)
    f2, pdf2 = tdispatch.eval_specular(g2, wo, wi)
    assert torch.equal(f.aos(), f2.aos()) and torch.equal(pdf, pdf2)


# ---------------------------------------------------------------------------
# the scene: build and interop
# ---------------------------------------------------------------------------

def test_disney_scene_builds_as_jax():
    js = jbuild.build(SCENE)
    ts = tbuild.build(SCENE, device="cpu")
    n = ts.geometry.v0.shape[0]
    assert n == 2402
    for f in tbuild.Geometry._fields:
        np.testing.assert_array_equal(
            getattr(ts.geometry, f).numpy(),
            np.asarray(getattr(js.geometry, f))[:n], err_msg=f)
    for f in tbuild.Materials._fields:
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      np.asarray(getattr(js.materials, f)),
                                      err_msg=f)
    assert ts.material_names == js.material_names == [
        "floor_mat", "dsy_default", "dsy_subsurface", "dsy_metal",
        "dsy_specular", "dsy_aniso", "dsy_coat"]
    m = ts.materials
    assert m.mtype.tolist() == [tbuild.MAT_STANDARD] + [tbuild.MAT_DISNEY] * 6
    # clearcoat on and off in one table
    assert m.clearcoat.tolist() == [0.0] * 6 + [1.0]
    # interop carries the Disney fields by name from the JAX tables
    from rlshaders_tpu.accel import trace as jtrace

    iscene, _ = interop.scene_from_numpy(
        interop.scene_tables(js, jtrace.build(js.geometry)), "cpu")
    for f in tdispatch._DISNEY_FIELDS + ("kd_color", "spec_roughness",
                                         "spec_aniso", "mtype"):
        assert torch.equal(getattr(iscene.materials, f),
                           getattr(ts.materials, f)), f


# ---------------------------------------------------------------------------
# the property tests of tests/test_disney.py, on the port
# ---------------------------------------------------------------------------

def _view(theta_deg, n=1):
    t = np.deg2rad(theta_deg)
    return tv.V3(*(torch.full((n,), c, dtype=torch.float32)
                   for c in (np.sin(t), 0.0, np.cos(t))))


def _grid(n_theta, n_phi, theta_max):
    theta = (np.arange(n_theta) + 0.5) / n_theta * theta_max
    phi = (np.arange(n_phi) + 0.5) / n_phi * 2 * np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)],
                 -1).reshape(-1, 3).astype(np.float32)
    w = (np.sin(t) * (theta_max / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    return T(d), w.astype(np.float32)


def _hemi_grid():
    return _grid(256, 512, np.pi / 2)


def _default(n=1, **kw):
    args = dict(roughness=0.5)
    args.update(kw)
    base = args.pop("base_color", (0.8, 0.4, 0.2))
    return td.make_params(
        tv.V3(*(torch.full((n,), c, dtype=torch.float32) for c in base)),
        **{k: torch.full((n,), float(v)) for k, v in args.items()})


def _uniforms(seed, n):
    u = np.random.default_rng(seed).random((n, 2)).astype(np.float32)
    return torch.tensor(u[:, 0]), torch.tensor(u[:, 1])


def test_diffuse_pdf_is_cosine():
    dirs, w = _hemi_grid()
    pdf = td.pdf_diffuse(_default(), None, dirs).numpy()
    assert abs(float(np.sum(pdf * w)) - 1.0) < 0.01


@pytest.mark.parametrize("roughness,aniso",
                         [(0.3, 0.0), (0.6, 0.0), (0.4, 0.7)])
@pytest.mark.parametrize("theta_deg", [10.0, 45.0, 75.0])
def test_specular_pdf_integrates_to_one(roughness, aniso, theta_deg):
    """With clearcoat 0 the mixture pdf is the GTR2-aniso VNDF alone and
    integrates to 1 over the reflected directions (the full sphere: they
    can go below the horizon at grazing views)."""
    p = _default(roughness=roughness, anisotropic=aniso)
    dirs, w = _grid(512, 512, np.pi)
    pdf = td.pdf_specular(p, _view(theta_deg), dirs).numpy()
    total = float(np.sum(pdf.astype(np.float64) * w))
    assert abs(total - 1.0) < 0.03, total


@pytest.mark.parametrize("theta_deg", [20.0, 60.0])
def test_specular_mc_consistency(theta_deg):
    """A Monte Carlo estimate of the specular integral with the mixture
    sampler matches quadrature (clearcoat 0: sampler and pdf agree)."""
    p = _default(roughness=0.45, specular=1.0, metallic=0.5)
    dirs, w = _hemi_grid()
    ref = (td.eval_specular_cos(p, _view(theta_deg), dirs).aos().numpy()
           * w[:, None]).sum(0)
    n = 400000
    rx, ry = _uniforms(7, n)
    wo = _view(theta_deg, n)
    wi = td.sample_specular(p, wo, rx, ry)
    pdf = td.pdf_specular(p, wo, wi)
    f = td.eval_specular_cos(p, wo, wi).aos()
    valid = (wi.z > 0) & (pdf > 1e-7) & (tv.dot(wi, wi) > 0.5)
    est = torch.where(valid[:, None], f / pdf[:, None], 0.0).mean(0).numpy()
    np.testing.assert_allclose(est, ref, rtol=0.05, atol=5e-3)


def test_diffuse_mc_consistency():
    p = _default(roughness=0.7, subsurface=0.5)
    dirs, w = _hemi_grid()
    ref = (td.eval_diffuse_cos(p, _view(40.0), dirs).aos().numpy()
           * w[:, None]).sum(0)
    n = 200000
    rx, ry = _uniforms(8, n)
    wo = _view(40.0, n)
    wi = td.sample_diffuse(p, wo, rx, ry)
    pdf = td.pdf_diffuse(p, wo, wi)
    est = (td.eval_diffuse_cos(p, wo, wi).aos() / pdf[:, None]).mean(0)
    np.testing.assert_allclose(est.numpy(), ref, rtol=0.03, atol=1e-3)


def test_diffuse_energy_bound():
    dirs, w = _hemi_grid()
    for rough in (0.0, 0.5, 1.0):
        for ss in (0.0, 1.0):
            p = _default(base_color=(1.0, 1.0, 1.0), roughness=rough,
                         subsurface=ss)
            for theta in (5.0, 45.0, 80.0):
                f = td.eval_diffuse_cos(p, _view(theta), dirs).x.numpy()
                albedo = float(np.sum(f * w))
                # the Hanrahan-Krueger flat-SSS term gains energy at
                # grazing angles; a loose bound as a sanity check
                assert albedo < 2.0, (rough, ss, theta, albedo)


def test_metallic_kills_diffuse():
    f = td.eval_diffuse(_default(metallic=1.0), _view(30.0), _view(-20.0))
    assert float(f.aos().abs().max()) == 0.0


def test_specular_f0_remap():
    # metallic 0: F0 = specular * 0.08, white (no tint)
    p = _default(base_color=(0.5, 0.5, 0.5), specular=1.0)
    np.testing.assert_allclose(p.spec_f0.aos().numpy(), 0.08, atol=1e-6)
    # metallic 1: F0 = base_color
    p = _default(base_color=(0.9, 0.6, 0.3), metallic=1.0)
    np.testing.assert_allclose(p.spec_f0.aos().numpy()[0], [0.9, 0.6, 0.3],
                               atol=1e-6)


def test_sheen_adds_grazing_energy():
    wo = _view(80.0)
    d = np.array([-0.9, 0.1, 0.25])
    wi = T((d / np.linalg.norm(d)).astype(np.float32)[None])
    f0 = float(td.eval_specular(_default(sheen=0.0), wo, wi).x)
    f1 = float(td.eval_specular(_default(sheen=1.0), wo, wi).x)
    assert f1 > f0


def test_clearcoat_lobe_positive_and_gtr1_normalized():
    p = _default(clearcoat=1.0, clearcoat_gloss=0.8, roughness=0.3)
    dirs, w = _hemi_grid()
    # GTR1 D integrates to 1 over the hemisphere of half vectors
    d = td.d_gtr1(p, dirs.z * dirs.z).numpy()
    total = float(np.sum(d * dirs.z.numpy() * w))
    assert abs(total - 1.0) < 0.02, total


def test_clearcoat_mixture_keeps_the_reference_bias():
    """The reference's GTR1 sampler draws with the raw roughness^2 while
    the mixture pdf holds the clearcoat alpha (rlDisney.cpp:393-404 against
    :545-551), so with the clearcoat on f/pdf under-estimates the specular
    integral: measured 0.805 of quadrature at roughness 0.5, gloss 0.8, a
    20 degree view (0.996 at clearcoat 0, the control). The port keeps the
    mismatch for parity; this pins it."""
    dirs, w = _grid(1024, 1024, np.pi / 2)
    n = 1000000
    rx, ry = _uniforms(9, n)
    wo = _view(20.0, n)
    ratios = []
    for cc in (1.0, 0.0):
        p = _default(roughness=0.5, clearcoat=cc, clearcoat_gloss=0.8,
                     base_color=(0.6, 0.1, 0.1))
        ref = float((td.eval_specular_cos(p, _view(20.0), dirs).x.double()
                     * torch.tensor(w).double()).sum())
        wi = td.sample_specular(p, wo, rx, ry)
        pdf = td.pdf_specular(p, wo, wi)
        f = td.eval_specular_cos(p, wo, wi).x
        valid = (wi.z > 0) & (pdf > 1e-7) & (tv.dot(wi, wi) > 0.5)
        est = float(torch.where(valid, f / pdf, 0.0).double().mean())
        ratios.append(est / ref)
    assert 0.78 < ratios[0] < 0.83, ratios
    assert abs(ratios[1] - 1.0) < 0.02, ratios
