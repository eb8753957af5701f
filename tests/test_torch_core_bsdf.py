"""Elementwise parity of the port's vector, frame and BSDF code with the
JAX package, at fixed float32 inputs made with numpy.

Tolerances: both sides evaluate the same float32 expressions, but XLA's
transcendentals (sqrt/rsqrt, sin, cos, tan, acos, exp, log) and its fusion
of multiply-adds differ from torch's in the last bits. Measured differences
on these inputs stay below 1e-5 relative; RTOL = 2e-5 and ATOL = 2e-6
(values are O(1)) leave room for that and nothing more. Samplers compare
directions, which can only move by that rounding too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.bsdf import beckmann as jbeck
from rlshaders_tpu.bsdf import ggx as jggx
from rlshaders_tpu.bsdf import orennayar as jon
from rlshaders_tpu.core import frame as jframe
from rlshaders_tpu.core import vec3 as jvec3
from rlshaders_tpu.models import dispatch as jdispatch
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch.bsdf import beckmann as tbeck
from rlshaders_tpu_torch.bsdf import ggx as tggx
from rlshaders_tpu_torch.bsdf import orennayar as ton
from rlshaders_tpu_torch.core import frame as tframe
from rlshaders_tpu_torch.core import vec3 as tvec3
from rlshaders_tpu_torch.models import dispatch as tdispatch
from rlshaders_tpu_torch.scene import build as tbuild

RTOL = 2e-5
ATOL = 2e-6
N = 4096
# Ill-conditioned outputs: the VNDF sampler near its degenerate branch and
# the near-mirror GGX lobes (alpha 2.5e-3) amplify one ulp of the half
# vector by about 1/alpha. For those, every element is held to 1e-3
# relative and 99% of them to RTOL/ATOL (measured: 99.4%).
LOOSE_RTOL = 1e-3
LOOSE_ATOL = 1e-4
TIGHT_SHARE = 0.99


def _dirs(seed, n=N, upper=True):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if upper:
        d[:, 2] = np.abs(d[:, 2])
    return d


def _uni(seed, n=N):
    return np.random.default_rng(seed).random(n).astype(np.float32)


def J(a):
    return jvec3.v3(jnp.asarray(a))


def T(a):
    return tvec3.v3(torch.tensor(a))


def close(t, j, rtol=RTOL, atol=ATOL):
    if isinstance(t, tvec3.V3):
        t, j = t.aos(), j.aos()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def close_conditioned(t, j):
    if isinstance(t, tvec3.V3):
        t, j = t.aos(), j.aos()
    a, b = t.numpy(), np.asarray(j)
    np.testing.assert_allclose(a, b, rtol=LOOSE_RTOL, atol=LOOSE_ATOL)
    tight = np.abs(a - b) <= ATOL + RTOL * np.abs(b)
    assert tight.mean() >= TIGHT_SHARE, tight.mean()


def test_vec3_ops():
    a, b = _dirs(1, upper=False) * 3.0, _dirs(2, upper=False)
    close(tvec3.normalize(T(a)), jvec3.normalize(J(a)))
    close(tvec3.cross(T(a), T(b)), jvec3.cross(J(a), J(b)))
    close(tvec3.dot(T(a), T(b)), jvec3.dot(J(a), J(b)))
    close(tvec3.reflect(T(a), T(b)), jvec3.reflect(J(a), J(b)))
    close(tvec3.kmean(tvec3.tile(T(a), 3) * T(np.tile(b, (3, 1))), 3),
          jvec3.kmean(jvec3.tile(J(a), 3) * J(np.tile(b, (3, 1))), 3))


def test_frames():
    n = _dirs(3, upper=False)
    n[:8] = [[0, 0, 1], [0, 0, -1], [1e-8, 0, 1], [1, 0, 0], [0, 1, 0],
             [0, -1, 0], [-1, 0, 0], [0.6, 0.8, 0]]
    w = _dirs(4, upper=False)
    tf = tframe.build_frame_polar_v(T(n))
    jf = jframe.build_frame_polar_v(J(n))
    for a, b in zip(tf, jf):
        close(a, b)
    close(tframe.to_local_v(tf, T(w)), jframe.to_local_v(jf, J(w)))
    close(tframe.to_world_v(tf, T(w)), jframe.to_world_v(jf, J(w)))


def _ggx_params(seed, entering=True):
    rs = np.random.default_rng(seed)
    rough = rs.uniform(0.0, 1.0, N).astype(np.float32)
    ior = rs.uniform(0.3, 2.5, N).astype(np.float32)
    aniso = rs.uniform(0.0, 1.0, N).astype(np.float32)
    ent = rs.random(N) < 0.5 if entering is None else np.full(N, entering)
    tp = tggx.make_params(torch.tensor(rough), torch.tensor(ior),
                          torch.tensor(aniso), torch.tensor(ent))
    jp = jggx.make_params(jvec3.V3(1.0, 1.0, 1.0), jnp.asarray(rough),
                          jnp.asarray(ior), jnp.asarray(aniso),
                          jnp.asarray(ent))
    return tp, jp


def test_ggx_reflection_path():
    tp, jp = _ggx_params(5, entering=None)
    for f in tggx.GGXParams._fields:
        close(getattr(tp, f), getattr(jp, f))
    wo, wi = _dirs(6), _dirs(7, upper=False)
    rx, ry = _uni(8), _uni(9)
    m = tggx.sample_vndf(T(wo), tp.alpha_x, tp.alpha_y, torch.tensor(rx),
                         torch.tensor(ry))
    jm = jggx.sample_vndf(J(wo), jp.alpha_x, jp.alpha_y, jnp.asarray(rx),
                          jnp.asarray(ry))
    close_conditioned(m, jm)
    close(tggx.d_ggx_aniso(T(wo), tp.alpha_x, tp.alpha_y),
          jggx.d_ggx_aniso(J(wo), jp.alpha_x, jp.alpha_y), rtol=1e-4)
    close(tggx.smith_g1(T(wi), T(wo), tp.alpha_g),
          jggx.smith_g1(J(wi), J(wo), jp.alpha_g))
    close(tggx.smith_g1_aniso(T(wi), T(wo), tp.alpha_x, tp.alpha_y),
          jggx.smith_g1_aniso(J(wi), J(wo), jp.alpha_x, jp.alpha_y))
    close(tggx.fresnel_dielectric(T(wi), T(wo), tp.ior_in, tp.ior_out),
          jggx.fresnel_dielectric(J(wi), J(wo), jp.ior_in, jp.ior_out))
    f_t, gd_t = tggx.reflection_parts(tp, T(wo), T(wi))
    f_j, gd_j = jggx.reflection_parts(jp, J(wo), J(wi))
    close(f_t, f_j)
    close(gd_t, gd_j, rtol=1e-4, atol=1e-5)
    close(tggx.reflection_term(tp, T(wo), T(wi)),
          jggx.reflection_term(jp, J(wo), J(wi)), rtol=1e-4, atol=1e-5)
    close(tggx.pdf(tp, T(wo), T(wi)), jggx.pdf(jp, J(wo), J(wi)), rtol=1e-4)
    wi_t, fw_t = tggx.sample(tp, T(wo), torch.tensor(rx), torch.tensor(ry))
    wi_j, fw_j = jggx.sample(jp, J(wo), jnp.asarray(rx), jnp.asarray(ry))
    close_conditioned(wi_t, wi_j)
    close_conditioned(fw_t, fw_j)


@pytest.mark.parametrize("sigma", [0.0, 0.35, 1.0])
def test_orennayar(sigma):
    wo, wi = _dirs(10, upper=False), _dirs(11, upper=False)
    r = np.full(N, sigma, np.float32)
    close(ton.eval_brdf(torch.tensor(r), T(wo), T(wi)),
          jon.eval_brdf(jon.make_params(jnp.asarray(r)), J(wo), J(wi)),
          rtol=1e-4, atol=1e-5)
    rx, ry = _uni(12), _uni(13)
    rx[:2], ry[:2] = 0.5, 0.5
    close(ton.sample_v(torch.tensor(rx), torch.tensor(ry)),
          jon.sample_v(None, None, jnp.asarray(rx), jnp.asarray(ry)))


def test_beckmann():
    wo, wi = _dirs(14), _dirs(15, upper=False)
    alpha = np.random.default_rng(16).uniform(0.01, 1.0, N).astype(np.float32)
    ta, ja = torch.tensor(alpha), jnp.asarray(alpha)
    close(tbeck.d_beckmann(T(wo), ta), jbeck.d_beckmann(J(wo), ja),
          rtol=1e-4, atol=1e-5)
    close(tbeck.g1(T(wi), T(wo), ta), jbeck.g1(J(wi), J(wo), ja))
    close(tbeck.gd(T(wo), T(wi), ta), jbeck.gd(J(wo), J(wi), ja),
          rtol=1e-4, atol=1e-5)
    close(tbeck.pdf(T(wo), T(wi), ta), jbeck.pdf(J(wo), J(wi), ja),
          rtol=1e-4, atol=1e-5)
    rx, ry = _uni(17), _uni(18)
    close(tbeck.sample(T(wo), ta, torch.tensor(rx), torch.tensor(ry)),
          jbeck.sample(J(wo), ja, jnp.asarray(rx), jnp.asarray(ry)),
          rtol=1e-4, atol=1e-5)


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
 name ggx_a
 Kd 0.4
 KdColor 0.7 0.3 0.2
 Ks 0.6
 KsColor 1 0.8 0.6
 specularRoughness 0.3
 anisotropic 0.5
 diffuseRoughness 0.4
 ior 1.5
}
rlGgx
{
 name ggx_b
 Kd 0
 Ks 1
 specularRoughness 0.05
 ior 0.47
}
standard
{
 name std_ct
 Kd 0.8
 Kd_color 0.6 0.6 0.6
 Ks 0.3
 specular_roughness 0.2
 diffuse_roughness 1
}
standard
{
 name std_ggx
 Kd 0.5
 Ks 0.5
 Ks_color 0.9 0.9 1
 specular_brdf "ggx"
 specular_Fresnel on
 Ksn 0.3
 specular_roughness 0.4
 emission 0.5
 emission_color 1 0.5 0.25
}
"""


def _mesh(i, shader):
    return f"""
polymesh
{{
 name m{i}
 nsides 1 1 UINT
3
 vidxs 3 1 UINT
0 1 2
 vlist 3 1 POINT
{i} 0 0 {i + 1} 0 0 {i} 1 0
 shader "{shader}"
}}
"""


@pytest.fixture(scope="module")
def materials(tmp_path_factory):
    text = MATERIALS_ASS + "".join(
        _mesh(i, s) for i, s in enumerate(["ggx_a", "ggx_b", "std_ct",
                                           "std_ggx"]))
    path = str(tmp_path_factory.mktemp("mats") / "mats.ass")
    with open(path, "w") as f:
        f.write(text)
    return jbuild.build(path), tbuild.build(path, "cpu")


@pytest.mark.parametrize("diffuse_ray", [False, True])
def test_dispatch_lobes(materials, diffuse_ray):
    js, ts = materials
    rs = np.random.default_rng(20)
    mat_id = rs.integers(0, 4, N).astype(np.int32)
    entering = rs.random(N) < 0.7
    jm = jdispatch.gather(
        js.materials, js.textures, jnp.asarray(mat_id),
        jnp.zeros((N, 2)), jnp.asarray(entering),
        p=jnp.zeros((N, 3)), fp=jnp.zeros(N), fp_uv=jnp.zeros(N),
        lod_bias=-0.5, tex_gamma=1.0, diffuse_ray=diffuse_ray)
    tm = tdispatch.gather(ts.materials, torch.tensor(mat_id),
                          torch.tensor(entering), diffuse_ray=diffuse_ray)
    for f in ("diffuse_color", "spec_weight", "emission"):
        close(getattr(tm, f), getattr(jm, f))
    for f in ("has_diffuse", "has_spec", "mtype", "spec_dist",
              "spec_fresnel_mode"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    wo, wi = T(_dirs(21)), T(_dirs(22, upper=False))
    jwo, jwi = J(_dirs(21)), J(_dirs(22, upper=False))
    rx, ry = _uni(23), _uni(24)
    for t_fn, j_fn in ((tdispatch.eval_diffuse, jdispatch.eval_diffuse),
                       (tdispatch.eval_specular, jdispatch.eval_specular)):
        (tf, tpdf), (jf, jpdf) = t_fn(tm, wo, wi), j_fn(jm, jwo, jwi)
        close_conditioned(tf, jf)
        close_conditioned(tpdf, jpdf)
    close(tdispatch.sample_diffuse(tm, wo, torch.tensor(rx),
                                   torch.tensor(ry)),
          jdispatch.sample_diffuse(jm, jwo, jnp.asarray(rx), jnp.asarray(ry)))
    close_conditioned(
        tdispatch.sample_specular(tm, wo, torch.tensor(rx), torch.tensor(ry)),
        jdispatch.sample_specular(jm, jwo, jnp.asarray(rx), jnp.asarray(ry)))
    tk = tdispatch.tile_v(tm, 3)
    jk = jdispatch.tile_v(jm, 3)
    close(tk.ggx.alpha_x, jk.ggx.alpha_x)
    close(tk.diffuse_color, jk.diffuse_color)
