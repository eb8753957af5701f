"""The GGX debug surface of the port (`sample_slope`, `sample_ndf`,
`ndf_pdf`, `eval_brdf`, `fresnel_avg_normal`) against the JAX package's at
fixed float32 inputs, with tests/test_torch_core_bsdf.py's tolerances; the
property tests of tests/test_ggx.py on the port; and `utils/sample_writer`
and `cli patterns` against the JAX package's.

Pattern files: the radiance half is held to the JAX file within one
half-float spacing at the value plus the GGX tolerance (RTOL x value +
ATOL). The scatter half draws the JAX package's uniforms bit for bit, so
its samples land in the same bins but where a direction lies within float
rounding of a bin edge: such a sample may light the neighbouring pixel.
The test counts them (at most 2 of 2 x 300 samples, measured 0) and holds
every other pixel equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu import cli as jcli
from rlshaders_tpu.bsdf import ggx as jggx
from rlshaders_tpu.core import rng as jrng
from rlshaders_tpu.utils import sample_writer as jsw
from test_torch_core_bsdf import (ATOL, RTOL, J, T, _dirs, _ggx_params,
                                  _uni, close, close_conditioned)
from rlshaders_tpu_torch import cli as tcli
from rlshaders_tpu_torch.bsdf import ggx as tggx
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.core import rng as trng
from rlshaders_tpu_torch.core import vec3 as tvec3
from rlshaders_tpu_torch.core.vec3 import V3
from rlshaders_tpu_torch.io import exr
from rlshaders_tpu_torch.utils import sample_writer as tsw

cpu_math.settle()

N = 4096


def test_sample_slope_matches_jax():
    theta = np.random.default_rng(20).uniform(0.0, 1.6, N).astype(np.float32)
    theta[:4] = [0.0, 5e-5, np.pi / 2, 1.6]
    rx, ry = _uni(21), _uni(22)
    ts = tggx.sample_slope(torch.tensor(theta), torch.tensor(rx),
                           torch.tensor(ry))
    js = jggx.sample_slope(jnp.asarray(theta), jnp.asarray(rx),
                           jnp.asarray(ry))
    for a, b in zip(ts, js):
        close_conditioned(a, b)


def test_sample_ndf_and_pdf_match_jax():
    tp, jp = _ggx_params(23)
    rx, ry = _uni(24), _uni(25)
    m_t = tggx.sample_ndf(tp.alpha_x, tp.alpha_y, torch.tensor(rx),
                          torch.tensor(ry))
    m_j = jggx.sample_ndf(jp.alpha_x, jp.alpha_y, jnp.asarray(rx),
                          jnp.asarray(ry))
    close_conditioned(m_t.aos(), m_j)
    wo = _dirs(26)
    m = np.asarray(m_j)
    close(tggx.ndf_pdf(tp, T(wo), T(m)), jggx.ndf_pdf(jp, J(wo), J(m)),
          rtol=1e-4)


def test_eval_brdf_and_fresnel_avg_normal_match_jax():
    rs = np.random.default_rng(27)
    color = rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    rough = rs.uniform(0.0, 1.0, N).astype(np.float32)
    ior = rs.uniform(0.3, 2.5, N).astype(np.float32)
    ent = rs.random(N) < 0.5
    tp = tggx.make_params(torch.tensor(rough), torch.tensor(ior),
                          torch.zeros(N), torch.tensor(ent))
    jp = jggx.make_params(J(color), jnp.asarray(rough), jnp.asarray(ior),
                          0.0, jnp.asarray(ent))
    wo, wi = _dirs(28), _dirs(29, upper=False)
    wi[:16] = 0.0                       # invalid directions give 0
    close(tggx.eval_brdf(tp, T(wo), T(wi), T(color)),
          jggx.eval_brdf(jp, J(wo), J(wi)), rtol=1e-4, atol=1e-5)
    assert float(tggx.eval_brdf(tp, T(wo), T(wi), T(color)).aos()[:16]
                 .abs().max()) == 0.0
    close(tggx.fresnel_avg_normal(tp), jggx.fresnel_avg_normal(jp))


# ---- tests/test_ggx.py's properties, on the port ----

def _params(rough, ior=1.5, aniso=0.0, entering=True):
    return tggx.make_params(torch.tensor(rough), torch.tensor(ior),
                            torch.tensor(aniso), torch.tensor(entering))


def _sphere_grid(n_theta=256, n_phi=512, hemisphere=False):
    top = np.pi / 2 if hemisphere else np.pi
    theta = (np.arange(n_theta) + 0.5) / n_theta * top
    phi = (np.arange(n_phi) + 0.5) / n_phi * 2 * np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)],
                 axis=-1).reshape(-1, 3)
    w = (np.sin(t) * (top / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    return T(d.astype(np.float32)), torch.tensor(w, dtype=torch.float32)


def _view(theta_deg, n):
    t = np.deg2rad(theta_deg)
    return V3(*(torch.full((n,), c, dtype=torch.float32)
                for c in (np.sin(t), 0.0, np.cos(t))))


def _draws(seed, n):
    u = trng.uniform(trng.stream(seed), (n, 2))
    return u[:, 0], u[:, 1]


@pytest.mark.parametrize("roughness,aniso", [(0.2, 0.0), (0.35, 0.0),
                                             (0.7, 0.0), (0.4, 0.8)])
@pytest.mark.parametrize("theta_deg", [5.0, 45.0, 80.0])
def test_vndf_pdf_integrates_to_one(roughness, aniso, theta_deg):
    p = _params(roughness, aniso=aniso)
    dirs, w = _sphere_grid()
    wo = _view(theta_deg, w.shape[0])
    h = tvec3.normalize(dirs + wo)
    total = float((tggx.vndf_pdf(p, wo, h) * w).sum())
    assert abs(total - 1.0) < 0.02, total


@pytest.mark.parametrize("roughness,theta_deg", [(0.35, 30.0), (0.6, 60.0)])
def test_vndf_sample_pdf_chi2_consistency(roughness, theta_deg):
    p = _params(roughness)
    n = 400000
    rx, ry = _draws(4, n)
    wi, _ = tggx.sample(p, _view(theta_deg, n), rx, ry)
    wi = wi.aos().numpy()
    nt, npph = 16, 32
    theta = np.arccos(np.clip(wi[:, 2], -1, 1))
    phi = np.mod(np.arctan2(wi[:, 1], wi[:, 0]), 2 * np.pi)
    it = np.minimum((theta / (np.pi / 2) * nt).astype(int), nt)
    ip = np.minimum((phi / (2 * np.pi) * npph).astype(int), npph - 1)
    counts = np.zeros((nt + 1, npph))
    np.add.at(counts, (it, ip), 1.0)
    counts = counts[:nt] / n

    sub = 4
    exp = np.zeros((nt, npph))
    for dt in range(sub):
        for dp in range(sub):
            t = (np.arange(nt)[:, None] + (dt + 0.5) / sub) / nt * (np.pi / 2)
            ph = ((np.arange(npph)[None, :] + (dp + 0.5) / sub) / npph
                  * 2 * np.pi)
            d = np.stack([np.sin(t) * np.cos(ph), np.sin(t) * np.sin(ph),
                          np.cos(t) * np.ones_like(ph)], axis=-1)
            d = T(d.reshape(-1, 3).astype(np.float32))
            wo = _view(theta_deg, nt * npph)
            pdf = tggx.vndf_pdf(p, wo, tvec3.normalize(d + wo)).numpy()
            dw = np.sin(t) * (np.pi / 2 / nt / sub) * (2 * np.pi / npph / sub)
            exp += pdf.reshape(nt, npph) * dw
    mask = exp > 1e-3
    rel = np.abs(counts[mask] - exp[mask]) / exp[mask]
    assert np.quantile(rel, 0.9) < 0.15, np.quantile(rel, 0.9)


WHITE = V3(torch.tensor(1.0), torch.tensor(1.0), torch.tensor(1.0))


@pytest.mark.parametrize("roughness,theta_deg", [(0.2, 30.0), (0.5, 55.0)])
def test_mc_estimate_matches_quadrature(roughness, theta_deg):
    p = _params(roughness)
    dirs, w = _sphere_grid(hemisphere=True)
    f = tggx.eval_brdf(p, _view(theta_deg, w.shape[0]), dirs, WHITE).x
    ref = float((f * w).sum())
    n = 200000
    rx, ry = _draws(5, n)
    wo = _view(theta_deg, n)
    wi, _ = tggx.sample(p, wo, rx, ry)
    pdf = tggx.pdf(p, wo, wi)
    fs = tggx.eval_brdf(p, wo, wi, WHITE).x
    est = float(torch.where(wi.z > 0, fs / pdf, 0.0).mean())
    assert abs(est - ref) / max(ref, 1e-6) < 0.03


def test_energy_conservation_white_furnace_bound():
    dirs, w = _sphere_grid(hemisphere=True)
    for roughness in (0.1, 0.4, 0.9):
        for theta in (10.0, 45.0, 80.0):
            f = tggx.eval_brdf(_params(roughness), _view(theta, w.shape[0]),
                               dirs, WHITE).x
            albedo = float((f * w).sum())
            assert albedo <= 1.0 + 1e-3, (roughness, theta, albedo)


def test_ndf_kernel_pdf_integrates():
    p = _params(0.4)
    dirs, w = _sphere_grid()
    wo = _view(35.0, w.shape[0])
    total = float((tggx.ndf_pdf(p, wo, tvec3.normalize(dirs + wo)) * w).sum())
    assert abs(total - 1.0) < 0.03, total


# ---- sample_writer and cli patterns ----

def _radiance_close(a, b):
    spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(
        np.float16)).astype(np.float64)
    err = np.abs(a.astype(np.float64) - b)
    assert (err <= spacing + RTOL * np.abs(b) + ATOL).all(), err.max()


def _scatter_moved(a, b):
    """Samples whose pixel moved between the two scatters: pixels lit in
    one and not in the other, over two."""
    return (int((a != b).any(-1).sum()) + 1) // 2


def test_sample_writer_matches_jax():
    rough, count = 0.3, 3000
    tp = _params(rough)
    jp = jggx.make_params(jnp.ones(3), rough, 1.5)
    t = np.deg2rad(50.0)
    wo_np = np.asarray([np.sin(t), 0.0, np.cos(t)], np.float32)
    wo = V3(*(torch.tensor(c) for c in wo_np))
    rad = jsw.radiance_map(lambda o, i: jggx.eval_brdf(jp, o, i),
                           jnp.asarray(wo_np), 64, 32)
    mine = tsw.radiance_map(lambda o, i: tggx.eval_brdf(tp, o, i, WHITE), wo,
                            64, 32)
    np.testing.assert_allclose(mine, rad, rtol=1e-4, atol=1e-5)
    img_j, miss_j = jsw.sample_scatter(
        lambda o, x, y: jggx.sample(jp, o, x, y)[0], jnp.asarray(wo_np),
        count, 64, 32, seed=9)
    img_t, miss_t = tsw.sample_scatter(
        lambda o, x, y: tggx.sample(tp, o, x, y)[0], wo, count, 64, 32,
        seed=9)
    assert miss_t == miss_j
    assert _scatter_moved(img_t, img_j) == 0
    u_j = np.asarray(jax.random.uniform(jrng.stream(9), (count, 2)))
    u_t = trng.uniform(trng.stream(9), (count, 2)).numpy()
    np.testing.assert_array_equal(u_t, u_j)


def test_patterns_match_jax(tmp_path):
    args = ["--steps", "2", "--count", "300", "--theta", "40"]
    assert jcli.main(["patterns", "--outdir", str(tmp_path / "j")]
                     + args) == 0
    assert tcli.main(["patterns", "--outdir", str(tmp_path / "t"),
                      "--device", "cpu"] + args) == 0
    moved = 0
    for i in range(2):
        name = f"ggx_is.roughness.{i:04d}.exr"
        a = exr.read_rgb(str(tmp_path / "t" / name))
        b = exr.read_rgb(str(tmp_path / "j" / name))
        assert a.shape == b.shape == (512, 512, 3)
        _radiance_close(a[:256], b[:256])
        moved += _scatter_moved(a[256:], b[256:])
        assert a[256:].sum() > 0
    assert moved <= 2, moved
