"""The port's disk lights against the JAX package: the flat, row and
batched samplers and intersectors of integrator/lights.py, the build's
DiskLights (the matrix's scale or the radius, and the placeholder row of a
scene without one), and the disk columns of the SSS stage's probe-hit
lighting (sss._lambert_direct) on scenes/skin_closeup.ass with two disk
lights added; inputs made with numpy from a seed.

Tolerances: RTOL 2e-5 / ATOL 2e-6, the other elementwise modules'
(measured: every compared value above 1e-3 within 1.7e-5 relative); hit
masks and the tables equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.core import rng as jrng
from rlshaders_tpu.core import vec3 as jv
from rlshaders_tpu.integrator import lights as jlights
from rlshaders_tpu.integrator import sss as jsss
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.core import rng as trng
from rlshaders_tpu_torch.core import vec3 as tv
from rlshaders_tpu_torch.integrator import lights as tlights
from rlshaders_tpu_torch.integrator import sss as tsss
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene import build as tbuild

cpu_math.settle()

N = 4096
RTOL = 2e-5
ATOL = 2e-6
SKIN = "scenes/skin_closeup.ass"

# a disk lighting the sheet from above with a scaled matrix (radius
# mirrored), and one with a unit matrix and a radius that lights diffuse
# only
DISKS = """disk_light
{
 name d_scaled
 radius 0.6
 matrix
 0.6 0 0 0
 0 0 -0.6 0
 0 0.6 0 0
 0.8 1.5 0.3 1
 color 1 0.9 0.8
 intensity 6
 samples 2
 normalize on
}
disk_light
{
 name d_unit
 radius 0.4
 matrix
 1 0 0 0
 0 0 -1 0
 0 1 0 0
 -0.5 1.2 -0.4 1
 intensity 3
 samples 3
 affect_specular off
}
"""


def _np(x):
    if isinstance(x, tv.V3):
        return x.aos().numpy()
    if isinstance(x, jv.V3):
        return np.asarray(x.aos())
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(t, j):
    np.testing.assert_allclose(_np(t), _np(j), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def skin_disk(tmp_path_factory):
    """(JAX scene, its DeviceScene and SceneStatic, the port's
    TileRenderer over the same tables) of the skin close-up with DISKS."""
    path = tmp_path_factory.mktemp("disk") / "skin_disk.ass"
    path.write_text(open(SKIN).read() + DISKS)
    js = jbuild.build(str(path))
    ja = jtrace.build(js.geometry)
    ts, ta = interop.scene_from_numpy(interop.scene_tables(js, ja), "cpu")
    return (js, jwave.device_scene(js, ja), jwave.SceneStatic.of(js),
            twave.TileRenderer(ts, ta, 1))


def _points(seed, n=N):
    rs = np.random.default_rng(seed)
    p = rs.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    u = rs.random((n, 2)).astype(np.float32)
    u[:8] = [[0, 0], [1, 0], [0.5, 0.5], [1, 1], [0, 1], [0.25, 0.999],
             [1e-7, 0.3], [0.999999, 0.75]]
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 1] = np.abs(d[: n // 2, 1]) + 2.0  # up, toward the lights
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, u, d


@pytest.mark.parametrize("li", [0, 1])
def test_flat_forms(skin_disk, li):
    js, _, _, tr = skin_disk
    jd, td = js.disk_lights, tr.sc.disk_lights
    p, u, d = _points(1 + li)
    a = tlights.sample_disk_flat(
        td.center[li], td.u[li], td.v[li], td.normal[li], td.area[li],
        td.radiance[li], tv.v3(torch.tensor(p)), torch.tensor(u))
    b = jlights.sample_disk_flat(
        jd.center[li], jd.u[li], jd.v[li], jd.normal[li], jd.area[li],
        jd.radiance[li], jv.v3(jnp.asarray(p)), jnp.asarray(u))
    for x, y in zip(a, b):
        close(x, y)
    assert (_np(a.pdf) > 0).mean() > 0.3
    th, tt = tlights.intersect_disk_flat(
        td.center[li], td.u[li], td.v[li], td.normal[li],
        tv.v3(torch.tensor(p)), tv.v3(torch.tensor(d)))
    jh, jt = jlights.intersect_disk_flat(
        jd.center[li], jd.u[li], jd.v[li], jd.normal[li],
        jv.v3(jnp.asarray(p)), jv.v3(jnp.asarray(d)))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.any()
    close(tt, jt)


@pytest.mark.parametrize("li", [0, 1])
def test_row_forms(skin_disk, li):
    js, _, _, tr = skin_disk
    jd, td = js.disk_lights, tr.sc.disk_lights
    p, u, d = _points(3 + li)
    a = tlights.sample_disk(td.center[li], td.u[li], td.v[li], td.normal[li],
                            td.area[li], td.radiance[li], torch.tensor(p),
                            torch.tensor(u[:, 0]), torch.tensor(u[:, 1]))
    b = jlights.sample_disk(jd.center[li], jd.u[li], jd.v[li], jd.normal[li],
                            jd.area[li], jd.radiance[li], jnp.asarray(p),
                            jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))
    for x, y in zip(a, b):
        close(x, y)
    th, tt = tlights.intersect_disk(td.center[li], td.u[li], td.v[li],
                                    td.normal[li], torch.tensor(p),
                                    torch.tensor(d))
    jh, jt = jlights.intersect_disk(jd.center[li], jd.u[li], jd.v[li],
                                    jd.normal[li], jnp.asarray(p),
                                    jnp.asarray(d))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.any()
    close(tt, jt)


def test_batched(skin_disk):
    js, _, _, tr = skin_disk
    jd, td = js.disk_lights, tr.sc.disk_lights
    rs = np.random.default_rng(5)
    p = rs.uniform(-1, 1, (512, 3)).astype(np.float32)
    u = rs.random((512, 3, 4, 2)).astype(np.float32)
    idx = [0, 1, 1]
    a = tlights.sample_disks_batched(
        *(getattr(td, f)[idx] for f in ("center", "u", "v", "normal", "area",
                                        "radiance")), torch.tensor(p),
        torch.tensor(u))
    ji = jnp.asarray(idx)
    b = jlights.sample_disks_batched(
        *(getattr(jd, f)[ji] for f in ("center", "u", "v", "normal", "area",
                                       "radiance")), jnp.asarray(p),
        jnp.asarray(u))
    for x, y in zip(a, b):
        close(x, y)


HEADER = """options
{
 AA_samples 1
 xres 4
 yres 4
 light_gamma 2.2
}
persp_camera
{
 name cam
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 5 1
}
polymesh
{
 name p
 nsides 1 1 UINT
3
 vidxs 3 1 UINT
0 1 2
 vlist 3 1 POINT
0 0 0 1 0 0 0 1 0
 shader "m"
}
standard
{
 name m
}
"""


@pytest.mark.parametrize("disks", [
    DISKS,
    # a unit matrix row within 1e-4 of 1 takes the radius; no radius
    # (0.5 by default); zero intensity (not valid)
    DISKS.replace("1 0 0 0\n 0 0 -1 0", "1.00005 0 0 0\n 0 0 -1 0")
    .replace(" radius 0.4\n", "").replace("intensity 6", "intensity 0"),
    "",
], ids=["scaled-and-radius", "near-unit-no-radius-dark", "none"])
def test_disk_lights_build_as_jax(tmp_path, disks):
    path = tmp_path / "d.ass"
    path.write_text(HEADER + disks)
    jd = jbuild.build(str(path)).disk_lights
    td = tbuild.build(str(path), device="cpu").disk_lights
    for f in td._fields:
        a = np.asarray(getattr(jd, f))
        b = np.asarray(getattr(td, f))
        assert np.array_equal(a.astype(b.dtype), b), f
    if disks == DISKS:
        # the scaled matrix's rows carry the radius, the unit one takes it
        assert np.allclose(np.linalg.norm(np.asarray(td.u), axis=1),
                           [0.6, 0.4])
        assert td.affect_specular == (True, False)
        assert np.allclose(np.asarray(td.area), np.pi * np.array([0.36,
                                                                  0.16]))
    elif not disks:
        assert td.valid == (False,)


def _sheet_points(rs, n):
    x = rs.uniform(-1, 1, n)
    z = rs.uniform(-0.5, 0.5, n)
    y = 0.18 * np.cos(x * np.pi / 2) + rs.uniform(0, 0.02, n)
    p = np.stack([x, y, z], 1).astype(np.float32)
    nrm = np.stack([0.3 * x, np.ones(n), np.zeros(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ex = np.where(rs.random(n) < 0.5, rs.integers(0, 16, n), -1)
    return p, nrm.astype(np.float32), ex.astype(np.int32)


@pytest.mark.parametrize("sobol,cam_budget", [(False, False), (True, False),
                                              (True, True)])
def test_lambert_direct_disk_columns(skin_disk, sobol, cam_budget):
    """The probe-hit lighting with the quad light, both disks and the
    dome: per-light area samples (the camera budget: 3x3, 2x2 and 3x3) and
    the cosine sample's analytic pickup of every emitter."""
    _, jsc, jstatic, tr = skin_disk
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
    # the light columns in one any-hit query (quad 9 or 1, disks 4 + 9 or
    # 1 + 1, the dome 1), then the cosine sample's emitter and dome
    k = (9 + 4 + 9 if cam_budget else 3) + 1
    assert tr.stats["shadow_calls"] - before["shadow_calls"] == 3
    assert tr.stats["shadow_rays"] - before["shadow_rays"] == (k + 2) * n
    # the disks matter: without them the values drop
    off = tr.static._replace(disk_valid=(False, False))
    c = tsss._lambert_direct(
        tr.sc, off, torch.tensor(p), torch.tensor(nrm), torch.tensor(ex),
        tkey, sq=tsq, cam_budget=cam_budget).numpy()
    assert c.sum() < 0.95 * a.sum()
