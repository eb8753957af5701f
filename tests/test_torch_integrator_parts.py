"""Parity of the port's camera, light samplers and splat with the JAX
package, on fixed inputs made with numpy.

Tolerances: the camera and lights evaluate the same float32 expressions
as the JAX code, but transcendentals and multiply-add fusion differ in the
last bits between XLA and torch: RTOL 2e-5, ATOL 2e-6 (values are O(1);
light pdfs, which scale with distance squared, are compared relatively).
The splat sums each pixel's taps in another order: 1e-5 relative.
Subpixel positions differ by one ulp where XLA divides by the AA count
through its reciprocal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.core import vec3 as jvec3
from rlshaders_tpu.integrator import camera as jcam
from rlshaders_tpu.integrator import lights as jlights
from rlshaders_tpu.integrator import splat as jsplat
from rlshaders_tpu.scene.build import Camera as JCamera
from rlshaders_tpu_torch.core import rng as trng
from rlshaders_tpu_torch.core import vec3 as tvec3
from rlshaders_tpu_torch.integrator import camera as tcam
from rlshaders_tpu_torch.integrator import lights as tlights
from rlshaders_tpu_torch.integrator import splat as tsplat
from rlshaders_tpu_torch.scene.build import Camera as TCamera

RTOL = 2e-5
ATOL = 2e-6
C2W = np.array([[1, 0, 0, 0], [0, 0.7071, -0.7071, 0],
                [0, 0.7071, 0.7071, 0], [0, 2.5, 2.5, 1]], np.float32)


def close(t, j, rtol=RTOL, atol=ATOL):
    if isinstance(t, tvec3.V3):
        t, j = t.aos(), j.aos()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("aperture,aa", [(0.0, 2), (0.15, 3)])
def test_camera_generate(aperture, aa):
    xres, yres = 12, 8
    jc = JCamera(c2w=jnp.asarray(C2W), fov_deg=45.0, focus_distance=3.0,
                 aperture_size=aperture, xres=xres, yres=yres)
    tc = TCamera(c2w=torch.tensor(C2W), fov_deg=45.0, focus_distance=3.0,
                 aperture_size=aperture, xres=xres, yres=yres)
    jr = jcam.generate(jc, jax.random.fold_in(jax.random.PRNGKey(100), 77),
                       aa, 2.0, xres, yres)
    tr = tcam.generate(tc, trng.fold(trng.PRNGKey(100), 77), aa, xres, yres)
    close(tr.origin, jr.origin)
    close(tr.direction, jr.direction)
    np.testing.assert_array_equal(tr.pixel.numpy(), np.asarray(jr.pixel))
    # XLA divides by the constant aa through its reciprocal: 1 ulp
    close(tr.sub_xy, jr.sub_xy, rtol=2.5e-7, atol=0.0)


def _points(seed, n=2048):
    rs = np.random.default_rng(seed)
    p = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    p[:, 1] = rs.uniform(-1, 5, n)  # both sides of the light at y = 3
    return p


@pytest.mark.parametrize("flip", [False, True])
def test_quad_light_sample_and_hit(flip):
    verts = np.array([[-1, 3, 1], [1, 3, 1], [1, 3, -1], [-1, 3, -1]],
                     np.float32)
    if flip:
        verts = verts[::-1].copy()
    e1, e2 = verts[1] - verts[0], verts[3] - verts[0]
    nrm = np.cross(e1, e2)
    area = np.float32(np.linalg.norm(nrm))
    nrm = (nrm / area).astype(np.float32)
    rad = np.array([2.0, 1.5, 1.0], np.float32)
    p = _points(1)
    u = np.random.default_rng(2).random((p.shape[0], 2)).astype(np.float32)
    tl = tlights.sample_quad_flat(torch.tensor(verts), torch.tensor(nrm),
                                  torch.tensor(area), torch.tensor(rad),
                                  tvec3.v3(torch.tensor(p)), torch.tensor(u))
    jl = jlights.sample_quad_flat(jnp.asarray(verts), jnp.asarray(nrm),
                                  jnp.asarray(area), jnp.asarray(rad),
                                  jvec3.v3(jnp.asarray(p)), jnp.asarray(u))
    close(tl.direction, jl.direction)
    close(tl.dist, jl.dist)
    close(tl.radiance, jl.radiance)
    close(tl.pdf, jl.pdf, atol=0.0)
    assert (tl.pdf > 0).any() and (tl.pdf == 0).any()

    d = np.random.default_rng(3).normal(size=p.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    th, tt = tlights.intersect_quad_flat(torch.tensor(verts),
                                         torch.tensor(nrm),
                                         tvec3.v3(torch.tensor(p)),
                                         tvec3.v3(torch.tensor(d)))
    jh, jt = jlights.intersect_quad_flat(jnp.asarray(verts), jnp.asarray(nrm),
                                         jvec3.v3(jnp.asarray(p)),
                                         jvec3.v3(jnp.asarray(d)))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    hit = th.numpy()
    assert hit.any()
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=RTOL, atol=ATOL)


def test_sky_sampler_pdf_and_mis():
    n = np.random.default_rng(4).normal(size=(2048, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u = np.random.default_rng(5).random((2048, 2)).astype(np.float32)
    rad = np.array([0.16, 0.2, 0.28], np.float32)
    ts = tlights.sample_sky_flat(torch.tensor(rad), tvec3.v3(torch.tensor(n)),
                                 torch.tensor(u))
    js = jlights.sample_sky_flat(jnp.asarray(rad), jvec3.v3(jnp.asarray(n)),
                                 jnp.asarray(u))
    close(ts.direction, js.direction)
    close(ts.pdf, js.pdf)
    close(ts.radiance, js.radiance)
    close(tlights.pdf_sky_v(tvec3.v3(torch.tensor(n)), ts.direction),
          jlights.pdf_sky_v(jvec3.v3(jnp.asarray(n)), js.direction))
    a, b = u[:, 0] * 3.0, u[:, 1]
    close(tlights.mis_weight(torch.tensor(a), torch.tensor(b)),
          jlights.mis_weight(jnp.asarray(a), jnp.asarray(b)))


def test_splat_and_aov_packing():
    xres, yres, n = 9, 7, 5000
    rs = np.random.default_rng(6)
    vals = rs.random((n, 6)).astype(np.float32)
    pixel = rs.integers(-1, xres * yres, n).astype(np.int32)
    sub_xy = rs.random((n, 2)).astype(np.float32)
    ti, tw = tsplat._splat(torch.tensor(vals), torch.tensor(pixel),
                           torch.tensor(sub_xy), xres, yres, 2.0)
    ji, jw = jsplat._splat(jnp.asarray(vals), jnp.asarray(pixel),
                           jnp.asarray(sub_xy), xres, yres, 2.0, 1.0)
    close(ti, ji, rtol=1e-5, atol=1e-5)
    close(tw, jw, rtol=1e-5, atol=1e-5)
    assert math.isclose(tsplat.ALPHA, jsplat.ALPHA)

    image = torch.zeros(xres * yres, 6)
    wsum = torch.zeros(xres * yres)
    tsplat.splat_accum(torch.tensor(vals), torch.tensor(pixel),
                       torch.tensor(sub_xy), image, wsum, xres, yres, 2.0)
    tsplat.splat_accum(torch.tensor(vals), torch.tensor(pixel),
                       torch.tensor(sub_xy), image, wsum, xres, yres, 2.0)
    close(image, 2 * np.asarray(ji), rtol=1e-5, atol=1e-5)

    rgb = torch.tensor(vals[:, :3])
    aovs = {"b": torch.tensor(vals[:, 3:]), "a": torch.tensor(vals[:, :3])}
    packed, names = tsplat.pack_aovs(rgb, aovs)
    jpacked, jnames = jsplat.pack_aovs(
        jnp.asarray(vals[:, :3]),
        {"b": jnp.asarray(vals[:, 3:]), "a": jnp.asarray(vals[:, :3])})
    assert names == jnames
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    planes = tsplat.unpack_aovs(packed, names)
    assert sorted(planes) == ["RGBA", "a", "b"]
    np.testing.assert_array_equal(planes["b"].numpy(), vals[:, 3:])
