"""The whole ported slice against the JAX renderer: demo_scene(skin=False)
at 32x32, AA 2, seed 0, on the CPU.

The port draws the same random numbers (bit-equal threefry and Owen-Sobol)
and traces the same rays through the same BVH rules, so the frames agree
pixel by pixel. Measured (torch 2.13 CPU vs jax 0.9 CPU): every pixel of
RGBA and of every AOV within 3e-7, frame means equal to 7 digits. Stated
tolerance: per pixel and channel 1e-5 absolute, with at most 4 of the 1024
pixels allowed beyond it (a sample can take the other branch at a triangle
edge or a horizon where XLA's and torch's transcendentals differ in the
last bit); frame mean of each plane within 1e-5 relative (or 1e-7 absolute
for the all-zero planes).

The JAX render compiles for about 35 s on a CPU, so this file renders once
with each package and shares the result.
"""
import numpy as np
import pytest

from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.parallel import mesh as jmesh
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene.demo import demo_scene

RES = 32
AA = 2
PIX_ATOL = 1e-5
MAX_OUTLIERS = 4
MEAN_RTOL = 1e-5
PLANES = ("RGBA", "direct_diffuse", "direct_specular", "indirect_diffuse",
          "indirect_specular", "refraction", "sss")


@pytest.fixture(scope="module")
def frames():
    jscene, jaccel = jmesh.demo_scene(skin=False)
    jout = jwave.render(jscene, jaccel, seed=0, aa_samples=AA, xres=RES,
                        yres=RES)
    scene, accel = demo_scene(skin=False, device="cpu")
    own = twave.render(scene, accel, device="cpu", seed=0, aa_samples=AA,
                       xres=RES, yres=RES)
    iscene, iaccel = interop.scene_from_numpy(
        interop.scene_tables(jscene, jaccel), "cpu")
    via = twave.render(iscene, iaccel, device="cpu", seed=0, aa_samples=AA,
                       xres=RES, yres=RES)
    return jout, own, via


def _agree(port, ref, name):
    a = port[name].numpy()
    b = ref[name]
    assert a.shape == b.shape == (RES, RES, 3)
    assert np.isfinite(a).all()
    outliers = (np.abs(a - b) > PIX_ATOL).any(-1).sum()
    assert outliers <= MAX_OUTLIERS, (name, outliers)
    ma, mb = float(a.mean()), float(b.mean())
    assert abs(ma - mb) <= max(MEAN_RTOL * abs(mb), 1e-7), (name, ma, mb)


@pytest.mark.parametrize("name", PLANES)
def test_port_build_render_matches_jax(frames, name):
    jout, own, _ = frames
    _agree(own, jout, name)


@pytest.mark.parametrize("name", PLANES)
def test_interop_scene_render_matches_jax(frames, name):
    jout, _, via = frames
    _agree(via, jout, name)


def test_frame_is_lit_and_counts_rays(frames):
    _, own, _ = frames
    assert float(own["RGBA"].mean()) > 0.05
    stats = own["__stats__"]
    n = RES * RES * AA * AA
    # per camera ray: the camera ray, the diffuse and glossy families and
    # the diffuse family spawned at glossy hits (4 nearest queries); 21
    # shadow segments (light grids, pickups, dome and fallback queries)
    assert stats["nearest_rays"] == 4 * n
    assert stats["shadow_rays"] == 21 * n
    assert stats["tiles"] == 1
