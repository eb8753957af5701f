"""Frame B of the glass sphere: the port against the JAX renderer on the
CPU, with the diffuse family that refracted hits spawn.

A copy of scenes/glass_sphere.ass at refraction depth 1, diffuse depth 1,
glossy depth 0 and one sample of each, 16x16, AA 1, seed 0, rendered once
per package (its own file, so that its JAX compile runs on another worker
than frame A's in tests/test_torch_refract.py). Measured: every plane
within 1e-5 of the JAX frame except 2 pixels of indirect_diffuse (and so
RGBA) at 3.3e-5, a sample that took the other branch at a triangle edge;
plane means within 4e-6 relative. The tolerances are frame A's.
"""
import pytest

from test_torch_refract import PLANES, frames_agree, glass_copy, render_both
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()

RES = 16
FRAME_B = dict(GI_refraction_depth=1, GI_diffuse_depth=1, GI_glossy_depth=0,
               GI_diffuse_samples=1, GI_glossy_samples=1,
               GI_refraction_samples=1)


@pytest.fixture(scope="module")
def frame_b(tmp_path_factory):
    path = glass_copy(tmp_path_factory.mktemp("glass") / "b.ass", **FRAME_B)
    return render_both(path, RES, 99)


@pytest.mark.parametrize("name", PLANES)
def test_frame_b_matches_jax(frame_b, name):
    jout, own, via = frame_b
    frames_agree(own, jout, name, RES)
    frames_agree(via, jout, name, RES)


def test_frame_b_counts_rays(frame_b):
    _, own, _ = frame_b
    assert float(own["indirect_diffuse"].mean()) > 0.01
    assert float(own["refraction"].mean()) > 0.0
    n = RES * RES
    stats = own["__stats__"]
    # per camera ray, as (nearest rays, marched segments, any-hit rays):
    # camera ray and its 10-column light grid (41, 10, 0); the diffuse
    # family ray with its light and dome pickups (9, 2, 0); at its hit a
    # 2-column grid, the fallback lobes and one refraction generation
    # (8 + 1 + 8, 4, 4); the camera refraction ray and its hit's grid
    # (1 + 8, 2, 0), the diffuse family spawned there, its hit and
    # fallbacks (9 + 8, 4, 2), and the specular fallback (0, 0, 1)
    assert stats["nearest_rays"] == (41 + 9 + 17 + 9 + 17) * n
    assert stats["march_segments"] == (10 + 2 + 4 + 2 + 4) * n
    assert stats["shadow_rays"] == (4 + 2 + 1) * n
