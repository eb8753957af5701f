"""A copy of scenes/skin_closeup.ass (rlSkin with both specular lobes, a
3x3-sample quad light and a dome) at 8x8, AA 1, GI_sss_samples 2, seed 0:
the port against the JAX renderer on the CPU, every plane, through the
port's build and through interop, and its ray counts by formula (its own
file: the JAX render compiles for about two minutes).

Measured: every plane within 8.4e-7 of the JAX frame (the sss plane's
largest error 7.2e-7 on values near 0.2). The tolerances are the
refraction slice's (tests/test_torch_refract.py).
"""
import re

import pytest
import torch

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from test_torch_refract import PLANES, frames_agree
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import rng
from rlshaders_tpu_torch.integrator import camera
from rlshaders_tpu_torch.integrator import sss as tsss
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()

SKIN = "scenes/skin_closeup.ass"
RES = 8
SSS_SAMPLES = 2
KW = dict(seed=0, aa_samples=1, xres=RES, yres=RES)


def skin_copy(path, sss_samples) -> str:
    with open(SKIN) as f:
        src = f.read()
    src, n = re.subn(r"^ GI_sss_samples \d+$",
                     f" GI_sss_samples {sss_samples}", src, flags=re.M)
    assert n == 1
    with open(path, "w") as f:
        f.write(src)
    return str(path)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = skin_copy(tmp_path_factory.mktemp("skin") / "s.ass", SSS_SAMPLES)
    js = jbuild.build(path)
    ja = jtrace.build(js.geometry)
    jout = jwave.render(js, ja, **KW)
    ts = tbuild.build(path, device="cpu")
    accel = ttrace.build(ts.geometry)
    own = twave.render(ts, accel, **KW)
    iscene, iaccel = interop.scene_from_numpy(interop.scene_tables(js, ja),
                                              "cpu")
    via = twave.render(iscene, iaccel, **KW)
    return jout, own, via, ts, accel


@pytest.mark.parametrize("name", PLANES)
def test_skin_closeup_matches_jax(frames, name):
    jout, own, via, _, _ = frames
    frames_agree(own, jout, name, RES)
    frames_agree(via, jout, name, RES)


def test_skin_closeup_counts_rays(frames):
    _, own, _, scene, accel = frames
    assert float(own["sss"].mean()) > 0.05
    # the camera lanes on the sheet (its only mesh, rlSkin)
    key = rng.stream(scene.options.aa_seed)
    rays = camera.generate(scene.camera, rng.fold(key, 77), 1, RES, RES)
    hit = ttrace.nearest(accel, rays.origin, rays.direction, vis_mask=1)
    n_sss = int((hit.tri >= 0).sum())
    assert 0 < n_sss < RES * RES
    n = RES * RES
    stats = own["__stats__"]
    # per camera ray, as (nearest rays, any-hit rays): the camera ray and
    # its 9-column light grid (1, 9); the 4 diffuse family rays with their
    # light and dome pickups, their hits' 2-column grids and both fallback
    # lobes (4, 24); the 4 glossy family rays with their pickups and grids,
    # the diffuse family each spawns (with pickups, grid and fallbacks) and
    # the specular fallback (8, 44)
    # per SSS lane and probe, K_PROBE steps of: the probe and the bounce
    # (2, 0); the probe hit's 9 light samples and the dome, its emitter
    # and dome tests (0, 12); the bounce hit's one light sample, dome,
    # emitter and dome tests (0, 4)
    probes = SSS_SAMPLES ** 2 * tsss.K_PROBE
    assert stats["nearest_rays"] == 13 * n + 2 * probes * n_sss
    assert stats["shadow_rays"] == 77 * n + 16 * probes * n_sss
    assert stats["nearest_calls"] == 4 + 2 * tsss.K_PROBE
    assert stats["shadow_calls"] == 15 + 6 * tsss.K_PROBE
    assert stats["march_segments"] == 0
