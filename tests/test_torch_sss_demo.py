"""demo_scene() with its rlSkin blob: the port against the JAX renderer on
the CPU, 16x16, AA 1, seed 0, every plane, through the port's build and
through interop (its own file: the JAX render compiles for about a minute).

The blob's probes end on the floor (a foreign mesh) and march through the
blob's own faces. The blob has no normals list and its winding gives
inward facet normals, so its own faces block every probe hit's light: the
`sss` plane is black in both packages, and the frame checks the stage's
traffic rather than its values (tests/test_torch_sss_closeup.py checks
those). Measured: every plane within 9e-8 of the JAX frame. The tolerances
are the refraction slice's (tests/test_torch_refract.py).
"""
import pytest

from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.parallel import mesh as jmesh
from test_torch_refract import PLANES, frames_agree
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.integrator import sss as tsss
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene.demo import demo_scene
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()

RES = 16
KW = dict(seed=0, aa_samples=1, xres=RES, yres=RES)


@pytest.fixture(scope="module")
def frames():
    jscene, jaccel = jmesh.demo_scene(skin=True)
    jout = jwave.render(jscene, jaccel, **KW)
    scene, accel = demo_scene(device="cpu")
    own = twave.render(scene, accel, **KW)
    iscene, iaccel = interop.scene_from_numpy(
        interop.scene_tables(jscene, jaccel), "cpu")
    via = twave.render(iscene, iaccel, **KW)
    return jout, own, via


@pytest.mark.parametrize("name", PLANES)
def test_skin_demo_matches_jax(frames, name):
    jout, own, via = frames
    frames_agree(own, jout, name, RES)
    frames_agree(via, jout, name, RES)


def test_skin_demo_runs_the_stage(frames):
    _, own, _ = frames
    assert float(own["RGBA"].mean()) > 0.05
    stats = own["__stats__"]
    # one tile: 4 nearest calls of the opaque tree, then the probe stage's
    # 2 per step; 15 any-hit calls, then its 6 per step. No secondary SSS:
    # the glossy family's hits on the blob carry ray_lobe "specular"
    assert stats["nearest_calls"] == 4 + 2 * tsss.K_PROBE
    assert stats["shadow_calls"] == 15 + 6 * tsss.K_PROBE
