"""The ported slice against the JAX renderer on a lit variant of the demo
scene, at 24x24, AA 2, seed 3, in tiles of 100 pixels.

In the demo scene itself the quad light faces away from the geometry, so
its light-grid columns and BSDF pickups never carry energy. Here its
vertex order is reversed so that it lights the scene, and the GI sample
counts are 2 (4 rays per family), which runs the valid-sample
renormalization; the tiles leave a padded last tile. The JAX render
compiles once (about 35 s on a CPU).

Measured (torch 2.13 CPU vs jax 0.9 CPU): every pixel within 7e-6, frame
means equal to 6 digits. Tolerance as in test_torch_render.py, where it is
explained: per pixel 1e-5 absolute with at most 4 of the 576 pixels beyond
it, frame means within 1e-5 relative.
"""
import numpy as np
import pytest

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.parallel import mesh as jmesh
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.integrator import wavefront as twave

RES = 24
AA = 2
TILE_PIXELS = 100
SEED = 3
PIX_ATOL = 1e-5
MAX_OUTLIERS = 4
MEAN_RTOL = 1e-5
PLANES = ("RGBA", "direct_diffuse", "direct_specular", "indirect_diffuse",
          "indirect_specular")


def _lit_scene_text():
    src = jmesh.DEMO_SCENE_ASS.replace('shader "mat_skin"',
                                       'shader "mat_floor"')
    up = "-1 3 1 1 3 1 1 3 -1 -1 3 -1"
    down = "-1 3 -1 1 3 -1 1 3 1 -1 3 1"
    assert up in src
    src = src.replace(up, down)
    for k in ("GI_diffuse_samples", "GI_glossy_samples"):
        src = src.replace(f" {k} 1\n", f" {k} 2\n")
    return src


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lit") / "lit.ass")
    with open(path, "w") as f:
        f.write(_lit_scene_text())
    jscene = jbuild.build(path)
    jaccel = jtrace.build(jscene.geometry)
    kw = dict(seed=SEED, aa_samples=AA, xres=RES, yres=RES,
              tile_pixels=TILE_PIXELS)
    jout = jwave.render(jscene, jaccel, **kw)
    scene, accel = interop.scene_from_numpy(
        interop.scene_tables(jscene, jaccel), "cpu")
    return jout, twave.render(scene, accel, device="cpu", **kw)


@pytest.mark.parametrize("name", PLANES)
def test_lit_render_matches_jax(frames, name):
    jout, port = frames
    a, b = port[name].numpy(), jout[name]
    assert a.shape == b.shape == (RES, RES, 3)
    assert np.isfinite(a).all()
    outliers = (np.abs(a - b) > PIX_ATOL).any(-1).sum()
    assert outliers <= MAX_OUTLIERS, (name, outliers)
    ma, mb = float(a.mean()), float(b.mean())
    assert abs(ma - mb) <= MEAN_RTOL * abs(mb), (name, ma, mb)


def test_lit_render_uses_the_light(frames):
    _, port = frames
    # the light now reaches the geometry through the light grid
    assert float(port["direct_diffuse"].mean()) > 0.01
    assert float(port["direct_specular"].mean()) > 0.0
    stats = port["__stats__"]
    n_pix = RES * RES
    assert stats["tiles"] == -(-n_pix // TILE_PIXELS)
