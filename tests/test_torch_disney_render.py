"""A reduced copy of scenes/disney_spheres.ass (16x16, AA 1, one diffuse
and one glossy sample a hit) rendered by the JAX package and by the port
on the CPU, every plane, through the port's build and through interop;
its ray counts by formula; and, on the port alone, rlDisney's indirect
multipliers at camera hits and at Disney hits inside the floor's families.

Measured: every pixel of every plane within 2.1e-7 of the JAX frame,
through both the port's build and interop. The tolerances are the
refraction slice's (tests/test_torch_refract.py), as for the glass and skin
frames.
"""
import dataclasses
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
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()

DISNEY = "scenes/disney_spheres.ass"
RES = 16
KW = dict(seed=0, aa_samples=1, xres=RES, yres=RES)
REDUCED = dict(GI_diffuse_samples=1, GI_glossy_samples=1)


def disney_copy(path, **opts) -> str:
    """scenes/disney_spheres.ass with options replaced, written to
    `path`."""
    with open(DISNEY) as f:
        src = f.read()
    for k, v in opts.items():
        src, n = re.subn(rf"^ {k} \d+$", f" {k} {v}", src, flags=re.M)
        assert n == 1, k
    with open(path, "w") as f:
        f.write(src)
    return str(path)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = disney_copy(tmp_path_factory.mktemp("disney") / "d.ass",
                       **REDUCED)
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
def test_disney_frame_matches_jax(frames, name):
    jout, own, via, _, _ = frames
    frames_agree(own, jout, name, RES)
    frames_agree(via, jout, name, RES)


def test_disney_frame_counts_rays(frames):
    _, own, via, scene, _ = frames
    assert float(own["indirect_specular"].mean()) > 0.0
    assert float(own["direct_diffuse"].mean()) > 0.0  # the light is lit
    n = RES * RES
    stats = own["__stats__"]
    # per camera ray, as (nearest rays, any-hit rays): the camera ray and
    # its 4-column light grid (1, 4); the diffuse family ray with its light
    # and dome pickups, its hit's 2-column grid and both fallback lobes
    # (1, 6); the glossy family ray with its pickups and grid, the diffuse
    # family its hit spawns and the specular fallback (2, 11)
    assert stats["nearest_rays"] == 4 * n
    assert stats["shadow_rays"] == 21 * n
    assert stats["nearest_calls"] == 4
    assert stats["shadow_calls"] == 15
    assert stats["march_segments"] == 0
    assert via["__stats__"] == stats


def _lanes(scene, accel, **scales):
    """Per-lane AOVs of the frame's one tile (before the splat blends
    neighbouring lanes) with dsy_coat's indirect multipliers replaced, and
    the material each camera lane hits (-1 on a miss)."""
    m = scene.materials
    coat = scene.material_names.index("dsy_coat")
    for f, v in scales.items():
        m = m._replace(**{f: getattr(m, f).index_fill(
            0, torch.tensor([coat]), v)})
    scene = dataclasses.replace(scene, materials=m)
    key = rng.stream(scene.options.aa_seed)
    rays = camera.generate(scene.camera, rng.fold(key, 77), 1, RES, RES)
    tr = twave.TileRenderer(scene, accel, 1)
    _, aovs = tr.render_tile_at(rays, 0, RES * RES, rng.fold(key, 1000))
    hit = ttrace.nearest(accel, rays.origin, rays.direction, vis_mask=1)
    mat = torch.where(hit.tri >= 0,
                      scene.geometry.mat_id[hit.tri.clamp_min(0).long()], -1)
    return aovs, mat, coat


def test_indirect_scales(frames):
    """dsy_coat has indirectDiffuseScale 0.5 and indirectSpecularScale 2:
    its camera lanes' indirect planes are exactly those of the scales at 1
    times the scales (families that leave a sphere cannot meet it again);
    at 0 the indirect_diffuse plane is black. The floor's families meet
    the coat too, and its direct light there is scaled as well."""
    _, _, _, scene, accel = frames
    base, mat, coat = _lanes(scene, accel)
    unit, _, _ = _lanes(scene, accel, indirect_diffuse_scale=1.0,
                        indirect_specular_scale=1.0)
    zero, _, _ = _lanes(scene, accel, indirect_diffuse_scale=0.0)
    on_coat = mat == coat
    assert int(on_coat.sum()) >= 3
    for plane, s in (("indirect_diffuse", 0.5), ("indirect_specular", 2.0)):
        assert torch.equal(base[plane][on_coat], unit[plane][on_coat] * s)
        assert float(unit[plane][on_coat].abs().max()) > 0.0
    assert float(zero["indirect_diffuse"][on_coat].abs().max()) == 0.0
    assert float(zero["indirect_diffuse"][~on_coat].abs().max()) > 0.0
    # floor lanes whose families hit the coat see its scaled direct light
    floor = mat == scene.material_names.index("floor_mat")
    moved = (base["indirect_diffuse"] != unit["indirect_diffuse"]).any(-1)
    assert int((moved & floor).sum()) >= 1
    # the direct planes of camera hits are never scaled
    for plane in ("direct_diffuse", "direct_specular"):
        assert torch.equal(base[plane], unit[plane])
