"""A reduced copy of scenes/textured_disk.ass (16x16, AA 1, one diffuse
and one glossy sample a hit) rendered by the JAX package and by the port
on the CPU, every plane, through the port's build and through interop:
MayaFile textures with gain, offset and invert, planar projections with
wrap off and on, a bump3d, texture links on rlGgx and rlDisney, two disk
lights and a dome, the ray-cone footprint from the render's own width.
Also its ray counts by formula.

Measured: every pixel of every plane within 2.9e-7 of the JAX frame but
four, around one camera lane, pixel (7, 13), whose glossy family ray meets
the backdrop 1.7 mm above its seam with the floor. There the JAX
package's jitted frame gives the lane's indirect_specular 0, and the same
package run op by op (jax.disable_jit) gives 0.0034, 0.0042, 0.0055: the
fused program rounds one step of that lane's path the other way. The port
matches the op-by-op frame everywhere within 1.2e-7. So the reference is
the jitted frame with those four pixels of indirect_specular and RGBA (the
planes the lane feeds) set to their op-by-op values (OPBYOP, printed by
tools/textured_opbyop.py), held to OPBYOP_ATOL there; every pixel of every
plane is held to PIX_ATOL, the refraction slice's per-pixel tolerance.

The same frame with chip_smoke.py phase 30's lossless image files (an
LZW TIFF with predictor 2 and an Adam7 palette PNG in the logo slots,
grid.png kept in place of the 2048x2048 JPEG) equals the PNG frame bit
for bit in the port, and is held to the JAX package's frame of the same
files at the same tolerances.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from test_torch_refract import PLANES
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene import build as tbuild

cpu_math.settle()

SCENE = "scenes/textured_disk.ass"
RES = 16
KW = dict(seed=0, aa_samples=1, xres=RES, yres=RES)
REDUCED = dict(GI_diffuse_samples=1, GI_glossy_samples=1)
PIX_ATOL = 1e-5
OPBYOP_ATOL = 1e-6
# the JAX package's op-by-op values where its jitted frame differs
_OPBYOP_SPEC = {
    (6, 13): (0.000721348391380161, 0.0008930732728913426,
              0.0011662838514894247),
    (6, 14): (0.002899603685364127, 0.0035761487670242786,
              0.004333264194428921),
    (7, 13): (0.002253176411613822, 0.002789569552987814,
              0.003642959985882044),
    (7, 14): (0.0030765451956540346, 0.003798851976171136,
              0.004713341593742371),
}
_OPBYOP_RGBA = {
    (6, 13): (0.0090651735663414, 0.01065050344914198, 0.01673559658229351),
    (6, 14): (0.08252418041229248, 0.09196972846984863, 0.12767189741134644),
    (7, 13): (0.040272507816553116, 0.0415126197040081, 0.05375853180885315),
    (7, 14): (0.06633368879556656, 0.07714643329381943, 0.12026291340589523),
}
OPBYOP = {"indirect_specular": _OPBYOP_SPEC, "RGBA": _OPBYOP_RGBA}

def texel_rows(frames: dict) -> int:
    """The most rows the JAX package's texel table takes for any frame of
    `frames` ({tag: images of scenes/data in the three slots}): every mip
    level of each image (2x reductions, odd sides rounded up, at most 12
    levels)."""
    from PIL import Image

    def rows(name):
        w, h = Image.open(os.path.join("scenes", "data", name)).size
        total = 0
        for _ in range(12):
            total += h * w
            if h == w == 1:
                break
            h, w = (h + 1) // 2, (w + 1) // 2
        return total
    return max(sum(rows(n) for n in images) for images in frames.values())


def padded(scene, rows: int):
    """The JAX scene with its texel table padded with zero rows to `rows`:
    the same render (no lookup reads past a texture's last level), and
    one compiled program for the frames of a file, whose tables are then
    of one shape (the JAX package reuses its programs across scenes of
    identical table shapes)."""
    import dataclasses

    import jax.numpy as jnp

    tex = scene.textures
    pad = jnp.zeros((rows - tex.data.shape[0], 3), tex.data.dtype)
    return dataclasses.replace(scene, textures=tex._replace(
        data=jnp.concatenate([tex.data, pad])))


def textured_copy(path, **opts) -> str:
    """scenes/textured_disk.ass with options replaced, written beside its
    images (`path` in a directory holding data/)."""
    with open(SCENE) as f:
        src = f.read()
    for k, v in opts.items():
        src, n = re.subn(rf"^ {k} \d+$", f" {k} {v}", src, flags=re.M)
        assert n == 1, k
    with open(path, "w") as f:
        f.write(src)
    return str(path)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("textured")
    (d / "data").symlink_to(os.path.abspath("scenes/data"))
    path = textured_copy(d / "t.ass", **REDUCED)
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


def _agree(port, ref, name):
    a = port[name].numpy()
    b = np.array(ref[name])
    assert a.shape == b.shape == (RES, RES, 3)
    assert np.isfinite(a).all()
    for px, v in OPBYOP.get(name, {}).items():
        b[px] = v
    err = np.abs(a - b).max(-1)
    worst = np.unravel_index(np.argmax(err), err.shape)
    assert err.max() <= PIX_ATOL, (name, err.max(), worst)
    for px in OPBYOP.get(name, {}):
        assert err[px] <= OPBYOP_ATOL, (name, px, err[px])


@pytest.mark.parametrize("name", PLANES)
def test_textured_frame_matches_jax(frames, name):
    jout, own, via, _, _ = frames
    _agree(own, jout, name)
    _agree(via, jout, name)


def test_textured_frame_is_textured(frames):
    """Every plane the scene lights is lit, and the textures show: the
    grid's dark lines and the disc put a spread of values in the frame."""
    _, own, _, scene, _ = frames
    for name in ("direct_diffuse", "indirect_diffuse", "direct_specular",
                 "indirect_specular"):
        assert float(own[name].mean()) > 0.0, name
    rgb = own["RGBA"].numpy()
    assert rgb.std() > 0.2 * rgb.mean()
    static = twave.SceneStatic.of(scene)
    assert static.has_tex and static.has_bump and static.tex_gamma == 2.2
    assert static.disk_valid == (True, True)
    assert static.disk_w_s == (1.0, 0.0)


def test_textured_frame_counts_rays(frames):
    _, own, via, _, _ = frames
    n = RES * RES
    stats = own["__stats__"]
    # per camera ray, as (nearest rays, any-hit rays): the camera ray and
    # its 8-column light grid (two disks of 2x2 samples; the dome column
    # dropped) (1, 8); the diffuse family ray with its light and dome
    # pickups, its hit's 3-column grid and both fallback lobes (1, 7); the
    # glossy family ray with its pickups and grid, the diffuse family its
    # hit spawns and the specular fallback (2, 13)
    assert stats["nearest_rays"] == 4 * n
    assert stats["shadow_rays"] == 28 * n
    assert stats["nearest_calls"] == 4
    assert stats["shadow_calls"] == 15
    assert stats["march_segments"] == 0
    assert via["__stats__"] == stats


def test_pixel_spread_follows_the_render_width(frames):
    """The footprint's spread is one pixel of the render's width, not of
    the camera's (a reduced render keeps each pixel's footprint)."""
    _, _, _, scene, accel = frames
    want = 2.0 * math.tan(math.radians(scene.camera.fov_deg) * 0.5)
    for xres in (None, RES, 64):
        tr = twave.TileRenderer(scene, accel, 1, xres=xres)
        assert tr.conf.pix_spread == want / (xres or scene.camera.xres)


# ---------------------------------------------------------------------------
# the same frame with other image modes of the same pixels
# ---------------------------------------------------------------------------

# chip_smoke.py phase 30's frame A, with scenes/data/grid.png in place of
# its 2048x2048 JPEG: every image a lossless re-encoding of the PNG its
# slot names (tools/make_image_modes.py)
LOSSLESS_IMAGES = ("grid.png", "modes/logo_lzw_pred2.tif",
                   "modes/logo_palette_adam7.png")


@pytest.fixture(scope="module")
def lossless_frames(tmp_path_factory, frames):
    """The reduced frame with LOSSLESS_IMAGES, by the JAX package (which
    decodes them with PIL) and by the port: the JAX package's textures
    equal those of the PNGs they re-encode, and its jitted renderer runs
    the tables of the PNG frame's shapes again."""
    import chip_smoke
    from rlshaders_tpu.scene import texture as jtex

    for name, png in zip(LOSSLESS_IMAGES, ("grid.png", "logo.png",
                                           "logo.png")):
        assert np.array_equal(jtex.load_image(f"scenes/data/{name}", 1.0),
                              jtex.load_image(f"scenes/data/{png}", 1.0))
    d = tmp_path_factory.mktemp("textured_modes")
    (d / "data").symlink_to(os.path.abspath("scenes/data"))
    path = textured_copy(d / "t.ass", **REDUCED)
    with open(path) as f:
        src = chip_smoke.with_images(f.read(), LOSSLESS_IMAGES)
    with open(path, "w") as f:
        f.write(src)
    js = jbuild.build(path)
    jout = jwave.render(js, jtrace.build(js.geometry), **KW)
    ts = tbuild.build(path, device="cpu")
    own = twave.render(ts, ttrace.build(ts.geometry), **KW)
    return jout, own, ts


def test_lossless_modes_frame_equals_png_frame(frames, lossless_frames):
    """The port's frame with a TIFF (LZW, predictor 2) and an Adam7
    palette PNG in the logo slots equals its PNG frame bit for bit."""
    _, png_frame, _, _, _ = frames
    _, own, scene = lossless_frames
    assert scene.textures.n_levels.shape == (3,)
    assert set(own) == set(png_frame)
    for name in PLANES:
        assert torch.equal(own[name], png_frame[name]), name
    assert own["__stats__"] == png_frame["__stats__"]


@pytest.mark.parametrize("name", PLANES)
def test_lossless_modes_frame_matches_jax(lossless_frames, name):
    jout, own, _ = lossless_frames
    _agree(own, jout, name)
