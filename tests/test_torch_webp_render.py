"""chip_smoke.py phase 36's frames at the reduced size of
tests/test_torch_textured_render.py (16x16, AA 1, one diffuse and one
glossy sample): scenes/textured_disk.ass with its three MayaFile slots
filled from scenes/data/formats_c, rendered by the JAX package (which
decodes the images with PIL) and by the port on the CPU (its own SPIDER
and WebP decoders), every plane held to that file's PIX_ATOL; at the four
pixels around (7, 13), where the JAX package's jitted frame rounds one
glossy lane the other way (tests/test_torch_textured_render.py), the
reference is the JAX package's op-by-op value of the same frame (OPBYOP,
printed by `tools/textured_opbyop.py --images`), held to OPBYOP_ATOL.

Frame G: the 2048x2048 lossy WebP in the grid slot, a lossless RGBA WebP
as the logo and a lossy WebP with an ALPH chunk as the inverted logo.
Frame H: a SPIDER grid (128x128, from "L"), a lossless WebP whose
palette packs four pixels to a byte as the logo and a quality-5 lossy
WebP as the inverted logo. A file of its own: the frames of
tests/test_torch_format_render.py already take minutes on one worker.
"""
import os

import numpy as np
import pytest

import chip_smoke
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import FORMAT_C_FRAMES
from test_torch_textured_render import (KW, OPBYOP_ATOL, PIX_ATOL, PLANES,
                                        REDUCED, RES, padded, texel_rows,
                                        textured_copy)
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene import texture as ttex

cpu_math.settle()

# the JAX package's op-by-op values of each frame where its jitted frame
# differs (tools/textured_opbyop.py --images ...)
OPBYOP = {
    "G": {
        "indirect_specular": {
            (6, 13): (0.0003503792395349592,
                      0.0006374641670845449,
                      0.0004326202324591577),
            (6, 14): (0.0028880529571324587,
                      0.003568190149962902,
                      0.004310420248657465),
            (7, 13): (0.001094431267119944,
                      0.0019911588169634342,
                      0.0013513161102309823),
            (7, 14): (0.0025820510927587748,
                      0.003458130406215787,
                      0.0037353842053562403),
        },
        "RGBA": {
            (6, 13): (0.008538716472685337,
                      0.010111412033438683,
                      0.015681026503443718),
            (6, 14): (0.082267165184021,
                      0.09145164489746094,
                      0.1267017126083374),
            (7, 13): (0.027386488392949104,
                      0.03043290413916111,
                      0.04083307832479477),
            (7, 14): (0.06423299759626389,
                      0.07370154559612274,
                      0.11307410895824432),
        },
    },
    "H": {
        "indirect_specular": {
            (6, 13): (0.000729382794816047,
                      0.0008995378157123923,
                      0.001089317025616765),
            (6, 14): (0.0028998537454754114,
                      0.0035763499327003956,
                      0.004330867901444435),
            (7, 13): (0.002278272295370698,
                      0.0028097620233893394,
                      0.003402549307793379),
            (7, 14): (0.0030872547067701817,
                      0.0038074690382927656,
                      0.004610746633261442),
        },
        "RGBA": {
            (6, 13): (0.009110801853239536,
                      0.010574349202215672,
                      0.016451667994260788),
            (6, 14): (0.08251563459634781,
                      0.09196972846984863,
                      0.12757571041584015),
            (7, 13): (0.03880814462900162,
                      0.04211757332086563,
                      0.054215021431446075),
            (7, 14): (0.06623832881450653,
                      0.07726182043552399,
                      0.11982577294111252),
        },
    },
}


ROWS = texel_rows(FORMAT_C_FRAMES)


@pytest.fixture(scope="module", params=sorted(FORMAT_C_FRAMES))
def frame(request, tmp_path_factory):
    tag = request.param
    images = FORMAT_C_FRAMES[tag]
    assert chip_smoke.FORMAT_C_FRAMES[tag] == images
    d = tmp_path_factory.mktemp(f"formats_{tag}") / "a" / "b"
    d.mkdir(parents=True)
    (d / "data").symlink_to(os.path.abspath("scenes/data"))
    path = textured_copy(d / "t.ass", **REDUCED)
    with open(path) as f:
        src = chip_smoke.with_images(f.read(), images)
    with open(path, "w") as f:
        f.write(src)
    js = jbuild.build(path)
    # one compiled JAX program for the file's frames (texel_rows, padded)
    jout = jwave.render(padded(js, ROWS), jtrace.build(js.geometry), **KW)
    ts = tbuild.build(path, device="cpu")
    own = twave.render(ts, ttrace.build(ts.geometry), **KW)
    return tag, images, jout, own, ts


def test_frame_reads_the_formats(frame):
    """The texture stack holds the three files' texels as both packages
    decode them (level 0 of each)."""
    _, images, _, _, scene = frame
    tex = scene.textures
    assert tex.n_levels.shape == (3,)
    for i, name in enumerate(images):
        img = ttex.load_image(f"scenes/data/{name}")
        assert np.array_equal(img, jtex.load_image(f"scenes/data/{name}",
                                                   1.0))
        h, w = img.shape[:2]
        off = int(tex.offset[i, 0])
        assert tuple(tex.sizes[i, 0].tolist()) == (h, w)
        assert np.array_equal(tex.data[off:off + h * w].numpy(),
                              img.reshape(-1, 3))


@pytest.mark.parametrize("name", PLANES)
def test_frame_matches_jax(frame, name):
    tag, _, jout, own, _ = frame
    a = own[name].numpy()
    b = np.array(jout[name])
    assert a.shape == b.shape == (RES, RES, 3)
    assert np.isfinite(a).all()
    opbyop = OPBYOP[tag].get(name, {})
    for px, v in opbyop.items():
        b[px] = v
    err = np.abs(a - b).max(-1)
    worst = np.unravel_index(np.argmax(err), err.shape)
    assert err.max() <= PIX_ATOL, (tag, name, err.max(), worst)
    for px in opbyop:
        assert err[px] <= OPBYOP_ATOL, (tag, name, px, err[px])
