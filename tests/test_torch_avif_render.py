"""chip_smoke.py phase 40's frames at the reduced size of
tests/test_torch_textured_render.py (16x16, AA 1, one diffuse and one
glossy sample): scenes/textured_disk.ass with its three MayaFile slots
filled from scenes/data/formats_e, rendered by the JAX package (which
decodes the images with PIL) and by the port on the CPU (its own AVIF
decoder), every plane held to that file's PIX_ATOL; at the four pixels
around (7, 13), where the JAX package's jitted frame rounds one glossy
lane the other way (tests/test_torch_textured_render.py), the reference
is the JAX package's op-by-op value of the same frame (OPBYOP, printed by
`tools/textured_opbyop.py --images`), held to OPBYOP_ATOL.

Frame K: the 2048x2048 AVIF (4x2 tiles) in the grid slot, an RGBA AVIF
as the logo and an AVIF with premultiplied alpha as the inverted logo.
Frame L: a lossless 4:4:4 AVIF (palette, intra block copy) as the grid, a
4:0:0 AVIF with alpha as the logo and a limited-range 4:2:2 AVIF as the
inverted logo.
"""
import os

import numpy as np
import pytest

import chip_smoke
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import FORMAT_E_FRAMES
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
    "K": {
        "indirect_specular": {
            (6, 13): (0.00034760625567287207,
                      0.0006405212916433811,
                      0.00042878914973698556),
            (6, 14): (0.002887966576963663,
                      0.003568285144865513,
                      0.004310301039367914),
            (7, 13): (0.0010857697343453765,
                      0.0020007079001516104,
                      0.001339349546469748),
            (7, 14): (0.0025783549062907696,
                      0.0034622056409716606,
                      0.0037302770651876926),
        },
        "RGBA": {
            (6, 13): (0.008277853950858116,
                      0.010072678327560425,
                      0.014937052503228188),
            (6, 14): (0.08168438076972961,
                      0.09155885130167007,
                      0.12436951696872711),
            (7, 13): (0.02711954340338707,
                      0.030530480667948723,
                      0.0400778092443943),
            (7, 14): (0.06376447528600693,
                      0.0737764984369278,
                      0.11076448857784271),
        },
    },
    "L": {
        "indirect_specular": {
            (6, 13): (0.000721348391380161,
                      0.0008930732728913426,
                      0.0011708287056535482),
            (6, 14): (0.002899603685364127,
                      0.0035761487670242786,
                      0.004333405755460262),
            (7, 13): (0.002253176411613822,
                      0.002789569552987814,
                      0.003657155903056264),
            (7, 14): (0.0030765451956540346,
                      0.003798851976171136,
                      0.004719399847090244),
        },
        "RGBA": {
            (6, 13): (0.010672167874872684,
                      0.010631868615746498,
                      0.012652804143726826),
            (6, 14): (0.09391923248767853,
                      0.09182669222354889,
                      0.09135718643665314),
            (7, 13): (0.045110657811164856,
                      0.04149429500102997,
                      0.04066552594304085),
            (7, 14): (0.0794210135936737,
                      0.07745730131864548,
                      0.07721330225467682),
        },
    },
}


ROWS = texel_rows(FORMAT_E_FRAMES)


@pytest.fixture(scope="module", params=sorted(FORMAT_E_FRAMES))
def frame(request, tmp_path_factory):
    tag = request.param
    images = FORMAT_E_FRAMES[tag]
    assert chip_smoke.FORMAT_E_FRAMES[tag] == images
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
