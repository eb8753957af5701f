"""chip_smoke.py phase 42's frames at the reduced size of
tests/test_torch_textured_render.py (16x16, AA 1, one diffuse and one
glossy sample): scenes/textured_disk.ass with its three MayaFile slots
filled from scenes/data/formats_f, rendered by the JAX package (which
decodes the images with PIL) and by the port on the CPU (its own AVIF
decoder), every plane held to that file's PIX_ATOL; at the four pixels
around (7, 13), where the JAX package's jitted frame rounds one glossy
lane the other way (tests/test_torch_textured_render.py), the reference
is the JAX package's op-by-op value of the same frame (OPBYOP, printed by
`tools/textured_opbyop.py --images`), held to OPBYOP_ATOL.

Frame M: the 2048x2048 AVIF with film grain in the grid slot, an RGBA
image sequence as the logo and a quantizer-matrix AVIF as the inverted
logo. Frame N: the 2048x2048 texture as a 2x2 grid of 1024x1024 tiles, a
4:4:4 quantizer-matrix AVIF with alpha as the logo and an odd-size 4:2:0
film-grain AVIF with chroma scaled from luma as the inverted logo.
"""
import os

import numpy as np
import pytest

import chip_smoke
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import FORMAT_F_FRAMES
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
    "M": {
        "indirect_specular": {
            (6, 13): (0.0003473803517408669,
                      0.0006407052860595286,
                      0.0004300260334275663),
            (6, 14): (0.0028879595920443535,
                      0.003568290965631604,
                      0.0043103392235934734),
            (7, 13): (0.0010850641410797834,
                      0.0020012827590107918,
                      0.0013432130217552185),
            (7, 14): (0.0025780536234378815,
                      0.003462450811639428,
                      0.0037319259718060493),
        },
        "RGBA": {
            (6, 13): (0.008439556695520878,
                      0.010124065913259983,
                      0.015284578315913677),
            (6, 14): (0.08170842379331589,
                      0.0914822593331337,
                      0.12442208081483841),
            (7, 13): (0.02712901495397091,
                      0.0304839126765728,
                      0.04007509723305702),
            (7, 14): (0.06374580413103104,
                      0.07373907417058945,
                      0.11068583279848099),
        },
    },
    "N": {
        "indirect_specular": {
            (6, 13): (0.00034741664421744645,
                      0.000640671350993216,
                      0.0004287266347091645),
            (6, 14): (0.002887960523366928,
                      0.003568289801478386,
                      0.004310299176722765),
            (7, 13): (0.001085177413187921,
                      0.0020011765882372856,
                      0.0013391543179750443),
            (7, 14): (0.0025781020522117615,
                      0.0034624056424945593,
                      0.0037301937118172646),
        },
        "RGBA": {
            (6, 13): (0.008491436950862408,
                      0.010141368955373764,
                      0.015488842502236366),
            (6, 14): (0.08233629912137985,
                      0.09135717153549194,
                      0.12630464136600494),
            (7, 13): (0.02738608606159687,
                      0.030415091663599014,
                      0.04053964093327522),
            (7, 14): (0.0643140971660614,
                      0.07356469333171844,
                      0.11279254406690598),
        },
    },
}


ROWS = texel_rows(FORMAT_F_FRAMES)


@pytest.fixture(scope="module", params=sorted(FORMAT_F_FRAMES))
def frame(request, tmp_path_factory):
    tag = request.param
    images = FORMAT_F_FRAMES[tag]
    assert chip_smoke.FORMAT_F_FRAMES[tag] == images
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
