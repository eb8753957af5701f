"""chip_smoke.py phase 38's frames at the reduced size of
tests/test_torch_textured_render.py (16x16, AA 1, one diffuse and one
glossy sample): scenes/textured_disk.ass with its three MayaFile slots
filled from scenes/data/formats_d, rendered by the JAX package (which
decodes the images with PIL) and by the port on the CPU (its own JPEG
2000 and WebP decoders), every plane held to that file's PIX_ATOL; at the
four pixels around (7, 13), where the JAX package's jitted frame rounds
one glossy lane the other way (tests/test_torch_textured_render.py), the
reference is the JAX package's op-by-op value of the same frame (OPBYOP,
printed by `tools/textured_opbyop.py --images`), held to OPBYOP_ATOL.

Frame I: the 2048x2048 9/7 JP2 of three quality layers in the grid slot,
a lossless RGBA JP2 as the logo and an animated lossy WebP (its first
frame, with alpha, inside a larger canvas) as the inverted logo. Frame J:
a palette JP2 (pclr and cmap boxes) as the grid, a tiled RPCL J2K with an
image offset as the logo and an animated lossless WebP as the inverted
logo.
"""
import os

import numpy as np
import pytest

import chip_smoke
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import FORMAT_D_FRAMES
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
    "I": {
        "indirect_specular": {
            (6, 13): (0.00035009163548238575,
                      0.0006361895939335227,
                      0.00043209310388192534),
            (6, 14): (0.002888043876737356,
                      0.0035681501030921936,
                      0.004310403950512409),
            (7, 13): (0.0010935330064967275,
                      0.001987177412956953,
                      0.001349669648334384),
            (7, 14): (0.0025816678535193205,
                      0.0034564314410090446,
                      0.0037346810568124056),
        },
        "RGBA": {
            (6, 13): (0.07003284245729446,
                      0.07718434184789658,
                      0.08792271465063095),
            (6, 14): (0.09464029967784882,
                      0.10494736582040787,
                      0.14123716950416565),
            (7, 13): (0.027385009452700615,
                      0.030418379232287407,
                      0.04082891345024109),
            (7, 14): (0.06423088163137436,
                      0.07369675487279892,
                      0.11306978762149811),
        },
    },
    "J": {
        "indirect_specular": {
            (6, 13): (0.000326497305650264,
                      0.0002349674905417487,
                      0.0003391893405932933),
            (6, 14): (0.002887309528887272,
                      0.0035556573420763016,
                      0.0043075112625956535),
            (7, 13): (0.001019834540784359,
                      0.0007339355652220547,
                      0.0010594789637252688),
            (7, 14): (0.0025502170901745558,
                      0.0029216110706329346,
                      0.003610842628404498),
        },
        "RGBA": {
            (6, 13): (0.01725391484797001,
                      0.02400815486907959,
                      0.029296061024069786),
            (6, 14): (0.12347862124443054,
                      0.11382157355546951,
                      0.11468144506216049),
            (7, 13): (0.04106851667165756,
                      0.034055013209581375,
                      0.03267502784729004),
            (7, 14): (0.054968927055597305,
                      0.06740691512823105,
                      0.08600299805402756),
        },
    },
}


ROWS = texel_rows(FORMAT_D_FRAMES)


@pytest.fixture(scope="module", params=sorted(FORMAT_D_FRAMES))
def frame(request, tmp_path_factory):
    tag = request.param
    images = FORMAT_D_FRAMES[tag]
    assert chip_smoke.FORMAT_D_FRAMES[tag] == images
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
