"""chip_smoke.py phase 44's frames at the reduced size of
tests/test_torch_textured_render.py (16x16, AA 1, one diffuse and one
glossy sample): scenes/textured_disk.ass with its three MayaFile slots
filled from scenes/data/formats_g, rendered by the JAX package (which
decodes the images with PIL) and by the port on the CPU (its own
decoders), every plane held to that file's PIX_ATOL; at the four pixels
around (7, 13), where the JAX package's jitted frame rounds one glossy
lane the other way (tests/test_torch_textured_render.py), the reference
is the JAX package's op-by-op value of the same frame (OPBYOP, printed by
`tools/textured_opbyop.py --images`), held to OPBYOP_ATOL. Both frames'
JAX texel tables are padded to one shape (`padded`), so the file compiles
the JAX render once.

Frame O: the 1024x1024 float32 height map (Deflate, floating-point
predictor) in the grid slot, a 16-bit signed TIFF as the logo and an RLE
RGB PSD with a layer section as the inverted logo. Frame P: a
2x2-subsampled YCbCr LZW TIFF, an sYCC JP2 and an AVIF libavif scales
from 300x200 to its 360x240 ispe.
"""
import os

import numpy as np
import pytest

import chip_smoke
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import FORMAT_G_FRAMES
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
    "O": {
        "indirect_specular": {
            (6, 13): (0.00036701143835671246, 0.0004526302218437195,
                      0.0005481234984472394),
            (6, 14): (0.0028885705396533012, 0.003562434809282422,
                      0.00431401701644063),
            (7, 13): (0.0011463830014690757, 0.0014138184487819672,
                      0.0017120977863669395),
            (7, 14): (0.0026042216923087835, 0.0032117508817464113,
                      0.0038893474265933037),
        },
        "RGBA": {
            (6, 13): (0.009355945512652397, 0.009321597404778004,
                      0.010979831218719482),
            (6, 14): (0.08773738145828247, 0.08561737090349197,
                      0.0848836675286293),
            (7, 13): (0.03234928846359253, 0.03038276918232441,
                      0.028722699731588364),
            (7, 14): (0.06810571253299713, 0.06600699573755264,
                      0.06474526226520538),
        },
    },
    "P": {
        "indirect_specular": {
            (6, 13): (0.0007159761735238135, 0.0008930732728913426,
                      0.0011609233915805817),
            (6, 14): (0.0028994365129619837, 0.0035761487670242786,
                      0.004333097022026777),
            (7, 13): (0.002236396074295044, 0.002789569552987814,
                      0.0036262162029743195),
            (7, 14): (0.0030693840235471725, 0.003798851976171136,
                      0.004706196486949921),
        },
        "RGBA": {
            (6, 13): (0.01283179223537445, 0.01446789875626564,
                      0.019525857642292976),
            (6, 14): (0.08212843537330627, 0.09262137115001678,
                      0.12714873254299164),
            (7, 13): (0.03964309021830559, 0.041472241282463074,
                      0.053206298500299454),
            (7, 14): (0.06537064909934998, 0.07711855322122574,
                      0.11947407573461533),
        },
    },
}


ROWS = texel_rows(FORMAT_G_FRAMES)


@pytest.fixture(scope="module", params=sorted(FORMAT_G_FRAMES))
def frame(request, tmp_path_factory):
    tag = request.param
    images = FORMAT_G_FRAMES[tag]
    assert chip_smoke.FORMAT_G_FRAMES[tag] == images
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
