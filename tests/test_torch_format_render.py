"""chip_smoke.py phase 32's and phase 34's frames at the reduced size of
tests/test_torch_textured_render.py (16x16, AA 1, one diffuse and one
glossy sample): scenes/textured_disk.ass with its three MayaFile slots
filled from scenes/data/formats or formats_b, rendered by the JAX
package (which
decodes the images with PIL) and by the port on the CPU (its own
decoders), every plane held to that file's PIX_ATOL; at the four pixels
around (7, 13), where the JAX package's jitted frame rounds one glossy
lane the other way (tests/test_torch_textured_render.py), the reference
is the JAX package's op-by-op value of the same frame (OPBYOP, printed by
`tools/textured_opbyop.py --images`), held to OPBYOP_ATOL.

Frame C: the 2048x2048 DXT1 DDS in the grid slot, a run-length TGA as the
logo and a JPEG-compressed TIFF as the inverted logo. Frame D: a QOI grid,
a palette PCX logo and a Group 4 TIFF. Frame E: the 2048x2048 BC7 DDS, a
BC6H SF16 DDS and a DXT3 BLP. Frame F: an ICO whose largest entry is a
32-bit BMP, an it32 run-length ICNS and a palette IM. Measured: every
pixel of every plane within 2.1e-7 (C), 2.8e-7 (D), 2.7e-7 (E) and
2.9e-7 (F) of the JAX frame but the four around (7, 13), which are
within 1.5e-8 (C, E) and 2.3e-8 (F) of the op-by-op values.
"""
import os

import numpy as np
import pytest

import chip_smoke
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import FORMAT_B_FRAMES, FORMAT_FRAMES
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
    "C": {
        "indirect_specular": {
            (6, 13): (0.0003456198319327086,
                      0.0006360777770169079,
                      0.0004239554691594094),
            (6, 14): (0.002887904644012451,
                      0.0035681468434631824,
                      0.004310150630772114),
            (7, 13): (0.0010795650305226445,
                      0.001986828399822116,
                      0.0013242511777207255),
            (7, 14): (0.0025757071562111378,
                      0.003456282429397106,
                      0.003723833942785859),
        },
        "RGBA": {
            (6, 13): (0.008496193215250969,
                      0.010116695426404476,
                      0.01537894457578659),
            (6, 14): (0.08225749433040619,
                      0.09144971519708633,
                      0.12663240730762482),
            (7, 13): (0.027251964434981346,
                      0.030357323586940765,
                      0.04066937044262886),
            (7, 14): (0.06421130150556564,
                      0.07367758452892303,
                      0.11299247294664383),
        },
    },
    "D": {
        "indirect_specular": {
            (6, 13): (0.000721348391380161,
                      0.0008930732728913426,
                      0.0011662838514894247),
            (6, 14): (0.002899603685364127,
                      0.0035761487670242786,
                      0.004333264194428921),
            (7, 13): (0.002253176411613822,
                      0.002789569552987814,
                      0.003642959985882044),
            (7, 14): (0.0030765451956540346,
                      0.003798851976171136,
                      0.004713341593742371),
        },
        "RGBA": {
            (6, 13): (0.009565494023263454,
                      0.010663525201380253,
                      0.01466763112694025),
            (6, 14): (0.08262485265731812,
                      0.09197235107421875,
                      0.12725579738616943),
            (7, 13): (0.040272507816553116,
                      0.0415126197040081,
                      0.05375853180885315),
            (7, 14): (0.06633368879556656,
                      0.07714643329381943,
                      0.12026291340589523),
        },
    },
    "E": {
        "indirect_specular": {
            (6, 13): (0.00034946290543302894,
                      0.0006367731257341802,
                      0.0004315561964176595),
            (6, 14): (0.0028880243189632893,
                      0.0035681684967130423,
                      0.004310387186706066),
            (7, 13): (0.001091569080017507,
                      0.001989000476896763,
                      0.0013479925692081451),
            (7, 14): (0.0025808296632021666,
                      0.0034572093281894922,
                      0.003733965801075101),
        },
        "RGBA": {
            (6, 13): (0.008173111826181412,
                      0.010223816148936749,
                      0.016798950731754303),
            (6, 14): (0.07630208134651184,
                      0.08986224979162216,
                      0.13504676520824432),
            (7, 13): (0.025686118751764297,
                      0.03050980716943741,
                      0.04494917765259743),
            (7, 14): (0.06112447753548622,
                      0.07330381125211716,
                      0.12097515165805817),
        },
    },
    "F": {
        "indirect_specular": {
            (6, 13): (0.000721348391380161,
                      0.0008930732728913426,
                      0.0011662835022434592),
            (6, 14): (0.002899603685364127,
                      0.0035761487670242786,
                      0.004333264194428921),
            (7, 13): (0.002253176411613822,
                      0.002789569552987814,
                      0.0036429590545594692),
            (7, 14): (0.0030765451956540346,
                      0.003798851976171136,
                      0.004713341128081083),
        },
        "RGBA": {
            (6, 13): (0.009920653887093067,
                      0.011375450529158115,
                      0.016796603798866272),
            (6, 14): (0.07296986132860184,
                      0.07834748923778534,
                      0.09973826259374619),
            (7, 13): (0.04294465482234955,
                      0.04377703368663788,
                      0.05394909903407097),
            (7, 14): (0.06558763980865479,
                      0.07382132112979889,
                      0.10365106910467148),
        },
    },
}


FRAMES = {**FORMAT_FRAMES, **FORMAT_B_FRAMES}
ROWS = texel_rows(FRAMES)


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame(request, tmp_path_factory):
    tag = request.param
    images = FRAMES[tag]
    assert {**chip_smoke.FORMAT_FRAMES,
            **chip_smoke.FORMAT_B_FRAMES}[tag] == images
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
