"""chip_smoke.py phase 46's and phase 48's frames at the reduced size of
tests/test_torch_textured_render.py (16x16, AA 1, one diffuse and one
glossy sample): scenes/textured_disk.ass with its three MayaFile slots
filled from scenes/data/formats_h or formats_i, rendered by the JAX
package (which decodes the images with PIL) and by the port on the CPU
(its own decoders), every plane held to that file's PIX_ATOL; at the
four pixels
around (7, 13), where the JAX package's jitted frame rounds one glossy
lane the other way (tests/test_torch_textured_render.py), the reference
is the JAX package's op-by-op value of the same frame (OPBYOP, printed by
`tools/textured_opbyop.py --images`), held to OPBYOP_ATOL. The frames'
JAX texel tables are padded to one shape (`padded`), so the file compiles
the JAX render once for all four frames.

Frame Q: the 2048x2048 texture at 1024x1024 as a LAB TIFF under ZSTD in
the grid slot, a 512x512 ZSTD TIFF tiled 256x256 with predictor 2 as the
logo and a 24-bit RLE Sun raster as the inverted logo. Frame R: an RLE
LAB PSD, an XPM and a DXT1 FTEX. Frame S: a 640x480 FLC (one BRUN
frame), the 768x512 PhotoCD and a progressive JPEG cut after its fourth
scan (libjpeg's block smoothing). Frame T: a 512x512 16-bit GZIP_1 FITS,
an RGB IPTC file of one band and a damaged baseline JPEG whose samples
follow libjpeg-turbo's SIMD IDCT.
"""
import os

import numpy as np
import pytest

import chip_smoke
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import FORMAT_H_FRAMES, FORMAT_I_FRAMES
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
    "Q": {
        "indirect_specular": {
            (6, 13): (0.0003465802001301199,
                      0.0006358312675729394,
                      0.0004320535808801651),
            (6, 14): (0.0028879346791654825,
                      0.003568139160051942,
                      0.004310403019189835),
            (7, 13): (0.0010825647041201591,
                      0.0019860584288835526,
                      0.0013495462480932474),
            (7, 14): (0.002576987026259303,
                      0.0034559539053589106,
                      0.0037346286699175835),
        },
        "RGBA": {
            (6, 13): (0.005399489309638739,
                      0.005269540473818779,
                      0.007912854664027691),
            (6, 14): (0.06554572284221649,
                      0.04687153548002243,
                      0.03828192874789238),
            (7, 13): (0.0176335908472538,
                      0.015267356298863888,
                      0.017459416761994362),
            (7, 14): (0.02987140789628029,
                      0.013591254130005836,
                      0.030793121084570885),
        },
    },
    "R": {
        "indirect_specular": {
            (6, 13): (0.0014223149046301842,
                      0.001640412607230246,
                      0.0016524253878742456),
            (6, 14): (0.0029214294627308846,
                      0.003599418792873621,
                      0.004348401445895433),
            (7, 13): (0.004442689009010792,
                      0.005123930983245373,
                      0.005161453504115343),
            (7, 14): (0.00401091855019331,
                      0.004795039538294077,
                      0.005361358169466257),
        },
        "RGBA": {
            (6, 13): (0.014860333874821663,
                      0.014001930132508278,
                      0.01521762739866972),
            (6, 14): (0.12329447269439697,
                      0.11276160925626755,
                      0.1129993200302124),
            (7, 13): (0.07284754514694214,
                      0.06647072732448578,
                      0.060571614652872086),
            (7, 14): (0.06075900048017502,
                      0.07783837616443634,
                      0.09742662310600281),
        },
    },
    "S": {
        "indirect_specular": {
            (6, 13): (0.0004283149028196931,
                      0.00037521476042456925,
                      0.00032497619395144284),
            (6, 14): (0.0028904795181006193,
                      0.0035600243136286736,
                      0.004307068884372711),
            (7, 13): (0.0013378681614995003,
                      0.0011720064794644713,
                      0.0010150832822546363),
            (7, 14): (0.002685937797650695,
                      0.003108557779341936,
                      0.003591896966099739),
        },
        "RGBA": {
            (6, 13): (0.004974301904439926,
                      0.006212173495441675,
                      0.007419315632432699),
            (6, 14): (0.04192480072379112,
                      0.036843191832304,
                      0.054625045508146286),
            (7, 13): (0.022516516968607903,
                      0.019424162805080414,
                      0.013202288188040257),
            (7, 14): (0.022907719016075134,
                      0.018978051841259003,
                      0.032392390072345734),
        },
    },
    "T": {
        "indirect_specular": {
            (6, 13): (0.0004552360624074936,
                      0.0005614364636130631,
                      0.0006798849790357053),
            (6, 14): (0.002891317941248417,
                      0.003565822960808873,
                      0.004318119026720524),
            (7, 13): (0.0014219580916687846,
                      0.0017536814557388425,
                      0.002123662969097495),
            (7, 14): (0.002721823286265135,
                      0.0033567871432751417,
                      0.004064982291311026),
        },
        "RGBA": {
            (6, 13): (0.056024882942438126,
                      0.008317015133798122,
                      0.0052147903479635715),
            (6, 14): (0.037430353462696075,
                      0.09107962995767593,
                      0.023755868896842003),
            (7, 13): (0.00605706637725234,
                      0.029793091118335724,
                      0.006888851523399353),
            (7, 14): (0.007444624789059162,
                      0.07342138886451721,
                      0.007810684852302074),
        },
    },
}


FRAMES = {**FORMAT_H_FRAMES, **FORMAT_I_FRAMES}
ROWS = texel_rows(FRAMES)


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame(request, tmp_path_factory):
    tag = request.param
    images = FRAMES[tag]
    assert {**chip_smoke.FORMAT_H_FRAMES,
            **chip_smoke.FORMAT_I_FRAMES}[tag] == images
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
