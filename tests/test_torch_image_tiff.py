"""The port's TIFF decoder (scene/tiff.py) against PIL and the JAX
package's `load_image(path, 1.0)`: array-equal on every file PIL reads.

Every sample layout of PIL's OPEN_INFO for unsigned samples that the port
decodes (MinIsWhite and MinIsBlack grey of 1, 2, 4, 8 and 16 bits, grey
and alpha, RGB of 8 and 16 bits with unused, associated or unassociated
extra samples, palette of 1, 4 and 8 bits with and without an extra
sample, CMYK of 8 and 16 bits) is written by tools/make_image_modes.py's
`tiff_bytes` in both byte orders, with no compression, LZW, Deflate and
PackBits, predictor 1 and 2, planar configuration 1 and 2, in strips of
5 rows and in 16x16 tiles (partial at the edges): 64 files a layout.
Where PIL reads the file, the port equals it, except the planar layouts
PIL misreads (uncompressed 16-bit or two-sample planes, an associated
alpha, four planes in edge tiles, one plane whose raw mode is longer than
a letter) or reads only in tiles (an unused extra sample), which the port
refuses with NotImplementedError; where PIL
cannot read it, the port raises NotImplementedError too. PIL's own TIFFs
(every mode it writes, with each compression it writes) and the other
refusals (JPEG compression, fill order 2, old-style LZW, transposing
orientations, float samples) follow.
"""
import io
import itertools

import numpy as np
import pytest
from PIL import Image

from test_torch_image_modes import pil_rgb, same_as_reference
from tools.make_image_modes import tiff_bytes
from rlshaders_tpu_torch.scene.tiff import decode_tiff

LAYOUTS = [
    (0, 1, 1, ()), (0, 2, 1, ()), (0, 4, 1, ()), (0, 8, 1, ()),
    (0, 16, 1, ()), (1, 1, 1, ()), (1, 2, 1, ()), (1, 4, 1, ()),
    (1, 8, 1, ()), (1, 16, 1, ()), (1, 8, 2, (2,)), (2, 8, 3, ()),
    (2, 8, 4, ()), (2, 8, 4, (0,)), (2, 8, 4, (1,)), (2, 8, 4, (2,)),
    (2, 8, 4, (999,)), (2, 16, 3, ()), (2, 16, 4, ()), (2, 16, 4, (0,)),
    (2, 16, 4, (1,)), (2, 16, 4, (2,)), (2, 8, 5, (1, 0)),
    (2, 8, 6, (2, 0, 0)), (3, 1, 1, ()), (3, 4, 1, ()), (3, 8, 1, ()),
    (3, 8, 2, (0,)), (3, 8, 2, (2,)), (5, 8, 4, ()), (5, 16, 4, ()),
    (5, 8, 5, (0,)),
]


def _refused(photo, n, bits, extra, compression, planar, tile) -> bool:
    """The planar layouts the port refuses although PIL reads them."""
    premultiplied = extra[:1] == (1,)
    one_letter = (photo, bits) in ((1, 1), (1, 8), (3, 8))
    return planar == 2 and (0 in extra or (compression == 1 and (
        bits == 16 or n == 2 or premultiplied or (tile and n > 3)
        or (n == 1 and not one_letter))))


@pytest.mark.parametrize("photo,bits,n,extra", LAYOUTS)
def test_layout(tmp_path, photo, bits, n, extra):
    rng = np.random.default_rng(photo * 100 + bits + n)
    h, w = 19, 23
    checked = 0
    for order, comp, pred, planar, tile in itertools.product(
            ("II", "MM"), (1, 5, 8, 32773), (1, 2), (1, 2),
            (None, (16, 16))):
        s = rng.integers(0, 1 << bits, (h, w, n))
        cmap = None
        if photo == 3:
            s[..., 0] %= min(1 << bits, 7)
            cmap = rng.integers(0, 65536, 3 * (1 << bits)).tolist()
        data = tiff_bytes(s, bits, photo, order=order, compression=comp,
                          predictor=pred, planar=planar, tile=tile,
                          rows_per_strip=5, extra=extra, colormap=cmap)
        try:
            pil_rgb(data)
        except Exception:                 # PIL has no mode for the file
            with pytest.raises(NotImplementedError):
                decode_tiff(data)
            continue
        if _refused(photo, n, bits, extra, comp, planar, tile):
            with pytest.raises(NotImplementedError, match="planar"):
                decode_tiff(data)
            continue
        same_as_reference(tmp_path, data)
        checked += 1
    assert checked >= 16


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "packbits",
                                         "tiff_deflate",
                                         "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "CMYK",
                                  "LA", "I;16"])
def test_pil_written(tmp_path, mode, compression):
    rng = np.random.default_rng(len(mode))
    img = Image.fromarray(rng.integers(0, 256, (29, 31, 3), np.uint8))
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 600, (29, 31)).astype(
            np.uint16))
    elif mode == "RGBA":
        img = Image.fromarray(rng.integers(0, 256, (29, 31, 4), np.uint8))
    else:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "TIFF", **({"compression": compression}
                             if compression else {}))
    same_as_reference(tmp_path, buf.getvalue())


def test_conversions_are_pils():
    """CMYK (100, 50, 25, 128) is (77, 102, 115): (255 - C)(255 - K)/255
    in Pillow's rounding; MinIsWhite inverts 8-bit grey but not 16-bit
    grey, which clamps; an associated alpha divides the colour, floored."""
    cmyk = tiff_bytes(np.array([[[100, 50, 25, 128]]]), 8, 5)
    assert decode_tiff(cmyk)[0, 0].tolist() == [77, 102, 115]
    white = tiff_bytes(np.array([[[0], [200]]]), 8, 0)
    assert decode_tiff(white)[0, :, 0].tolist() == [255, 55]
    wide = tiff_bytes(np.array([[[100], [55746]]]), 16, 0)
    assert decode_tiff(wide)[0, :, 0].tolist() == [100, 255]
    pre = tiff_bytes(np.array([[[100, 50, 20, 128], [10, 200, 30, 7],
                                [9, 9, 9, 0]]]), 8, 2, extra=(1,))
    assert decode_tiff(pre)[0].tolist() == [[199, 99, 39], [255, 255, 255],
                                            [0, 0, 0]]
    for data in (cmyk, white, wide, pre):
        assert np.array_equal(decode_tiff(data), pil_rgb(data))


@pytest.mark.parametrize("tags,what", [
    ([(259, 3, [6])], "old-style JPEG compression"),
    ([(259, 3, [34676])], "SGILog"),
    ([(259, 3, [50001])], "WebP"),
    ([(266, 3, [2])], "fill order 2"),
    ([(274, 3, [6])], "orientation"),
    ([(339, 3, [3])], "floating point"),
])
def test_refusals(tags, what):
    data = tiff_bytes(np.zeros((4, 4, 1), np.int64), 8, 1, tags=tags)
    with pytest.raises(NotImplementedError, match=what):
        decode_tiff(data)


def test_old_style_lzw_raises():
    data = bytearray(tiff_bytes(np.zeros((4, 4, 1), np.int64), 8, 1,
                                compression=5))
    data[8:10] = b"\x00\x01"
    with pytest.raises(NotImplementedError, match="old-style"):
        decode_tiff(bytes(data))
