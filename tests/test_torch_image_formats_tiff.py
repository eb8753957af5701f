"""The port's TIFF decoder (scene/tiff.py) on JPEG (7) and CCITT (2, 3, 4)
compression, against PIL (over libtiff) and the JAX package's
`load_image(path, 1.0)`: array-equal on every file.

JPEG: PIL's own files (libtiff writes them) of modes RGB (photometric
RGB: the components as they are), L, YCbCr (photometric YCbCr at 1x1:
libjpeg's conversion to RGB), CMYK, RGBA and LA, in one strip or many,
at qualities 50 and 90, the tables in JPEGTables and each strip an
abbreviated stream; and tools/make_image_formats.py's `tiff_jpeg_bytes`
(PIL cannot write them): YCbCr at 4:2:0, 4:2:2 and 4:4:4 in tiles
(padded at the edges) and in strips, upsampled as libjpeg upsamples. PIL
is never asked for a mode "1" or "P" JPEG-compressed TIFF, which aborts
the process.
CCITT: PIL's own files of modified Huffman, Group 3 (one- and
two-dimensional, with fill bits before each EOL), Group 4, each with fill
order 2 and under MinIsWhite, in one strip or many, on seeded images and
on rows wide enough for the extended make-up codes (up to 5000 pixels).
Old-style JPEG (6), which nothing writes, still raises NotImplementedError
naming it; broken data raises ValueError.
"""
import io

import numpy as np
import pytest
from PIL import Image

from test_torch_image_formats import same
from tools import make_image_formats as fm
from rlshaders_tpu_torch.scene.tiff import decode_tiff

SIZES = [(1, 1), (5, 3), (13, 9), (37, 23), (64, 48)]   # (width, height)


def _image(w: int, h: int, seed: int) -> np.ndarray:
    """Smooth gradients with noise and hard edges: every coefficient band
    and long and short runs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                   ((x // 7 + y // 5) % 2) * 200.0, (x * y) % 256], -1)
    px += rng.normal(0, 20, px.shape)
    return np.clip(px, 0, 255).astype(np.uint8)


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "L", "YCbCr", "CMYK", "RGBA", "LA"])
@pytest.mark.parametrize("strips", [False, True], ids=["one", "strips"])
@pytest.mark.parametrize("quality", [50, 90])
def test_jpeg_pil(tmp_path, mode, strips, quality):
    for w, h in SIZES:
        img = Image.fromarray(_image(w, h, w)).convert(mode)
        kw = {"strip_size": max(1, w * len(mode) * 8)} if strips else {}
        data = _pil(img, compression="jpeg", quality=quality, **kw)
        same(tmp_path, data)


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("layout", [dict(tile=(16, 16)),
                                    dict(tile=(32, 48)),
                                    dict(rows_per_strip=16),
                                    dict(rows_per_strip=None)],
                         ids=["tiles16", "tiles32x48", "strips16", "one"])
def test_jpeg_ycbcr_by_hand(tmp_path, subsampling, layout):
    for w, h in SIZES[1:]:
        data = fm.tiff_jpeg_bytes(_image(w, h, h)[..., :3],
                                  subsampling=subsampling, **layout)
        same(tmp_path, data)


CCITT_OPTIONS = [
    ("tiff_ccitt", {}), ("tiff_ccitt", {266: 2}), ("tiff_ccitt", {262: 0}),
    ("group3", {}), ("group3", {292: 1}), ("group3", {292: 4}),
    ("group3", {292: 5}), ("group3", {292: 5, 266: 2}),
    ("group3", {262: 0, 292: 1}), ("group4", {}), ("group4", {266: 2}),
    ("group4", {262: 0}), ("group4", {262: 0, 266: 2}),
]


@pytest.mark.parametrize("compression,tags", CCITT_OPTIONS, ids=str)
@pytest.mark.parametrize("strips", [False, True], ids=["one", "strips"])
def test_ccitt_pil(tmp_path, compression, tags, strips):
    """T4Options bit 0 (two-dimensional rows) and bit 2 (fill bits before
    each EOL), FillOrder 2 (266) and MinIsWhite (262 = 0)."""
    for w, h in SIZES:
        img = Image.fromarray(_image(w, h, w + 1)[..., 2]).convert("1")
        kw = {"strip_size": max(1, (w + 7) // 8 * 3)} if strips else {}
        data = _pil(img, compression=compression, tiffinfo=tags, **kw)
        same(tmp_path, data)


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group3", "group4"])
def test_ccitt_wide_rows(tmp_path, compression):
    """Runs past 1728 and 2560 pixels: the extended make-up codes, a run
    coded as several make-up codes, and rows that end on a change."""
    for w in (1800, 2600, 5000):
        rows = np.zeros((6, w), np.uint8)
        rows[1] = 255
        rows[2, w // 3:] = 255
        rows[3, ::2] = 255
        rows[4, :w - 7] = 255
        rows[5, 100:w - 100:997] = 255
        img = Image.fromarray(rows).convert("1")
        for tags in ({}, {292: 1}):
            same(tmp_path, _pil(img, compression=compression, tiffinfo=tags))


def test_old_style_jpeg_raises():
    data = bytearray(_pil(Image.new("L", (8, 8)), compression="jpeg"))
    at = data.find(b"\x03\x01\x03\x00\x01\x00\x00\x00\x07\x00")
    assert at > 0
    data[at + 8] = 6                       # Compression 7 -> 6
    with pytest.raises(NotImplementedError, match="old-style JPEG"):
        decode_tiff(bytes(data))


@pytest.mark.parametrize("compression", ["jpeg", "group4", "group3",
                                         "tiff_ccitt"])
def test_broken_data_raises(compression):
    img = Image.fromarray(_image(40, 30, 3)[..., 0])
    if compression != "jpeg":
        img = img.convert("1")
    data = bytearray(_pil(img, compression=compression))
    tags = Image.open(io.BytesIO(bytes(data))).tag_v2
    start, count = tags[273][0], tags[279][0]
    data[start + count // 3:start + count] = b"\x00" * (count - count // 3)
    with pytest.raises(ValueError):
        decode_tiff(bytes(data[:start + count // 2]))
