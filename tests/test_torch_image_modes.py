"""The port's image decoders (scene/png.py, jpeg.py, tiff.py, bmp.py,
gif.py behind scene/texture.py::load_image) against the JAX package's
`load_image(path, 1.0)`, which decodes with PIL: array-equal on every
file, no tolerance.

This file holds the committed files of scenes/data/modes (pinned digests,
PIL, the JAX package, the PNG or JPEG each was made from), the dispatch by
content (the format PIL's `open` picks, never the extension; the formats
still refused named), the refusals (a valid file of an unported mode
raises NotImplementedError, malformed data ValueError, one case a
decoder) and the PNG modes: colour types 0, 2, 3, 4 and 6 at every depth
PNG allows, Adam7 or not, on seeded images of several sizes, each row
with a filter drawn at random (tools/make_image_modes.py writes them).
The JPEG, TIFF, BMP and GIF modes are in test_torch_image_jpeg.py,
test_torch_image_tiff.py and test_torch_image_bmp_gif.py.
"""
import hashlib
import io
import os
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import MODE_DIGESTS
from tools import make_image_modes as modes
from rlshaders_tpu_torch.scene import texture as ttex
from rlshaders_tpu_torch.scene.bmp import decode_bmp
from rlshaders_tpu_torch.scene.gif import decode_gif
from rlshaders_tpu_torch.scene.jpeg import decode_jpeg
from rlshaders_tpu_torch.scene.png import decode_png
from rlshaders_tpu_torch.scene.tiff import decode_tiff

SIZES = [(1, 1), (3, 2), (13, 9), (37, 23)]   # (width, height)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the files that re-encode scenes/data/grid.png or logo.png losslessly
LOSSLESS = ("logo_palette_adam7.png", "grid_rgb16.png",
            "logo_rgba16_adam7.png", "logo_lzw_pred2.tif",
            "grid_tiles_deflate_planar2_mm.tif",
            "grid_rgb16_lzw_pred2_mm.tif", "grid_palette_packbits.tif",
            "logo_cmyk_deflate.tif", "logo_4bit.bmp", "grid_rle8.bmp",
            "logo_rle4.bmp", "grid_8bit_topdown_v5.bmp", "grid.gif",
            "logo_interlaced_local.gif")


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def same_as_reference(tmp_path, data: bytes, name: str = "x") -> np.ndarray:
    """The port's load_image of `data` (written to a file) equals the JAX
    package's, and its decode equals PIL's; returns PIL's decode."""
    path = tmp_path / name
    path.write_bytes(data)
    want = pil_rgb(data)
    got = ttex.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    mine = ttex.load_image(str(path))
    ref = jtex.load_image(str(path), 1.0)
    assert mine.dtype == ref.dtype == np.float32
    assert np.array_equal(mine, ref)
    return want


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

MODE_FILES = sorted(MODE_DIGESTS)


def test_digests_cover_the_files():
    """Every file of scenes/data/modes is pinned, in both copies of the
    digests, and the tool writes the committed bytes."""
    names = sorted(f"scenes/data/modes/{n}"
                   for n in os.listdir("scenes/data/modes"))
    assert names == MODE_FILES
    assert chip_smoke.MODE_DIGESTS == MODE_DIGESTS
    made = modes.files()
    for path in MODE_FILES:
        with open(path, "rb") as f:
            assert f.read() == made[os.path.basename(path)], path
    total = sum(os.path.getsize(p) for p in MODE_FILES)
    assert total < 1_500_000, total


@pytest.mark.parametrize("path", MODE_FILES, ids=os.path.basename)
def test_committed_file(tmp_path, path):
    with open(path, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    want = same_as_reference(tmp_path, data, os.path.basename(path))
    assert time.perf_counter() - t0 < 30.0
    assert hashlib.sha256(want.tobytes()).hexdigest() == MODE_DIGESTS[path]
    name = os.path.basename(path)
    source = "grid" if name.startswith("grid") else "logo"
    if name in LOSSLESS:
        ref = jtex.load_image(f"scenes/data/{source}.png", 1.0)
        assert np.array_equal(ttex.load_image(path), ref)
    if name.endswith("_progressive.jpg"):
        # the same quantised coefficients as the baseline file, in another
        # order
        ref = jtex.load_image(f"scenes/data/{source}.jpg", 1.0)
        assert np.array_equal(ttex.load_image(path), ref)


def test_big_texture_is_made_from_the_seed():
    """texture_2048.jpg is progressive, made from a seeded image with the
    grid's dark lines and the logo's colours in it (the file's bytes are
    checked against the tool above)."""
    px = modes.big_texture()
    assert px.shape == (2048, 2048, 3) and px.dtype == np.uint8
    assert np.array_equal(px, modes.big_texture(modes.SEED))
    assert not np.array_equal(px, modes.big_texture(modes.SEED + 1))
    logo = set(map(tuple, modes._png_pixels("logo.png").reshape(-1, 3)))
    assert len(np.unique(px.reshape(-1, 3), axis=0)) > 10_000 > len(logo)
    with open("scenes/data/modes/texture_2048.jpg", "rb") as f:
        assert b"\xff\xc2" in f.read()


# ---------------------------------------------------------------------------
# dispatch by content, and the formats still refused
# ---------------------------------------------------------------------------

def test_format_is_read_from_the_content(tmp_path):
    """A PNG named .jpg and a GIF named .png decode by what they hold."""
    px = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "PNG")
    same_as_reference(tmp_path, buf.getvalue(), "a.jpg")
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "GIF")
    same_as_reference(tmp_path, buf.getvalue(), "a.png")


def _dx10(dxgi: int) -> bytes:
    """A DDS of DXGI format `dxgi` (BC4, BC6H or BC7 blocks of zeros)."""
    from tools.make_image_formats import dds_bytes
    return dds_bytes(8, 8, bytes(128), 0x4, b"DX10", dxgi=dxgi)


# the formats PIL can write that the port did not decode when this list was
# made (and DDS files of block formats), and the name the port gives each
# (PIL's own for a format it decodes: WebP's case keeps the id it had
# when the port named it "WebP"); NOW_DECODED are those it decodes since
OTHER_FORMATS = [("AVIF", "AVIF"), ("DDS BC7", "DDS"), ("ICO", "ICO"),
                 ("EPS", "EPS"), ("ICNS", "ICNS"), ("IM", "IM"),
                 pytest.param("JPEG2000", "JPEG2000",
                              id="JPEG2000-JPEG 2000"),
                 ("BLP", "BLP"), ("MSP", "MSP"),
                 ("DDS BC6H", "DDS"), ("XBM", "XBM"), ("SPIDER", "SPIDER"),
                 ("DDS BC4", "DDS"),
                 pytest.param("WEBP", "WEBP", id="WEBP-WebP")]
_DXGI = {"DDS BC7": 98, "DDS BC6H": 95, "DDS BC4": 80}
NOW_DECODED = {"DDS BC7", "ICO", "ICNS", "IM", "BLP", "MSP", "DDS BC6H",
               "XBM", "DDS BC4", "SPIDER", "WEBP", "JPEG2000", "AVIF"}


def _animated_webp_head() -> bytes:
    """The first 30 bytes of an animated WebP (a VP8X chunk with the
    animation flag) whose RIFF size counts the 200 bytes that follow."""
    vp8x = b"VP8X" + (10).to_bytes(4, "little") + bytes([0x02, 0, 0, 0]) \
        + (15).to_bytes(3, "little") + (15).to_bytes(3, "little")
    return b"RIFF" + (4 + len(vp8x) + 200).to_bytes(4, "little") + b"WEBP" \
        + vp8x


@pytest.mark.parametrize("fmt,name", OTHER_FORMATS)
def test_other_formats_are_named(tmp_path, fmt, name):
    """Each format is named as PIL's `open` names it; those the port does
    not decode raise NotImplementedError naming it, the rest decode as
    the JAX package loads them."""
    key = fmt
    px = np.zeros((16, 16, 3), np.uint8)   # an icon's least size
    px[1, 2] = 200
    # PIL's SPIDER writer registers the saved file's extension as its own
    # for the rest of the process: name each file after its format
    path = tmp_path / f"x.{fmt.lower().replace(' ', '_')}"
    if fmt in _DXGI:
        path.write_bytes(_dx10(_DXGI[fmt]))
        fmt = "DDS"
    else:
        # the modes these writers take
        mode = {"SPIDER": "L", "MSP": "1", "XBM": "1", "BLP": "P"}
        Image.fromarray(px).convert(mode.get(fmt, "RGB")).save(path, fmt)
    assert Image.open(path).format == fmt
    if key in NOW_DECODED:
        assert np.array_equal(ttex.load_image(str(path)),
                              jtex.load_image(str(path), 1.0))
    else:
        with pytest.raises(NotImplementedError, match=name):
            ttex.load_image(str(path))
    with open(path, "rb") as f:
        assert name in ttex.image_format(f.read())


@pytest.mark.parametrize("head,name,error", [
    # a PSD, refused before its slice, is decoded since, and so is a Sun
    # raster; EPS, which PIL opens and cannot load without Ghostscript, is
    # not (the case keeps the id it had when it held a Sun raster's magic)
    pytest.param(b"%!PS-Adobe-3.0 EPSF-3.0\n", "EPS", NotImplementedError,
                 id="Y\xa6j\x95-Sun raster"),
    # a JP2 signature and a VP8X chunk of an animated WebP head formats the
    # port decodes since; followed by zeros, they are malformed, and PIL
    # raises too
    pytest.param(b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JP2", ValueError,
                 id="\x00\x00\x00\x0cjP  \r\n\x87\n-JPEG 2000"),
    pytest.param(_animated_webp_head(), "WebP", ValueError,
                 id="RIFF\x00\x00\x00\x00WEBPVP8L-WebP"),
    pytest.param(b"v/1\x01\x02\x00\x00\x00", "OpenEXR", NotImplementedError,
                 id="v/1\x01\x02\x00\x00\x00-OpenEXR"),
    pytest.param(b"II+\x00\x08\x00\x00\x00", "BigTIFF", NotImplementedError,
                 id="II+\x00\x08\x00\x00\x00-BigTIFF"),
    pytest.param(b"\x00\x01\x02\x03 not an image", "an unknown format",
                 NotImplementedError,
                 id="\x00\x01\x02\x03 not an image-an unknown format")])
def test_signatures_name_the_format(tmp_path, head, name, error):
    path = tmp_path / "x.bin"
    path.write_bytes(head + bytes(200))
    if error is ValueError:
        with pytest.raises(Exception):
            Image.open(path).convert("RGB")
    with pytest.raises(error, match=name):
        ttex.load_image(str(path))


# ---------------------------------------------------------------------------
# refusals: unported modes raise NotImplementedError, bad data ValueError
# ---------------------------------------------------------------------------

def _jpeg_arithmetic() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    data[data.index(b"\xff\xc0") + 1] = 0xC9
    return bytes(data)


def _tiff(compression: int) -> bytes:
    return modes.tiff_bytes(np.zeros((4, 4, 1), np.int64), 8, 1,
                            tags=[(259, 3, [compression])])


def _bmp_jpeg() -> bytes:
    """A BMP holding JPEG data (compression 4), which PIL refuses too."""
    data = bytearray(modes.bmp_bytes(np.zeros((2, 2, 3), np.uint8), 24))
    struct.pack_into("<I", data, 30, 4)
    return bytes(data)


@pytest.mark.parametrize("decode,valid_unported,malformed", [
    (decode_png, None, modes.png_bytes(np.zeros((2, 2, 1)), 8, 0)[:40]),
    (decode_png, None, modes.png_bytes(np.zeros((2, 2, 1)), 8, 0)[:29]
     + b"\x00\x00\x00\x00" + modes.png_bytes(np.zeros((2, 2, 1)), 8, 0)[33:]),
    (decode_jpeg, _jpeg_arithmetic(), b"\xff\xd8\xff\xdb\x00"),
    (decode_tiff, _tiff(6), b"II*\x00\xff\xff\x00\x00"),
    (decode_bmp, _bmp_jpeg(),
     b"BM" + bytes(12) + struct.pack("<I", 40) + bytes(10)),
    (decode_gif, None, b"GIF89a\x02\x00\x02\x00\x00\x00\x00;"),
], ids=["png", "png-crc", "jpeg", "tiff", "bmp", "gif"])
def test_refusals(decode, valid_unported, malformed):
    """A valid file of an unported mode raises NotImplementedError (PNG
    and GIF have none left), malformed data ValueError."""
    if valid_unported is not None:
        with pytest.raises(NotImplementedError):
            decode(valid_unported)
    with pytest.raises(ValueError):
        decode(malformed)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_MODES = [(c, d) for c, depths in {0: (1, 2, 4, 8, 16), 2: (8, 16),
                                      3: (1, 2, 4, 8), 4: (8, 16),
                                      6: (8, 16)}.items() for d in depths]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_MODES)
def test_png_modes(tmp_path, ctype, depth, interlace):
    for w, h in SIZES:
        rng = np.random.default_rng(w * 100 + depth)
        top = 1 << depth
        px = rng.integers(0, top, (h, w, CHANNELS[ctype]))
        plte = None
        if ctype == 3:
            n = min(top, 12)
            px %= n + 1                    # one index past the palette
            plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        data = modes.png_bytes(px, depth, ctype, plte=plte,
                               interlace=interlace, seed=w)
        same_as_reference(tmp_path, data)


def test_png_sixteen_bit_grey_clamps_as_pil():
    """PIL opens 16-bit grey as "I;16" and its RGB clamps every sample to
    255: the JAX package's texture of a normal 16-bit grey image is white
    but where it is darker than 256/65535. The port keeps that quirk."""
    vals = np.array([[0, 100, 255, 256, 55746, 65535]])
    data = modes.png_bytes(vals[..., None], 16, 0)
    assert Image.open(io.BytesIO(data)).mode == "I;16"
    want = [0, 100, 255, 255, 255, 255]
    assert pil_rgb(data)[0, :, 0].tolist() == want
    assert decode_png(data)[0, :, 0].tolist() == want
    # the other 16-bit modes keep the high byte (55746 -> 217)
    rgb = modes.png_bytes(np.array([[[55746, 300, 65535]]]), 16, 2)
    assert decode_png(rgb)[0, 0].tolist() == [217, 1, 255]


def test_png_ancillary_chunks_change_nothing(tmp_path):
    """tRNS (on grey, RGB and palette images), gAMA, sRGB, iCCP and tEXt
    change no RGB value in PIL, nor in the port."""
    rng = np.random.default_rng(5)
    extra = [(b"gAMA", struct.pack(">I", 45455)), (b"sRGB", b"\x00"),
             (b"iCCP", b"p\x00\x00" + zlib.compress(b"profile")),
             (b"tEXt", b"Comment\x00made by a test")]
    cases = [(rng.integers(0, 256, (6, 5, 1)), 0, None, b"\x00\x07"),
             (rng.integers(0, 256, (6, 5, 3)), 2, None,
              b"\x00\x01\x00\x02\x00\x03"),
             (rng.integers(0, 4, (6, 5, 1)), 3,
              bytes(range(12)), b"\x00\x80")]
    for px, ctype, plte, trns in cases:
        data = modes.png_bytes(px, 8, ctype, plte=plte, trns=trns,
                               extra_chunks=extra)
        same_as_reference(tmp_path, data)
