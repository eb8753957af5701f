"""The port's BLP, IM, MSP, XBM and SPIDER decoders (scene/blp.py, im.py,
msp.py, xbm.py, spider.py, behind scene/texture.py::load_image) against
PIL and the JAX package's `load_image(path, 1.0)`: array-equal, no
tolerance.

PIL writes palette BLP1 and BLP2, IM of every mode its writer takes, MSP
version 1, XBM and SPIDER; tools/make_image_formats.py writes the rest:
BLP1 with JPEG data (`blp_jpeg`), BLP2 with DXT1, DXT3 and DXT5 blocks
(`blp_dxt`, the blocks from PIL's DDS writer), MSP version 2
(`msp2_bytes`) and SPIDER in either byte order, of any file type and
stack layout (`spider_bytes`). Widths that are not multiples of 4 (or
of 8) are among the sizes: PIL reads a BLP's DXT block rows as one
pixel stream, so their padding pixels move into the next row, and the
port keeps that. Images are seeded (numpy default_rng, the seed given
in each test).
"""
import io
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_image_formats import _image
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from rlshaders_tpu_torch.scene import dds
from rlshaders_tpu_torch.scene import texture as ttex

SIZES = [(1, 1), (5, 3), (13, 9), (37, 23)]   # (width, height)


def _pil(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _same(tmp_path, data: bytes, fmt: str) -> np.ndarray:
    assert ttex.image_format(data) == fmt
    return same_as_reference(tmp_path, data)


# ---------------------------------------------------------------------------
# BLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
def test_blp_palette(tmp_path, version, alpha, size):
    """PIL's BLP writer (palette indices; an RGBA palette sets the alpha
    flag), seed = width."""
    w, h = size
    img = Image.fromarray(_image(w, h, w))
    img = img.quantize(7) if not alpha else img.convert("RGBA").quantize(7)
    _same(tmp_path, _pil(img, "BLP", blp_version=version), "BLP")


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK"])
def test_blp1_jpeg(tmp_path, mode, size):
    """BLP1 with JPEG data (seed = width + 1): three components read back
    as BGR, one as grey, four as CMYK whatever the Adobe marker says."""
    w, h = size
    _same(tmp_path, fm.blp_jpeg(_image(w, h, w + 1, 3), mode=mode), "BLP")


def test_blp1_jpeg_alpha_flag(tmp_path):
    """The alpha flag on JPEG data: PIL reads the RGB stream into its
    RGBA image all the same."""
    data = bytearray(fm.blp_jpeg(_image(13, 9, 2, 3)))
    data[8] = 1
    _same(tmp_path, bytes(data), "BLP")


@pytest.mark.parametrize("size", SIZES + [(300, 200)], ids=str)
@pytest.mark.parametrize("kind,alpha", [
    ("DXT1", 0), ("DXT1", 1), ("DXT3", 1), ("DXT5", 1), ("DXT3", 0),
    ("DXT5", 0)])
def test_blp2_dxt(tmp_path, kind, alpha, size):
    """BLP2 DXT blocks (seed = width + 2) as PIL's own Python decoders
    decode them: widths that are not multiples of 4 move each block row's
    padding into the next row, and DXT3 or DXT5 without the alpha flag
    read their RGBA stream as RGB."""
    w, h = size
    _same(tmp_path, fm.blp_dxt(_image(w, h, w + 2), kind, alpha), "BLP")


def test_blp2_dxt1_is_not_bcndecode():
    """PIL's BLP DXT1 widens 5-6-5 end points by a shift alone, its DDS
    decoder (BcnDecode.c) by bit replication: the same blocks decode to
    other bytes, so the BLP path has its own decoder."""
    px = _image(16, 16, 3)
    blp = fm.blp_dxt(px, "DXT1", 0)
    dds_file = fm._pil(px, "RGBA", "DDS", pixel_format="DXT1")
    assert blp[-128:] == dds_file[-128:]
    a, b = ttex.decode_image(blp), dds.decode_dds(dds_file)
    assert not np.array_equal(a, b)
    assert np.abs(a.astype(int) - b).max() <= 8


def test_blp2_raw_bgra_is_refused():
    """Encoding 3 (raw BGRA), which PIL does not decode either, raises
    NotImplementedError naming it."""
    data = fm.blp_bytes(b"BLP2", 4, 4, bytes(64), encoding=3)
    with pytest.raises(NotImplementedError):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(NotImplementedError, match="BLP2 encoding 3.*BGRA"):
        ttex.decode_image(data)


def test_blp_truncated_raises():
    data = fm.blp_dxt(_image(16, 16, 4), "DXT5")[:-20]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError):
        ttex.decode_image(data)


# ---------------------------------------------------------------------------
# IM
# ---------------------------------------------------------------------------

def _im_source(mode: str, w: int, h: int, seed: int) -> Image.Image:
    rng = np.random.default_rng(seed)
    px = _image(w, h, seed)
    if mode == "P":
        return Image.fromarray(px).convert("RGB").quantize(9)
    if mode == "PA":
        return Image.fromarray(px).convert("RGB").quantize(9).convert("PA")
    if mode == "I":
        return Image.fromarray(rng.integers(-300, 600, (h, w)).astype(
            np.int32), "I")
    if mode == "F":
        f = (rng.standard_normal((h, w)) * 150 + 100).astype(np.float32)
        f.flat[:3] = (np.nan, np.inf, -np.inf)
        return Image.fromarray(f, "F")
    if mode.startswith("I;16"):
        v = rng.integers(0, 700, (h, w)).astype(">u2" if mode == "I;16B"
                                                else "<u2")
        return Image.frombytes(mode, (w, h), v.tobytes())
    return Image.fromarray(px).convert(mode)


IM_MODES = ["1", "L", "LA", "P", "PA", "I", "I;16", "I;16L", "I;16B", "F",
            "RGB", "RGBA", "RGBX", "CMYK", "YCbCr"]


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("mode", IM_MODES)
def test_im_pil_modes(tmp_path, mode, size):
    """Every mode PIL's IM writer takes (seed = width + 3): 1-bit white
    where set, palettes through the Lut, I and I;16 clamped to 255, F
    truncated and clamped (NaN 0), CMYK by MULDIV255, YCbCr by PIL's own
    tables."""
    w, h = size
    _same(tmp_path, _pil(_im_source(mode, w, h, w + 3), "IM"), "IM")


def test_im_ycbcr_conversion_is_pils():
    """The YCbCr to RGB tables against PIL's conversion of every (Cb, Cr)
    at eight values of Y."""
    from rlshaders_tpu_torch.scene.im import ycbcr_to_rgb

    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 1, 37, 100, 128, 200, 254, 255):
        px = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        want = np.asarray(Image.fromarray(px, "YCbCr").convert("RGB"))
        assert np.array_equal(ycbcr_to_rgb(px), want), y


def test_im_grey_lut_reads_indices(tmp_path):
    """A palette IM whose Lut is grey but not a ramp: PIL opens it as "L"
    and ignores the Lut, so the indices are the grey values."""
    img = Image.fromarray(np.arange(60, dtype=np.uint8).reshape(6, 10))
    img = img.convert("P")
    img.putpalette([v for i in range(256) for v in (255 - i,) * 3])
    got = _same(tmp_path, _pil(img, "IM"), "IM")
    assert np.array_equal(got[..., 0], np.arange(60).reshape(6, 10))


def test_im_header_fields(tmp_path):
    """A hand header with a comment, a CRLF, the default greyscale type and
    two frames: the first frame is read."""
    w, h = 7, 3
    head = (b"Comment: made by hand\r\nImage size (x*y): 7*3\r\n"
            b"File size (no of images): 2\n")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    px = np.arange(2 * w * h, dtype=np.uint8)
    got = _same(tmp_path, head + px.tobytes(), "IM")
    assert np.array_equal(got[::-1, :, 0], px[:w * h].reshape(h, w))


def test_im_types_pil_does_not_write_raise():
    head = b"Image type: RGB3 image\r\nImage size (x*y): 2*2\r\n"
    data = head + b"\0" * (511 - len(head)) + b"\x1a" + bytes(12)
    assert ttex.image_format(data) == "IM"
    with pytest.raises(NotImplementedError, match="RGB3"):
        ttex.decode_image(data)


# ---------------------------------------------------------------------------
# MSP, XBM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES + [(64, 5)], ids=str)
@pytest.mark.parametrize("version", [1, 2])
def test_msp(tmp_path, version, size):
    """Version 1 (PIL's writer) and version 2 (run-length rows, all-white
    rows empty), seed = width + 4."""
    w, h = size
    bits = _image(w, h, w + 4, 1)[..., 0] > 100
    bits[0] = True                                 # an all-white row
    if version == 1:
        data = _pil(Image.fromarray(bits), "MSP")
    else:
        data = fm.msp2_bytes(bits)
    got = _same(tmp_path, data, "MSP")
    assert np.array_equal(got[..., 0] == 255, bits)


def test_msp2_row_length_moves_the_rest(tmp_path):
    """A version-2 row that decodes to a byte more than a row: PIL reads
    the joined rows as one stream, so the rows after it move."""
    bits = _image(16, 4, 5, 1)[..., 0] > 100
    data = bytearray(fm.msp2_bytes(bits))
    h = 4
    lens = np.frombuffer(bytes(data[32:32 + 2 * h]), "<u2")
    row0 = 32 + 2 * h
    data[row0:row0 + lens[0]] = b""
    new = bytes([0, 3, 0x0F])                       # three bytes, not two
    data[row0:row0] = new
    data[32:34] = len(new).to_bytes(2, "little")
    _same(tmp_path, bytes(data), "MSP")


def test_msp_bad_checksum_is_not_msp():
    data = bytearray(_pil(Image.new("1", (8, 2)), "MSP"))
    data[24] ^= 1
    assert ttex.image_format(bytes(data)) == "an unknown format"


@pytest.mark.parametrize("size", SIZES + [(64, 5)], ids=str)
def test_xbm_pil(tmp_path, size):
    """PIL's XBM writer, seed = width + 5."""
    w, h = size
    bits = _image(w, h, w + 5, 1)[..., 0] > 100
    got = _same(tmp_path, _pil(Image.fromarray(bits), "XBM"), "XBM")
    assert np.array_equal(got[..., 0] == 255, bits)


def test_xbm_by_hand(tmp_path):
    """A hand XBM with a hotspot, upper-case hex, other text between the
    bytes and a byte whose second character is not a hex digit (read as
    0, as XbmDecode.c reads it)."""
    data = (b"#define t_width 10\n#define t_height 2\n"
            b"#define t_x_hot 1\n#define t_y_hot 0\n"
            b"static unsigned char t_bits[] = {\n"
            b"  0xA5, 0x03 /* a comment */, 0x5,\n0xFF };\n")
    got = _same(tmp_path, data, "XBM")
    assert got.shape == (2, 10, 3)


def test_xbm_short_data_raises():
    data = b"#define t_width 8\n#define t_height 2\nchar t_bits[] = {0x01};"
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError):
        ttex.decode_image(data)



# ---------------------------------------------------------------------------
# SPIDER
# ---------------------------------------------------------------------------

def _refused(data: bytes) -> None:
    """PIL opens no image from the bytes."""
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")


@pytest.mark.parametrize("mode", ["L", "F"])
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_spider_pil(tmp_path, size, mode):
    """PIL's SPIDER writer (it writes mode "F" from "L" too; seed = width
    + height); "F" samples past 0..255, negative and fractional: the RGB
    conversion truncates toward zero and clamps."""
    w, h = size
    grey = _image(w, h, w + h, 1)[..., 0]
    img = Image.fromarray(grey)
    if mode == "F":
        img = Image.fromarray(grey.astype(np.float32) * 2.37 - 100.5)
    data = _pil(img, "SPIDER")
    got = _same(tmp_path, data, "SPIDER")
    if mode == "L":
        assert np.array_equal(got[..., 0], grey)


@pytest.mark.parametrize("order", ["<", ">"])
def test_spider_byte_orders_and_values(tmp_path, order):
    """Both byte orders (PIL tries big-endian first); NaN, infinities,
    values at and around 0 and 255."""
    px = np.array([[0.4, 1.6, -0.5, 255.9, 254.999, 256.0],
                   [-3.0, 127.5, np.nan, np.inf, -np.inf, 1e30]], np.float32)
    got = _same(tmp_path, fm.spider_bytes(px, order), "SPIDER")
    assert got[..., 0].tolist() == [[0, 1, 0, 255, 254, 255],
                                    [0, 127, 0, 255, 0, 255]]


def test_spider_volume_stack_and_header_length(tmp_path):
    """A volume of file type 1 (nslice 3) opens its first slice; a stack
    its first image, after the stack's header and the image's own; a
    header of more records than it needs (labrec 9)."""
    px = _image(7, 5, 3, 1)[..., 0].astype(np.float32)
    vol = fm.spider_bytes(np.concatenate([px, px + 50, px + 90]), nslice=3,
                          fields={2: 5, 3: 5})
    assert np.array_equal(_same(tmp_path, vol, "SPIDER")[..., 0], px)
    stack = fm.spider_bytes(px, ">", stack=4)
    assert np.array_equal(_same(tmp_path, stack, "SPIDER")[..., 0], px)
    _same(tmp_path, fm.spider_bytes(px, labrec=9), "SPIDER")


@pytest.mark.parametrize("iform", [3, -11, -12, -21, -22])
def test_spider_kinds_pil_refuses(iform):
    """A volume of file type 3 and the Fourier forms pass PIL's header
    test and fail its reader (it opens 2D images only): the port names
    and refuses them."""
    data = fm.spider_bytes(np.zeros((4, 6), np.float32), iform=iform,
                           nslice=2 if iform == 3 else 1)
    _refused(data)
    assert ttex.image_format(data) == "SPIDER"
    with pytest.raises(NotImplementedError, match="SPIDER.*iform"):
        ttex.decode_image(data)


def test_spider_refusals():
    """An image of a stack read alone (PIL's reader fails on it), an
    inconsistent stack header, pixel data that ends early, a header of 0
    bytes: refused as PIL refuses them."""
    px = np.ones((4, 6), np.float32)
    alone = fm.spider_bytes(px, imgnumber=2)
    _refused(alone)
    with pytest.raises(NotImplementedError, match="SPIDER image of a stack"):
        ttex.decode_image(alone)
    for data in (fm.spider_bytes(px, fields={24: 2, 27: 1}),
                 fm.spider_bytes(px)[:-4]):
        _refused(data)
        with pytest.raises(ValueError):
            ttex.decode_image(data)
    zero = fm.spider_bytes(px, fields={13: 0, 22: 0})
    _refused(zero)
    assert ttex.image_format(zero) != "SPIDER"


def test_spider_header_test_takes_any_floats():
    """PIL's header test reads NaN and infinite label fields as not whole
    numbers (no SPIDER file): the port's test too, where it used to raise
    on them, so a file of another format whose first bytes read as such
    floats (a WebP of RIFF size 33023, whose size bytes are an infinite
    big-endian float) is still named and decoded."""
    for v in (np.nan, np.inf, -np.inf):
        data = fm.spider_bytes(np.ones((4, 6), np.float32), fields={1: v})
        _refused(data)
        assert ttex.image_format(data) == "an unknown format"
    one = fm.riff_webp([(b"VP8L", _webp_1x1()[20:])])[12:]
    pad = 33023 - 4 - len(one) - 8 - 1          # one byte left in the RIFF
    webp = (b"RIFF" + struct.pack("<I", 33023) + b"WEBP" + one + b"ABCD"
            + struct.pack("<I", pad) + bytes(pad + 1))
    assert webp[4:8] == b"\xff\x80\x00\x00"
    want = np.asarray(Image.open(io.BytesIO(webp)).convert("RGB"))
    assert ttex.image_format(webp) == "WEBP"
    assert np.array_equal(ttex.decode_image(webp), want)


def _webp_1x1() -> bytes:
    return _pil(Image.fromarray(np.full((1, 1, 3), 77, np.uint8)), "WEBP",
                lossless=True)
