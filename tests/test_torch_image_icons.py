"""The port's ICO, CUR and ICNS decoders (scene/ico.py, scene/icns.py,
behind scene/texture.py::load_image) against PIL and the JAX package's
`load_image(path, 1.0)`: array-equal, no tolerance.

ICO files are PIL's own (PNG entries, and BMP entries at 1, 8, 24 and 32
bits through `bitmap_format="bmp"`) and tools/make_image_formats.py's
(`icon_bytes` over `icon_dib`: BMP and PNG entries at 1, 4, 8, 24 and 32
bits, odd sizes, several entries of one size). PIL opens the first entry of its
sorted directory, so among the largest entries the LOWEST colour depth
wins; a test pins that. CUR files (PIL writes none) are the tool's, and
ICNS files are PIL's (PNG entries) and the tool's (`icns_bytes`: PNG,
raw and run-length RGB entries with their masks, and a JPEG 2000 entry,
which the port refuses). Images are seeded (numpy default_rng, the seed
given in each test).
"""
import io

import numpy as np
import pytest
from PIL import Image

from test_torch_image_formats import _image
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from tools import make_image_modes as modes
from rlshaders_tpu_torch.scene import texture as ttex


def _pil(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _bmp_entry(w: int, h: int, bits: int, seed: int):
    """An icon directory entry and its bitmap of `bits` bits a pixel."""
    rng = np.random.default_rng(seed)
    if bits <= 8:
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, (h, w))
        return (w, h, n % 256, 1, bits, fm.icon_dib(idx, bits, pal))
    px = _image(w, h, seed, 3)
    return (w, h, 0, 1, bits, fm.icon_dib(px, bits, and_mask=bits != 32))


# ---------------------------------------------------------------------------
# ICO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("kind", ["png", "bmp"])
def test_ico_pil(tmp_path, mode, kind):
    """PIL's ICO writer (seed 1): PNG or BMP entries at 16, 32 and 48
    pixels of each mode it writes."""
    img = Image.fromarray(_image(48, 48, 1))
    img = img.quantize(20) if mode == "P" else img.convert(mode)
    kw = {"bitmap_format": "bmp"} if kind == "bmp" else {}
    data = _pil(img, "ICO", sizes=[(16, 16), (32, 32), (48, 48)], **kw)
    assert ttex.image_format(data) == "ICO"
    assert same_as_reference(tmp_path, data).shape == (48, 48, 3)


@pytest.mark.parametrize("size", [(16, 16), (13, 9), (37, 23), (256, 256)],
                         ids=str)
@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_ico_bmp_entries(tmp_path, bits, size):
    """BMP entries of every depth (seed = bits), at odd sizes (their rows
    and AND masks padded) and at 256 (stored as 0 in the directory)."""
    w, h = size
    data = fm.icon_bytes([_bmp_entry(w, h, bits, bits)])
    assert same_as_reference(tmp_path, data).shape == (h, w, 3)


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_ico_png_entries(tmp_path, bits):
    """PNG entries of every depth (seed 10 + bits): palette PNGs at 1, 4
    and 8 bits, RGB at 24 and RGBA at 32, each beside a smaller BMP
    entry."""
    rng = np.random.default_rng(10 + bits)
    w, h = 21, 13
    if bits <= 8:
        plte = rng.integers(0, 256, (1 << bits, 3)).astype(np.uint8)
        png = modes.png_bytes(rng.integers(0, 1 << bits, (h, w)), bits, 3,
                              plte=plte.tobytes())
    else:
        png = modes.png_bytes(_image(w, h, 10 + bits, bits // 8), 8,
                              2 if bits == 24 else 6)
    data = fm.icon_bytes([(w, h, 0, 1, bits, png),
                          _bmp_entry(8, 8, 8, 20 + bits)])
    assert same_as_reference(tmp_path, data).shape == (h, w, 3)


def test_ico_entry_choice(tmp_path):
    """PIL sorts the directory by colour depth, then stable-sorts it by
    area, largest first, and opens the first entry: among the largest
    entries the lowest colour depth wins (an 8-bit entry over a 32-bit
    one listed before it, and over a PNG, whose depth in the directory is
    0 and so 256); among equals, the first in the file."""
    e32 = _bmp_entry(24, 24, 32, 3)
    e8 = _bmp_entry(24, 24, 8, 4)
    e8b = _bmp_entry(24, 24, 8, 5)
    small = _bmp_entry(16, 16, 1, 6)
    png = (24, 24, 0, 0, 0, _pil(Image.fromarray(_image(24, 24, 7)), "PNG"))
    want8 = ttex.decode_image(fm.icon_bytes([e8]))
    for entries in ([e32, e8, small], [small, e8, e32], [png, e32, e8],
                    [e8, e8b, e32]):
        got = same_as_reference(tmp_path, fm.icon_bytes(entries))
        assert np.array_equal(got, want8)
    # a PNG at the size of a 32-bit BMP: 32 beats the PNG's 256
    got = same_as_reference(tmp_path, fm.icon_bytes([png, e32]))
    assert np.array_equal(got, ttex.decode_image(fm.icon_bytes([e32])))
    # the largest entry wins whatever its depth
    big = _bmp_entry(32, 32, 32, 8)
    got = same_as_reference(tmp_path, fm.icon_bytes([e8, big, small]))
    assert got.shape == (32, 32, 3)


def test_ico_truncated_and_mask_raises():
    """An entry whose AND mask runs past the end of the file: PIL raises
    as it reads the mask, and the port raises ValueError."""
    data = fm.icon_bytes([_bmp_entry(16, 16, 8, 9)])
    short = data[:-40]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(short)).convert("RGB")
    with pytest.raises(ValueError):
        ttex.decode_image(short)


# ---------------------------------------------------------------------------
# CUR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_cur_bits(tmp_path, bits):
    """A cursor of each depth (seed 20 + bits), hotspot in place of planes
    and bit count."""
    w, h, n, _, _, dib = _bmp_entry(19, 11, bits, 20 + bits)
    data = fm.icon_bytes([(w, h, n, 3, 5, dib)], cursor=True)
    assert ttex.image_format(data) == "CUR"
    assert same_as_reference(tmp_path, data).shape == (11, 19, 3)


def test_cur_entry_choice(tmp_path):
    """PIL opens the first cursor unless a later one is both wider and
    taller (by the directory's bytes)."""
    a = _bmp_entry(16, 16, 8, 30)
    b = _bmp_entry(32, 16, 24, 31)           # wider, not taller
    c = _bmp_entry(24, 20, 4, 32)            # wider and taller than a
    for entries, want in (([a, b], a), ([a, b, c], c), ([c, a], c)):
        got = same_as_reference(tmp_path, fm.icon_bytes(
            [e[:3] + (1, 1) + e[5:] for e in entries], cursor=True))
        assert got.shape == (want[1], want[0], 3)


def test_cur_png_is_refused():
    """A CUR whose cursor is a PNG: PIL reads it as a bitmap and fails;
    the port names it and refuses it."""
    png = _pil(Image.fromarray(_image(16, 16, 33)), "PNG")
    data = fm.icon_bytes([(16, 16, 0, 1, 1, png)], cursor=True)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(NotImplementedError, match="CUR with a PNG"):
        ttex.decode_image(data)


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------

def test_icns_pil(tmp_path):
    """PIL's ICNS writer: PNG entries of every size from 32 to 1024 pixels
    (seed 40); PIL opens the largest, 1024x1024 (ic10)."""
    img = Image.fromarray(_image(64, 64, 40))
    data = _pil(img, "ICNS")
    assert same_as_reference(tmp_path, data).shape == (1024, 1024, 3)


RGB_TYPES = [(b"is32", b"s8mk", 16), (b"il32", b"l8mk", 32),
             (b"ih32", b"h8mk", 48), (b"it32", b"t8mk", 128)]


@pytest.mark.parametrize("rle", [True, False], ids=["rle", "raw"])
@pytest.mark.parametrize("kind,mask,side", RGB_TYPES,
                         ids=[t[0].decode() for t in RGB_TYPES])
def test_icns_rgb_entries(tmp_path, kind, mask, side, rle):
    """The 24-bit RGB entries with their masks (seed = side): PIL's
    run-length planes, or raw when the entry is exactly three planes."""
    px = _image(side, side, side, 3)
    alpha = np.random.default_rng(side).integers(0, 256, side * side)
    data = fm.icns_bytes([
        (kind, fm.icns_rgb(px, rle, it32=kind == b"it32")),
        (mask, alpha.astype(np.uint8).tobytes())])
    got = same_as_reference(tmp_path, data)
    assert np.array_equal(got, px)


def test_icns_best_size(tmp_path):
    """Of several sizes PIL opens the largest (width, height, scale); of
    that size a PNG entry wins over the RGB entry beside it."""
    small = _image(16, 16, 50, 3)
    mid = _image(32, 32, 51, 3)
    png = modes.png_bytes(_image(128, 128, 52, 3), 8, 2)
    entries = [(b"is32", fm.icns_rgb(small)), (b"il32", fm.icns_rgb(mid))]
    got = same_as_reference(tmp_path, fm.icns_bytes(entries))
    assert np.array_equal(got, mid)
    rgb128 = _image(128, 128, 53, 3)
    entries += [(b"it32", fm.icns_rgb(rgb128, it32=True)), (b"ic07", png)]
    got = same_as_reference(tmp_path, fm.icns_bytes(entries))
    assert np.array_equal(got, _image(128, 128, 52, 3))


def test_icns_jpeg2000_is_refused():
    """A JPEG 2000 entry, which PIL decodes through OpenJPEG, refused
    before the port decoded JPEG 2000: it now decodes as PIL does."""
    j2k = _pil(Image.fromarray(_image(128, 128, 60, 3)), "JPEG2000")
    data = fm.icns_bytes([(b"ic07", j2k)])
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert want.shape == (128, 128, 3)
    assert np.array_equal(ttex.decode_image(data), want)


@pytest.mark.parametrize("cut", ["plane", "mask"])
def test_icns_malformed_raises(cut):
    """A run-length plane that overruns its pixels, or a mask past the end
    of the file: PIL raises, and the port raises ValueError."""
    px = _image(16, 16, 70, 3)
    if cut == "plane":
        body = bytes([0x80 + 127, 7]) * 3 + fm.icns_rgb(px)
        data = fm.icns_bytes([(b"is32", body)])
    else:
        data = fm.icns_bytes([(b"is32", fm.icns_rgb(px)),
                              (b"s8mk", bytes(100))])
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError):
        ttex.decode_image(data)
