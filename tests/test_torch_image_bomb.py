"""PIL's decompression-bomb limit in every decoder of the port.

PIL's `Image.open` raises DecompressionBombError where the size its plugin
reads from a file's header is past twice `Image.MAX_IMAGE_PIXELS`, and
some plugins check again the image they go on to load (an ICO or ICNS
entry, a BLP's inner JPEG, a GIF frame). The JAX package's texture load
(`Image.open(path).convert("RGB")`) therefore fails on such a file; the
port's decoders raise ValueError naming the limit, from the header, before
any pixel is decoded. Each case here is a header-only file of a few
hundred bytes, built in the test, whose size is just past the limit
(13,380 x 13,380 pixels): decoding it would fail for want of data, so the
bomb error shows that the check came first. The 21,846-byte 1-bit PNG of
that size, whole, is held to PIL as well.
"""
import io
import os
import re
import struct
import time

import pytest
from PIL import Image

from tools import make_image_formats as fm
from rlshaders_tpu_torch.scene import bomb
from rlshaders_tpu_torch.scene import texture as ttex

SIDE = fm.BOMB_SIDE
CASES = fm.bomb_cases()
PIL_MESSAGE = re.escape(f"Image size ({SIDE * SIDE} pixels) exceeds limit "
                        f"of {2 * Image.MAX_IMAGE_PIXELS} pixels")


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_header_past_the_limit(fmt):
    """A header-only file of each decoder, SIDE x SIDE: PIL raises
    DecompressionBombError (at open, or on loading the entry it picks),
    and the port ValueError naming the limit."""
    data, at_open = CASES[fmt]
    assert len(data) < 1500
    assert ttex.image_format(data) == fmt
    with pytest.raises(Image.DecompressionBombError, match=PIL_MESSAGE):
        img = Image.open(io.BytesIO(data))
        assert img.format == fmt and not at_open
        img.convert("RGB")
    with pytest.raises(ValueError, match="decompression bomb limit of "
                       "178956970 pixels"):
        ttex.decode_image(data)


def test_fault_five_png():
    """The 21,846-byte 1-bit PNG of 13,380 x 13,380 pixels, whole: PIL
    refuses it at open, and the port at once, not after decoding 537 MB
    of pixels."""
    data = fm.fault5_png()
    assert len(data) == 21846
    with pytest.raises(Image.DecompressionBombError, match=PIL_MESSAGE):
        Image.open(io.BytesIO(data))
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="decompression bomb"):
        ttex.decode_image(data)
    assert time.perf_counter() - t0 < 1.0


@pytest.mark.parametrize("w, h, past", [
    (178956970, 1, False), (178956971, 1, True), (13377, 13377, False),
    (13377, 13378, True), (0, 178956970, False), (0, 178956971, True),
    (178956971, 0, True), (0, 0, False)])
def test_limit_at_its_boundary(w, h, past):
    """PIL's product of the sides, each at least 1, against twice its
    MAX_IMAGE_PIXELS: 178,956,970 passes, one more raises."""
    assert bomb.MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS
    pixels = max(1, w) * max(1, h)
    assert (pixels > bomb.MAX_PIXELS) == past
    if past:
        with pytest.raises(ValueError, match="decompression bomb"):
            bomb.check("X", w, h)
    else:
        bomb.check("X", w, h)


@pytest.mark.parametrize("fmt", ["QOI", "XBM"])
def test_between_the_limits_goes_on(fmt):
    """Between MAX_IMAGE_PIXELS and twice it PIL only warns and opens the
    file: a header-only QOI or XBM of 9,600 x 9,600 (92,160,000 pixels)
    passes the port's check too, and fails only for want of its data."""
    side = 9600
    data = (b"qoif" + struct.pack(">IIBB", side, side, 3, 0) + bytes(16)
            if fmt == "QOI" else
            f"#define b_width {side}\n#define b_height {side}\n"
            f"static char b_bits[] = {{\n0x00 }};\n".encode())
    with pytest.warns(Image.DecompressionBombWarning):
        assert Image.open(io.BytesIO(data)).size == (side, side)
    with pytest.raises(ValueError) as err:
        ttex.decode_image(data)
    assert "bomb" not in str(err.value)


def test_committed_bomb_files():
    """scenes/bombs (chip_smoke.py phase 41's files, read where there is no
    PIL) holds what `tools/make_image_formats.py bombs` writes: these
    cases and the whole PNG."""
    import chip_smoke
    made = fm.bomb_files()
    assert tuple(sorted(made)) == chip_smoke.BOMB_FILES
    assert sorted(os.listdir(fm.BOMBS)) == sorted(made)
    for name, data in made.items():
        with open(os.path.join(fm.BOMBS, name), "rb") as f:
            assert f.read() == data, name
