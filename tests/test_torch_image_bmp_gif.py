"""The port's BMP and GIF decoders (scene/bmp.py, scene/gif.py) against
PIL and the JAX package's `load_image(path, 1.0)`: array-equal on every
file.

BMP: 1-, 4- and 8-bit palettes, 16-bit 5-5-5 and bitfields 5-6-5 and
5-5-5, 24 and 32 bits, 32-bit bitfields, RLE8 and RLE4, bottom-up and
top-down rows, OS/2 1.x, BITMAPINFOHEADER, V4 and V5 headers, at sizes
whose rows need padding (tools/make_image_modes.py's `bmp_bytes`), and
PIL's own 1-, 8- and 24-bit files; PIL's quirks: 5- and 6-bit channels
widened as v * 255 // 31 and // 63, a grey-ramp palette dropped (an index
past it reads as its own grey), the RLE delta escape read as PIL reads it.
GIF: global and local tables (and identity ramps, PIL's mode "L"), code
sizes 2-8, interlaced rows, a frame at an offset inside the screen and
one reaching past it, a transparency index; PIL's own GIFs and GIF87a.
"""
import io
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_image_modes import pil_rgb, same_as_reference
from tools.make_image_modes import bmp_bytes, gif_bytes
from rlshaders_tpu_torch.scene.bmp import decode_bmp

SIZES = [(1, 1), (5, 3), (13, 17), (33, 8)]    # (width, height)
BMP_MODES = [
    (1, 0, None), (4, 0, None), (8, 0, None), (4, 2, None), (8, 1, None),
    (16, 0, None), (24, 0, None), (32, 0, None),
    (16, 3, (0xF800, 0x7E0, 0x1F)), (16, 3, (0x7C00, 0x3E0, 0x1F)),
    (24, 3, (0xFF0000, 0xFF00, 0xFF)),
    (32, 3, (0xFF0000, 0xFF00, 0xFF, 0)),
    (32, 3, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
]


# OS/2 1.x headers hold no compression, bitfields or 16- and 32-bit pixels
BMP_CASES = [(b, c, m, h) for b, c, m in BMP_MODES for h in (12, 40, 108, 124)
             if h != 12 or not (c or b in (16, 32))]


@pytest.mark.parametrize("bits,compression,masks,header", BMP_CASES)
def test_bmp_modes(tmp_path, bits, compression, masks, header):
    if header == 40 and masks and masks[3:] == (0xFF000000,):
        # no alpha mask fits a 40-byte header: PIL refuses the layout
        data = bmp_bytes(np.zeros((2, 2, 3), np.uint8), bits,
                         compression=3, masks=masks)
        with pytest.raises(NotImplementedError):
            decode_bmp(data)
        return
    rng = np.random.default_rng(bits * 10 + header)
    for top_down in (False, True):
        if top_down and (header == 12 or compression in (1, 2)):
            continue
        for w, h in SIZES:
            if bits <= 8:
                pal = rng.integers(0, 256, (min(1 << bits, 12), 3))
                px = rng.integers(0, len(pal), (h, w))
                px[:, :4] = 1                  # a run for the RLE coders
            else:
                pal, px = None, rng.integers(0, 256, (h, w, 3))
            same_as_reference(tmp_path, bmp_bytes(
                px, bits, palette=pal, compression=compression, masks=masks,
                top_down=top_down, header=header))


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_bmp_pil_written(tmp_path, mode):
    img = Image.fromarray(np.random.default_rng(4).integers(
        0, 256, (21, 19, 3), np.uint8)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "BMP")
    same_as_reference(tmp_path, buf.getvalue())


def test_bmp_quirks_are_pils(tmp_path):
    """5- and 6-bit channels widen with a floor; a grey ramp palette is
    dropped, so index 200 of a 4-entry ramp reads grey 200 (a real
    palette reads black); RLE's delta escape skips the two bytes after
    its own (PIL reads them twice)."""
    levels = np.arange(64)
    v16 = bmp_bytes(np.stack([levels * 4] * 3, -1)[None].astype(np.uint8),
                    16, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    got = decode_bmp(v16)[0]
    assert got[:, 1].tolist() == [g * 255 // 63 for g in levels]
    assert got[:, 0].tolist() == [(g >> 1) * 255 // 31 for g in levels]
    ramp = bmp_bytes(np.array([[0, 1, 3, 200]]), 8,
                     palette=[(i, i, i) for i in range(4)])
    assert decode_bmp(ramp)[0, :, 0].tolist() == [0, 1, 3, 200]
    real = bmp_bytes(np.array([[0, 1, 3, 200]]), 8,
                     palette=[(9, 8, 7)] * 4)
    assert decode_bmp(real)[:, 3].tolist() == [[0, 0, 0]]
    # an RLE8 bitmap of 4x2: a run of 4, end of line, a delta escape
    # (0, 2, 1, 0), whose offsets PIL reads from the two bytes after it
    # (3, 2: the run of 3 that follows), end of bitmap
    body = bytes([4, 1, 0, 0, 0, 2, 1, 0, 3, 2, 0, 1, 0, 0, 0, 1])
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in
                   ((0, 0, 0), (10, 20, 30), (40, 50, 60), (70, 80, 90)))
    info = struct.pack("<IiiHHIIiiII", 40, 4, 2, 1, 8, 1, len(body), 0, 0,
                       4, 0)
    off = 14 + len(info) + len(pal)
    data = (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info
            + pal + body)
    for d in (v16, ramp, real, data):
        same_as_reference(tmp_path, d)


GIF_CASES = [(ncol, local, interlace)
             for ncol in (2, 5, 16, 200, 256) for local in (False, True)
             for interlace in (False, True)]


@pytest.mark.parametrize("ncol,local,interlace", GIF_CASES)
def test_gif_modes(tmp_path, ncol, local, interlace):
    rng = np.random.default_rng(ncol + 2 * local + interlace)
    for w, h in SIZES + [(80, 64), (300, 9)]:
        for ident in (False, True):
            pal = (np.repeat(np.arange(ncol)[:, None], 3, 1) if ident
                   else rng.integers(0, 256, (ncol, 3)))
            idx = rng.integers(0, ncol, (h, w))
            idx[:, :w // 2] = idx[0, 0]        # long runs: wide codes
            for trans, off in ((None, (0, 0)), (1, (3, 2))):
                screen = (w + 5, h + 3) if off != (0, 0) else None
                same_as_reference(tmp_path, gif_bytes(
                    idx, pal, screen=screen, offset=off, local=local,
                    interlace=interlace, transparency=trans))


def test_gif_frame_past_the_screen_and_87a(tmp_path):
    """A frame reaching past the logical screen widens the image; GIF87a
    and PIL's own GIFs (several code sizes) decode alike."""
    rng = np.random.default_rng(8)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (20, 30))
    data = gif_bytes(idx, pal, screen=(25, 10), offset=(4, 6))
    assert pil_rgb(data).shape == (26, 34, 3)
    same_as_reference(tmp_path, data)
    same_as_reference(tmp_path, gif_bytes(idx, pal, version=b"GIF87a"))
    for ncol in (2, 7, 64, 256):
        px = rng.integers(0, ncol, (37, 41)).astype(np.uint8)
        img = Image.fromarray(px, "P")
        img.putpalette(rng.integers(0, 256, 3 * ncol).astype(
            np.uint8).tobytes())
        buf = io.BytesIO()
        img.save(buf, "GIF")
        same_as_reference(tmp_path, buf.getvalue())
