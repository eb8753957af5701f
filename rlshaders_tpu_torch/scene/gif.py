"""GIF decoding in numpy (scene/lzw.py for the data), equal to PIL's
decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`,
which for a GIF is its first frame as PIL's GifImagePlugin loads it;
`decode_gif` returns those bytes for GIF87a and GIF89a files:

* the frame's local colour table, or else the global one; a table that
  is the identity ramp (entry i is grey i) is no table, so the indices
  read as greys (PIL's mode "L"); an index past a table's end is black;
* LZW codes least significant bit first, with clear and end codes and a
  width that grows to 12 bits;
* interlaced rows (the four passes 8, 8, 4, 2);
* a frame smaller than the logical screen, placed at its offset on a
  canvas of the transparency index (0 without one), as PIL fills it; a
  frame reaching past the screen widens the image to hold it;
* a transparency index changes no colour.

Malformed data raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, lzw

MAGICS = (b"GIF87a", b"GIF89a")


def _blocks(data: bytes, pos: int):
    """The joined data sub-blocks from `pos` and the position after their
    terminator."""
    out = bytearray()
    while pos < len(data) and data[pos]:
        n = data[pos]
        out += data[pos + 1:pos + 1 + n]
        pos += 1 + n
    return bytes(out), pos + 1


def _table(raw: bytes):
    """A colour table as PIL keeps it: None for the identity ramp, else
    (256 or more, 3) uint8 padded with black."""
    entries = np.frombuffer(raw, np.uint8)[:len(raw) // 3 * 3].reshape(-1, 3)
    ramp = np.arange(len(entries))
    if (entries == ramp[:, None]).all():
        return None
    pal = np.zeros((max(256, len(entries)), 3), np.uint8)
    pal[:len(entries)] = entries
    return pal


def decode_gif(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a GIF's first frame, PIL's `convert("RGB")` of it
    byte for byte."""
    if data[:6] not in MAGICS or len(data) < 13:
        raise ValueError("not a GIF file")
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    bomb.check("GIF", sw, sh)
    pos = 13
    palette = None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        palette = _table(data[pos:pos + size])
        pos += size
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF without an image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:                              # an extension
            label = data[pos] if pos < len(data) else 0
            first = data[pos + 2:pos + 2 + data[pos + 1]] \
                if pos + 1 < len(data) else b""
            if label == 0xF9 and len(first) >= 4 and first[0] & 1:
                transparency = first[3]
            _, pos = _blocks(data, pos + 1)
        elif kind == 0x2C:                            # the image
            if pos + 9 > len(data):
                raise ValueError("GIF image descriptor runs past the end")
            x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
            # the frame grows the screen where it reaches past it; the
            # frame's (disposal) extent lies inside that
            bomb.check("GIF", max(sw, x0 + w), max(sh, y0 + h))
            pos += 9
            if iflags & 0x80:
                size = 3 << ((iflags & 7) + 1)
                palette = _table(data[pos:pos + size])
                pos += size
            if pos >= len(data):
                raise ValueError("GIF image without its data")
            code_size = data[pos]
            codes, _ = _blocks(data, pos + 1)
            break
        # any other byte is skipped, as PIL skips it
    if not 1 <= code_size <= 11:
        raise ValueError(f"GIF LZW code size {code_size}")

    width, height = max(sw, x0 + w), max(sh, y0 + h)
    canvas = np.full((height, width), transparency or 0, np.uint8)
    if w and h:
        px = np.frombuffer(lzw.decode(codes, code_size, False, 0, w * h),
                           np.uint8)[:w * h]
        rows = np.arange(h)
        if iflags & 0x40:
            rows = np.concatenate([np.arange(s, h, step) for s, step in
                                   ((0, 8), (4, 8), (2, 4), (1, 2))])
        n = len(px) // w
        frame = canvas[y0:y0 + h, x0:x0 + w]
        frame[rows[:n]] = px[:n * w].reshape(n, w)
        if len(px) % w:
            frame[rows[n], :len(px) % w] = px[n * w:]
    if palette is None:
        return np.repeat(canvas[..., None], 3, axis=2)
    return palette[canvas]
