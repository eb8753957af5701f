"""XV thumbnail decoding, equal to PIL's decode.

PIL's XVThumbImagePlugin reads "P7 332" and the rest of its line, skips
comment lines ("#"), takes the first two words of the next line as the
size, and reads raw bytes from the line after, each an index into the
fixed 3-3-2 palette (r * 255 // 7, g * 255 // 7, b * 255 // 3). A file
that ends before its size line, or a size of no pixels, passes the file
on to the next plugin (see `accept`); a size line PIL cannot read and
data that ends early raise ValueError.
"""
from __future__ import annotations

import numpy as np

from . import bomb, rawtile

MAGIC = b"P7 332"
_R, _G, _B = np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                         indexing="ij")
PALETTE = np.stack([_R * 255 // 7, _G * 255 // 7, _B * 255 // 3],
                   -1).reshape(256, 3).astype(np.uint8)


def _line(data: bytes, pos: int) -> tuple:
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def _header(data: bytes) -> tuple:
    if not data.startswith(MAGIC):
        raise rawtile.Next("not an XV thumbnail file")
    _, pos = _line(data, len(MAGIC))
    while True:
        s, pos = _line(data, pos)
        if not s:
            raise rawtile.Next("XV thumbnail ends in its header")
        if s[0] != 35:
            break
    words = s.strip().split(maxsplit=2)
    if len(words) < 2:
        raise ValueError("XV thumbnail size line without two words")
    w, h = int(words[0]), int(words[1])
    if w <= 0 or h <= 0:
        raise rawtile.Next("XV thumbnail of no pixels")
    return w, h, pos


def accept(data: bytes) -> bool:
    return rawtile.takes(_header, data)


def decode_xvthumb(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an XV thumbnail, PIL's `convert("RGB")` of it
    byte for byte."""
    w, h, pos = _header(data)
    bomb.check("XV thumbnail", w, h)
    return PALETTE[rawtile.rows(data, pos, h, w, fmt="XV thumbnail")]
