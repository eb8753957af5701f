"""McIdas area file decoding, equal to PIL's decode.

PIL's McIdasImagePlugin reads the 256-byte area descriptor (64
big-endian signed words after the 8-byte magic, counted from 1): the
bytes a pixel (word 11: 1 as mode "L", 2 as "I;16B", 4 as mode "I" of
big-endian 32-bit samples), the size (words 10 and 9), the bands (14)
and the line prefix (15). Rows start at word 34 plus the prefix and are
prefix plus width * bytes * bands apart; the first band is read. RGB
clips "I;16B" and "I" to 0..255 as Pillow does. Another pixel size, a
descriptor cut short or a size of no pixels passes the file on to the
next plugin (see `accept`); a stride shorter than a row, a negative
offset or data that ends early raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, rawtile

MAGIC = b"\x00\x00\x00\x00\x00\x00\x00\x04"


def _header(data: bytes) -> tuple:
    if not data.startswith(MAGIC) or len(data) < 256:
        raise rawtile.Next("not an McIdas area file")
    word = (0,) + struct.unpack_from(">64i", data)
    if word[11] not in (1, 2, 4) or word[10] <= 0 or word[9] <= 0:
        raise rawtile.Next("McIdas area PIL does not open")
    return (word[10], word[9], word[11], word[34] + word[15],
            word[15] + word[10] * word[11] * word[14])


def accept(data: bytes) -> bool:
    return rawtile.takes(_header, data)


def decode_mcidas(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a McIdas area file, PIL's `convert("RGB")` of it
    byte for byte."""
    w, h, size, offset, stride = _header(data)
    bomb.check("McIdas", w, h)
    px = rawtile.rows(data, offset, h, w * size, stride, "McIdas")
    v = px.view({1: "u1", 2: ">u2", 4: ">i4"}[size]).astype(np.int64)
    return rawtile.grey(np.clip(v, 0, 255))
