"""FTEX (Independence War 2 texture) decoding, equal to PIL's decode.

PIL's FtexImagePlugin reads the little-endian header (version, size,
mip-map count, format count, which must be 1, then one format and where
its data is), the first mip-map's byte count there and that many bytes
(a negative count reads to the end of the file), then decodes them as
DXT1 (format 0: `dds.py`'s BC1, mode RGBA, so a 1-bit alpha's
transparent texel is black) or raw RGB (format 1). Another format fails;
a header cut short, or a size of no pixels, passes the file on to the
next plugin (see `accept`); data that ends early raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, dds, rawtile

MAGIC = b"FTEX"


def _header(data: bytes) -> tuple:
    if not data.startswith(MAGIC):
        raise rawtile.Next("not an FTEX file")
    if len(data) < 24:
        raise rawtile.Next("FTEX header cut")
    _, w, h, _, count = struct.unpack_from("<5i", data, 4)
    if count != 1:
        raise ValueError(f"FTEX of {count} formats (PIL asserts one)")
    if len(data) < 32:
        raise rawtile.Next("FTEX format directory cut")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError("FTEX data at a negative offset")
    if len(data) < where + 4:
        raise rawtile.Next("FTEX mip-map size cut")
    (size,) = struct.unpack_from("<i", data, where)
    body = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"FTEX texture format {fmt}")
    if w <= 0 or h <= 0:
        raise rawtile.Next("FTEX of no pixels")
    return w, h, fmt, body


def accept(data: bytes) -> bool:
    return rawtile.takes(_header, data)


def decode_ftex(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an FTEX file, PIL's `convert("RGB")` of it byte
    for byte."""
    w, h, fmt, body = _header(data)
    bomb.check("FTEX", w, h)
    if fmt == 0:
        return dds.bcn(body, 0, "BC1", w, h)
    return rawtile.rows(body, 0, h, 3 * w, fmt="FTEX").reshape(h, w, 3)
