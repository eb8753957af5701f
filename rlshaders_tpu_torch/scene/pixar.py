"""PIXAR (Pixar image computer) decoding, equal to PIL's decode.

PIL's PixarImagePlugin reads what it reads of the 512-byte header: the
size (little-endian, width at 418, height at 416) and the pixel layout
at 424 and 426, of which it opens (14, 2) only, as raw RGB from byte
1024 (uncompressed). Any other layout, a header cut before its fields
or a size of no pixels passes the file on to the next plugin (see
`accept`); data that ends early raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, rawtile

MAGIC = b"\x80\xe8\x00\x00"


def _header(data: bytes) -> tuple:
    if not data.startswith(MAGIC) or len(data) < 428:
        raise rawtile.Next("not a PIXAR file PIL opens")
    h, w = struct.unpack_from("<2H", data, 416)
    if struct.unpack_from("<2H", data, 424) != (14, 2) or not w or not h:
        raise rawtile.Next("PIXAR layout PIL does not open")
    return w, h


def accept(data: bytes) -> bool:
    return rawtile.takes(_header, data)


def decode_pixar(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a PIXAR file, PIL's `convert("RGB")` of it byte
    for byte."""
    w, h = _header(data)
    bomb.check("PIXAR", w, h)
    return rawtile.rows(data, 1024, h, 3 * w, fmt="PIXAR").reshape(h, w, 3)
