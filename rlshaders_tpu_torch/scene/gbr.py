"""GBR (GIMP brush) decoding, equal to PIL's decode.

PIL's GbrImagePlugin reads the big-endian header: its size (at least
20), version 1 or 2, width, height (neither 0) and bytes a pixel (1:
mode "L", 4: "RGBA", whose alpha RGB drops); version 2 then needs the
magic "GIMP" and a spacing. The pixels follow the comment, at the
header's size (a version 2 header shorter than 28 bytes reads its
"comment" to the end of the file, so the pixels are missing). A header
PIL refuses passes the file on to the next plugin (see `accept`); data
that ends early raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, rawtile


def _header(data: bytes) -> tuple:
    if len(data) < 8:
        raise rawtile.Next("not a GIMP brush")
    size, version = struct.unpack_from(">2I", data)
    if size < 20 or version not in (1, 2):
        raise rawtile.Next("not a GIMP brush")
    if len(data) < 20:
        raise rawtile.Next("GIMP brush header cut")
    w, h, depth = struct.unpack_from(">3I", data, 8)
    if w == 0 or h == 0 or depth not in (1, 4):
        raise rawtile.Next("GIMP brush PIL does not open")
    if version == 2 and (data[20:24] != b"GIMP" or len(data) < 28):
        raise rawtile.Next("GIMP brush without its magic and spacing")
    start = size if size >= 20 + 8 * (version == 2) else len(data)
    return w, h, depth, start


def accept(data: bytes) -> bool:
    """PIL's _accept and the checks of its _open."""
    return rawtile.takes(_header, data)


def decode_gbr(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a GIMP brush, PIL's `convert("RGB")` of it byte
    for byte."""
    w, h, depth, start = _header(data)
    bomb.check("GBR", w, h)
    px = rawtile.rows(data, min(start, len(data)), h, w * depth,
                      fmt="GBR").reshape(h, w, depth)
    return rawtile.grey(px[..., 0]) if depth == 1 else \
        np.ascontiguousarray(px[..., :3])
