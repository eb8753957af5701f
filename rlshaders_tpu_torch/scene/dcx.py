"""DCX (multi-page PCX) decoding, equal to PIL's decode.

PIL's DcxImagePlugin reads up to 1024 little-endian page offsets after
the magic (to the first 0) and opens the first page as a PCX file at its
offset (`pcx.py`; the palette PCX keeps at the end of a file is still the
end of the DCX file). A table that runs past the end of the file, a file
of no pages or a first page PIL's PCX reader refuses passes the file on
to the next plugin (see `accept`).
"""
from __future__ import annotations

import struct

import numpy as np

from . import pcx, rawtile

MAGIC = 987654321


def _first(data: bytes) -> int:
    """The first page's offset; Next where PIL tries the next plugin."""
    if len(data) < 4 or struct.unpack_from("<I", data)[0] != MAGIC:
        raise rawtile.Next("not a DCX file")
    for i in range(1024):
        if len(data) < 8 + 4 * i:
            raise rawtile.Next("DCX page table runs past the file")
        if not struct.unpack_from("<I", data, 4 + 4 * i)[0]:
            break
    first = struct.unpack_from("<I", data, 4)[0]
    if not first:
        raise rawtile.Next("DCX of no pages")
    if not pcx.header_ok(data[first:]):
        raise rawtile.Next("DCX page PIL's PCX reader refuses")
    return first


def accept(data: bytes) -> bool:
    return rawtile.takes(_first, data)


def decode_dcx(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a DCX file's first page, PIL's
    `convert("RGB")` of it byte for byte."""
    first = _first(data)
    return pcx.decode_pcx(data[first:])
