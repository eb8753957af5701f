"""ICO and CUR decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_ico` and `decode_cur` return those bytes for the entry PIL opens:

* ICO (IcoImagePlugin): the directory sorted by colour depth (the bit
  count, else log2 of the colour count rounded up, else 256), then
  stable-sorted by area, largest first; PIL opens the first entry, so
  among the largest entries the one of the LOWEST colour depth wins, and
  among equals the first in the file. A PNG entry is decoded by png.py;
  any other is a DIB (bmp.py) whose header counts twice its rows (the
  colour rows, then a 1-bit AND mask PIL reads only as alpha). The RGB
  conversion drops that alpha, and the 32-bit entries' own alpha; PIL
  still reads both, so an AND mask or an alpha that runs past the end of
  the file raises ValueError as there;
* CUR (CurImagePlugin): the same container with a hotspot in place of
  the planes and bit count; PIL opens the first entry unless a later one
  is wider and taller (the directory's bytes, where 0 stays 0), and reads
  it as a DIB only (a PNG entry raises, as in PIL).

A DIB whose kind PIL does not open raises NotImplementedError naming it;
malformed data raises ValueError.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from . import bomb
from . import bmp, png

ICO_MAGIC = b"\x00\x00\x01\x00"
CUR_MAGIC = b"\x00\x00\x02\x00"


def accept(data: bytes, magic: bytes) -> bool:
    """PIL's test of an icon or cursor file: its magic and a directory of
    at least one whole entry."""
    if not data.startswith(magic) or len(data) < 6:
        return False
    n = struct.unpack_from("<H", data, 4)[0]
    return n > 0 and len(data) >= 6 + 16 * n


def _directory(data: bytes) -> list:
    n = struct.unpack_from("<H", data, 4)[0]
    return [data[6 + 16 * i:22 + 16 * i] for i in range(n)]


def _half_dib(data: bytes, pos: int, alpha32: bool = False,
              and_end: int | None = None, fmt: str = "ICO") -> np.ndarray:
    """(H, W, 3) of the DIB at `pos` with its height halved, as PIL reads
    an icon's or cursor's bitmap. `alpha32`: PIL reads width * height * 4
    bytes of alpha from the pixels; `and_end`: where the entry ends, the
    AND mask (rows padded to 32 bits) just before it. PIL checks the
    bomb limit on an icon's whole bitmap, a cursor's halved one (`fmt`
    "ICO" or "CUR")."""
    dib = bytearray(data[pos:])
    if len(dib) < 16:
        raise ValueError("icon bitmap header runs past the end of the file")
    hsize = struct.unpack_from("<I", dib, 0)[0]
    if hsize == 12:
        w, h = struct.unpack_from("<HH", dib, 4)
        bomb.check(fmt, w, h if fmt == "ICO" else h // 2)
        h //= 2
        struct.pack_into("<H", dib, 6, h)
    else:
        w, raw = struct.unpack_from("<II", dib, 4)
        flip = dib[11] == 0xFF
        full = 2 ** 32 - raw if flip else raw
        bomb.check(fmt, w, full if fmt == "ICO" else full // 2)
        h = full // 2
        if h == 0:
            raise ValueError("icon bitmap of 0 rows")
        struct.pack_into("<I", dib, 8, 2 ** 32 - h if flip else h)
    if alpha32 and len(dib) - bmp.dib_pixels(bytes(dib)) < w * h * 4:
        raise ValueError("icon alpha runs past the end of the file")
    if and_end is not None:
        total = (w + 31) // 32 * 32 * h // 8
        if and_end - total < 0 or len(data) < and_end:
            raise ValueError("icon AND mask runs past the end of the file")
    return bmp.decode_dib(bytes(dib))


def _depth(entry: bytes) -> int:
    """IcoImagePlugin's colour depth of a directory entry."""
    nb_color, bpp = entry[2], struct.unpack_from("<H", entry, 6)[0]
    return bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256


def decode_ico(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of the entry of an ICO file PIL opens, PIL's
    `convert("RGB")` of it byte for byte."""
    if not accept(data, ICO_MAGIC):
        raise ValueError("not an ICO file (or its directory ends early)")
    entries = sorted(_directory(data), key=_depth)
    entries.sort(key=lambda e: (e[0] or 256) * (e[1] or 256), reverse=True)
    entry = entries[0]
    bpp, size, offset = struct.unpack_from("<HII", entry, 6)
    if data[offset:offset + 8] == png.MAGIC:
        return png.decode_png(data[offset:])
    if bpp == 32:
        return _half_dib(data, offset, alpha32=True)
    return _half_dib(data, offset, and_end=offset + size)


def decode_cur(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of the cursor of a CUR file PIL opens, PIL's
    `convert("RGB")` of it byte for byte."""
    if not accept(data, CUR_MAGIC):
        raise ValueError("not a CUR file (or its directory ends early)")
    best = None
    for e in _directory(data):
        if best is None or (e[0] > best[0] and e[1] > best[1]):
            best = e
    offset = struct.unpack_from("<I", best, 12)[0]
    if data[offset:offset + 8] == png.MAGIC:
        raise NotImplementedError("CUR with a PNG cursor (which PIL does "
                                  "not open either) is not decoded by the "
                                  "port")
    try:
        return _half_dib(data, offset, fmt="CUR")
    except NotImplementedError as err:
        raise NotImplementedError(f"CUR: {err}") from None
