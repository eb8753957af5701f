"""LZW decoding for the TIFF and GIF readers.

Both formats grow a table of strings from `clear` = 1 << min_bits single
bytes, a clear code and an end code, and read codes whose width starts at
min_bits + 1 and grows to 12 as the table fills. They differ in two
things: TIFF packs codes most significant bit first and widens one code
early (when the next free code is 2^width - 1, libtiff's tif_lzw.c), GIF
packs them least significant bit first and widens when the next free code
is 2^width. A full table (4096 entries) takes no more entries until the
next clear code (GIF's deferred clear).
"""
from __future__ import annotations


def decode(data: bytes, min_bits: int, msb_first: bool, early: int,
           need: int = -1) -> bytes:
    """The bytes that LZW codes `data` stand for, up to the end code, the
    end of the data or `need` bytes (when need >= 0)."""
    clear = 1 << min_bits
    end = clear + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    width = min_bits + 1
    buf = data + bytes(4)
    nbits = 8 * len(data)
    out = bytearray()
    prev = None
    p = 0
    while p + width <= nbits and (need < 0 or len(out) < need):
        i = p >> 3
        if msb_first:
            code = ((buf[i] << 16 | buf[i + 1] << 8 | buf[i + 2])
                    >> (24 - (p & 7) - width)) & ((1 << width) - 1)
        else:
            code = ((buf[i] | buf[i + 1] << 8 | buf[i + 2] << 16)
                    >> (p & 7)) & ((1 << width) - 1)
        p += width
        if code == clear:
            table = list(base)
            width = min_bits + 1
            prev = None
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None:
                add = prev + entry[:1]
        elif code == len(table) and prev is not None:
            entry = add = prev + prev[:1]
        else:
            raise ValueError(f"LZW code {code} with {len(table)} table "
                             f"entries")
        out += entry
        if prev is not None and len(table) < 4096:
            table.append(add)
            if len(table) + early >= 1 << width and width < 12:
                width += 1
        prev = entry
    return bytes(out)
