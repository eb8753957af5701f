"""FITS decoding, equal to PIL's decode.

PIL's FitsImagePlugin is Python; this follows it statement for
statement. Headers are 80-byte cards ("KEYWORD = value / comment"); the
first must be SIMPLE = T (else the file passes to the next plugin). At
each END the reader moves to the next 2880-byte block; a header unit
whose size is not yet known (NAXIS 0) lets a later XTENSION header add
its cards, and the first card after the last header unit starts the
data. NAXIS 1 gives a size of (1, NAXIS1), NAXIS 2 or more (NAXIS1,
NAXIS2). BITPIX 8 is mode "L", 16 "I;16", 32 "I", -32 and -64 "F"; any
other leaves no mode and passes the file on, as do a size of no pixels
and a missing keyword. The data's rows are read bottom-up by PIL's raw
decoder in little-endian raw modes, so FITS's big-endian samples are
read byte-swapped, and BITPIX -64 reads float32 samples from the first
half of its bytes; BZERO and BSCALE are ignored. A BINTABLE extension
with ZIMAGE = T and ZCMPTYPE 'GZIP_1  ' is Pillow's FitsGzipDecoder:
the bytes from the heap (after NAXIS1 x NAXIS2 x BITPIX / 8 bytes of
table) to the end of the file are one or more gzip members, each pixel
is four of their bytes of which the last ZBITPIX / 8 are kept (none for
negative ZBITPIX, which then has no data), rows bottom-up. "Truncated
FITS file", "No image data", a value int() refuses, data that ends
early and gzip data Python's gzip refuses raise ValueError.
`convert("RGB")` then clamps "I;16" and "I" to 0..255 and truncates "F"
(pnm.float_to_rgb).
"""
from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from . import bomb, rawtile
from .pnm import float_to_rgb

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
# PIL's raw modes of them: (bytes a sample, numpy type)
_RAW = {"L": (1, "u1"), "I;16": (2, "<u2"), "I": (4, "<i4"),
        "F": (4, "<f4")}


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict) -> tuple:
    """FitsImageFile._parse_headers: (decoder, offset, size, mode,
    BITPIX)."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        plain = _size(headers, prefix) or (0, 0)
        offset = plain[0] * plain[1] * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "gzip"
    size = _size(headers, prefix)
    if not size:
        return "", 0, None, "", 0
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, size, _MODES.get(bits, ""), bits


def _open(data: bytes) -> tuple:
    """FitsImageFile._open: (decoder, data offset, (w, h), mode, BITPIX);
    Next where PIL passes the file on, ValueError where it fails."""
    headers, in_progress, decoder, pos = {}, False, "", 0
    while True:
        card = data[pos:pos + 80]
        pos += 80
        if not card:
            raise ValueError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break                                   # the data unit
        elif keyword == b"END":
            pos = math.ceil(min(pos, len(data)) / 2880) * 2880
            if not decoder:
                decoder, offset, size, mode, bits = _parse(headers)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise rawtile.Next("not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError("FITS file with no image data")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise rawtile.Next("FITS image PIL does not open")
    return decoder, offset + min(pos, len(data)) - 80, size, mode, bits


def _header(data: bytes) -> tuple:
    try:
        return _open(data)
    except (KeyError, IndexError, TypeError):
        raise rawtile.Next("FITS header PIL passes on") from None
    except ValueError as e:
        if isinstance(e, rawtile.Next):
            raise
        raise ValueError(f"FITS header PIL fails: {e}") from None


def accept(data: bytes) -> bool:
    """Whether PIL's FITS plugin takes the file (opens it, or fails)."""
    return data.startswith(b"SIMPLE") and rawtile.takes(_header, data)


def _gzip_rows(data: bytes, offset: int, w: int, h: int, bits: int) -> bytes:
    """FitsGzipDecoder: the raw rows it hands to the raw decoder."""
    if offset < 0:
        raise ValueError("FITS GZIP_1 data at a negative offset")
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"FITS GZIP_1 data Python's gzip refuses: "
                         f"{e}") from None
    n = min(bits // 8, 4)
    if n <= 0:
        return b""
    px = np.frombuffer(value[:len(value) // 4 * 4], np.uint8)
    return px.reshape(-1, 4)[:w * h, 4 - n:].tobytes()


def decode_fits(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a FITS file, PIL's `convert("RGB")` of it byte
    for byte."""
    decoder, offset, (w, h), mode, bits = _header(data)
    bomb.check("FITS", w, h)
    size, dtype = _RAW[mode]
    if decoder == "gzip":
        raw = _gzip_rows(data, offset, w, h, bits)
        if len(raw) < w * h * size:
            raise ValueError("FITS GZIP_1 data holds too few pixels (PIL: "
                             "not enough image data)")
        px = np.frombuffer(raw, np.uint8, w * h * size).reshape(h, -1)
    else:
        px = rawtile.rows(data, offset, h, w * size, fmt="FITS")
    # rows bottom-up (the raw decoder's orientation -1, or the gzip
    # decoder's reversal)
    v = np.ascontiguousarray(px[::-1]).view(dtype).reshape(h, w)
    if mode == "F":
        return float_to_rgb(v)
    if mode == "I;16":
        return rawtile.grey(np.minimum(v, 255))
    return rawtile.grey(np.clip(v, 0, 255))
