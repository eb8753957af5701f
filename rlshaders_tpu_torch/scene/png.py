"""PNG decoding in numpy (zlib for the data), equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_png` returns those bytes for every PNG that PIL opens:

* colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey and alpha) and 6
  (RGBA) at every bit depth PNG allows them (1, 2, 4, 8, 16);
* sub-byte samples packed most significant bits first, each row padded to
  a byte; the five row filters on whole bytes, as PNG defines them;
* Adam7 interlacing: seven passes, each a small image of its own filtered
  rows; a pass with no pixels has no rows, not even filter bytes.

The samples map to 8 bits as PIL's modes map them: 16-bit RGB, RGBA and
grey-alpha keep their high byte (PIL's "RGB;16B" and "LA;16B" unpackers);
1-, 2- and 4-bit grey scale by 255, 85 and 17; a palette index looks up
PLTE (an index past its end is black). A 16-bit grey image opens in PIL as
"I;16", whose conversion to RGB clamps each sample to 255: a normal 16-bit
grey texture comes out white except where it is darker than 256/65535.
The port keeps that quirk so that its textures match the JAX package's.
Alpha, tRNS and the ancillary chunks (gAMA, iCCP, sRGB, text) change no
RGB value, as in PIL. Malformed data raises ValueError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import bomb

MAGIC = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, bit depths allowed)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of h
    scanlines of w pixels of bpp bytes, each led by its filter byte.

    A pixel's predictor reads its left, upper and upper-left neighbours,
    so the pixels of one anti-diagonal (x + y constant) are independent:
    the loop runs over the h + w - 1 diagonals, each one numpy step over
    its pixels and their bpp channels, with each row's own filter."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (w * bpp + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{h * (w * bpp + 1)}")
    rows = rows.reshape(h, w * bpp + 1)
    ftype = rows[:, 0].astype(np.int64)
    if (ftype > 4).any():
        y = int(np.argmax(ftype > 4))
        raise ValueError(f"PNG row {y} has filter type {ftype[y]}")
    data = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # a zero row above and a zero column left of the image: the neighbours
    # that PNG reads as 0
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a = out[y + 1, x]
        b = out[y, x + 1]
        c = out[y, x]
        f = ftype[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def unpack_samples(rows: np.ndarray, n: int, depth: int,
                   big_endian: bool = True) -> np.ndarray:
    """The first n samples of each row of `rows` ((h, bytes) uint8) at
    `depth` bits, packed most significant bits first: (h, n) int32."""
    if depth == 8:
        return rows[:, :n].astype(np.int32)
    if depth == 16:
        wide = rows[:, :2 * n].astype(np.int32).reshape(len(rows), n, 2)
        hi, lo = (0, 1) if big_endian else (1, 0)
        return wide[..., hi] << 8 | wide[..., lo]
    bits = np.unpackbits(rows, axis=1)
    per = bits.shape[1] // depth
    groups = bits[:, :per * depth].reshape(len(rows), per, depth)
    weights = 1 << np.arange(depth - 1, -1, -1)
    return (groups.astype(np.int32) @ weights.astype(np.int32))[:, :n]


def _chunks(data: bytes) -> dict:
    """IHDR's fields, PLTE and the joined IDAT data."""
    pos = len(MAGIC)
    header, plte, idat = None, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError(f"PNG chunk {ctype!r} runs past the end of the "
                             f"file")
        crc = data[pos + 8 + length:pos + 12 + length]
        if ctype in (b"IHDR", b"PLTE") and crc != struct.pack(
                ">I", zlib.crc32(ctype + body)):
            # PIL checks the CRC of the chunks it reads before the data
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        pos += 12 + length
        if ctype == b"IHDR":
            if length != 13:
                raise ValueError(f"PNG IHDR of {length} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    return {"header": header, "plte": plte, "idat": b"".join(idat)}


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG, PIL's `convert("RGB")` of it byte for
    byte."""
    if not data.startswith(MAGIC):
        raise ValueError("not a PNG file")
    parts = _chunks(data)
    w, h, depth, ctype, method, filt, interlace = parts["header"]
    bomb.check("PNG", w, h)
    if ctype not in _TYPES or depth not in _TYPES[ctype][1]:
        raise ValueError(f"PNG with colour type {ctype} at bit depth "
                         f"{depth}")
    if method or filt or interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"PNG of {w}x{h} with compression {method}, "
                         f"filter method {filt}, interlace {interlace}")
    if ctype == 3 and parts["plte"] is None:
        raise ValueError("palette PNG without a PLTE chunk")
    ch = _TYPES[ctype][0]
    try:
        raw = zlib.decompress(parts["idat"])
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None

    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    px = np.zeros((h, w * ch), np.int32)
    pos = 0
    for y0, x0, dy, dx in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * ch * depth + 7) // 8
        bpp = max(1, ch * depth // 8)
        size = ph * (rowbytes + 1)
        if pos + size > len(raw):
            raise ValueError("PNG data ends early")
        rows = _unfilter(raw[pos:pos + size], ph, rowbytes // bpp, bpp)
        pos += size
        samples = unpack_samples(rows, pw * ch, depth).reshape(ph, pw, ch)
        px.reshape(h, w, ch)[y0::dy, x0::dx] = samples
    px = px.reshape(h, w, ch)

    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(parts["plte"], np.uint8)[:768]
        pal.reshape(-1)[:entries.size // 3 * 3] = entries[:entries.size
                                                          // 3 * 3]
        return pal[px[..., 0]]
    if depth == 16:
        # grey: PIL's "I;16" clamps; the others keep the high byte
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    if ch <= 2:
        px = np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3].astype(np.uint8)
