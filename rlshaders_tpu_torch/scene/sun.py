"""Sun raster decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_sun` returns those bytes for every file PIL's SunImagePlugin
opens. The 32-byte big-endian header gives the size, the depth (1, 4, 8,
24 or 32 bits), the type and the colour map; PIL's modes follow:

* 1 bit: mode "1", black where set; 4 bits: grey times 17; 8 bits: grey;
  with a colour map (type 1, at most 1024 bytes: its reds, then greens,
  then blues) 4 and 8 bits are palette indices (an index past the map is
  black, a map of more than 256 colours fails), and a map on any other
  depth fails;
* 24 and 32 bits: RGB where the type is 3, else BGR, the fourth byte of
  32 bits unused;
* types 0, 1, 3, 4 and 5: raw rows padded to 16 bits; type 2: Sun's
  run-length coding (0x80 n v repeats v n + 1 times, 0x80 0 is a literal
  0x80), whose runs wrap from row to row with no padding.

A header PIL's plugin refuses passes the file on to the next plugin (see
`accept`); data that ends early raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, rawtile

MAGIC = 0x59A66A95


def _header(data: bytes) -> tuple:
    if len(data) < 32 or struct.unpack_from(">I", data)[0] != MAGIC:
        raise rawtile.Next("not a Sun raster file")
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", data, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise rawtile.Next("Sun raster depth PIL does not open")
    if plen and (plen > 1024 or ptype != 1):
        raise rawtile.Next("Sun raster colour map PIL does not open")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise rawtile.Next("Sun raster type PIL does not open")
    if w == 0 or h == 0:
        raise rawtile.Next("Sun raster of no pixels")
    return w, h, depth, ftype, plen


def accept(data: bytes) -> bool:
    """PIL's _accept and the checks of its _open."""
    return rawtile.takes(_header, data)


def _rle(data: bytes, pos: int, need: int) -> np.ndarray:
    """PIL's SunRleDecode over `need` bytes of rows."""
    out = bytearray()
    n = len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError("Sun raster RLE data truncated")
        b = data[pos]
        if b != 0x80:
            out.append(b)
            pos += 1
        elif pos + 1 >= n:
            raise ValueError("Sun raster RLE data truncated")
        elif data[pos + 1] == 0:
            out.append(0x80)
            pos += 2
        else:
            if pos + 2 >= n:
                raise ValueError("Sun raster RLE data truncated")
            out += data[pos + 2:pos + 3] * (data[pos + 1] + 1)
            pos += 3
    return np.frombuffer(bytes(out[:need]), np.uint8)


def decode_sun(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a Sun raster file, PIL's `convert("RGB")` of it
    byte for byte."""
    w, h, depth, ftype, plen = _header(data)
    bomb.check("Sun raster", w, h)
    pal = None
    if plen:
        if depth not in (4, 8):
            raise ValueError(f"Sun raster of {depth} bits with a colour map "
                             f"(PIL cannot put a palette on its mode)")
        raw = data[32:32 + plen]
        k = len(raw) // 3
        if k > 256:
            raise ValueError("Sun raster colour map of more than 256 "
                             "colours")
        pal = np.frombuffer(raw, np.uint8, 3 * k).reshape(3, k).T
    rowbytes = (w * depth + 7) // 8
    if ftype == 2:
        px = _rle(data, 32 + plen, h * rowbytes).reshape(h, rowbytes)
    else:
        px = rawtile.rows(data, 32 + plen, h, rowbytes,
                          (w * depth + 15) // 16 * 2, "Sun raster")
    if depth == 1:
        return rawtile.grey(255 - np.unpackbits(px, axis=1)[:, :w] * 255)
    if depth == 4:
        v = np.stack([px >> 4, px & 15], -1).reshape(h, -1)[:, :w]
        return rawtile.grey(v * 17) if pal is None else \
            rawtile.palette(pal, v)
    if depth == 8:
        return rawtile.grey(px) if pal is None else rawtile.palette(pal, px)
    rgb = px.reshape(h, w, depth // 8)[..., :3]
    return np.ascontiguousarray(rgb if ftype == 3 else rgb[..., ::-1])
