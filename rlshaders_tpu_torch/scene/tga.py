"""TGA (Targa) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_tga` returns those bytes for every Targa file PIL's
TgaImagePlugin reads. PIL is the specification here, also where it departs
from the TGA format:

* image types 1 and 9 (colour-mapped), 2 and 10 (true colour), 3 and 11
  (grey), raw or run-length coded; grey of 1, 8 or 16 bits (grey and
  alpha), colour-mapped 8-bit indices through a map of 16 or 24 bits an
  entry, true colour of 16 (5-5-5 and an alpha bit), 24 or 32 bits;
* the map is indexed from 0, its first `start` entries black, and an
  index past its end reads black; a colour-mapped image without a map
  (map type 0) opens in mode "L" and PIL has no raw mode for it;
* 5-bit channels widen as v * 255 // 31; alpha is dropped;
* bit 0x20 of the descriptor puts row 0 at the top (else at the bottom),
  bit 0x10 mirrors the rows;
* run-length data: a literal packet may run on into the next rows, a
  repeat packet may not (PIL's TgaRleDecode raises an overrun), and the
  data ends once every row is filled.

A file PIL opens but cannot decode (1-bit run-length data, a map of 32-bit
entries, a mode without a raw mode) raises NotImplementedError naming it;
malformed data raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb
from .png import unpack_samples

# (image type & 7, bits a pixel) -> PIL's raw mode (TgaImagePlugin.MODES)
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
             (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def header_ok(data: bytes) -> bool:
    """Whether PIL's TgaImageFile._open takes these bytes as a Targa header
    (TGA has no signature: anything else PIL tries next)."""
    if len(data) < 18:
        return False
    w, h = struct.unpack_from("<HH", data, 12)
    return (data[1] in (0, 1) and w > 0 and h > 0
            and data[16] in (1, 8, 16, 24, 32)
            and data[2] in (1, 2, 3, 9, 10, 11)
            and (data[1] == 0 or data[7] in (16, 24, 32)))


def _bgr15(v: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 of 16-bit little-endian 5-5-5 words, B in the low
    bits."""
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)],
                    -1).astype(np.uint8)


def _rle(data: bytes, pos: int, rowbytes: int, h: int, depth: int) -> bytes:
    """PIL's TgaRleDecode: the rows' bytes in file order."""
    out = bytearray()
    need = rowbytes * h
    n_data = len(data)
    while len(out) < need:
        if pos >= n_data:
            raise ValueError("TGA run-length data ends early")
        head = data[pos]
        n = depth * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + depth > n_data:
                raise ValueError("TGA run-length data ends early")
            if len(out) % rowbytes + n > rowbytes:
                raise ValueError("TGA run-length repeat packet runs past "
                                 "the end of its row")
            out += data[pos + 1:pos + 1 + depth] * (n // depth)
            pos += 1 + depth
        else:
            if pos + 1 + n > n_data:
                raise ValueError("TGA run-length data ends early")
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
    return bytes(out[:need])


def decode_tga(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a Targa file, PIL's `convert("RGB")` of it byte
    for byte."""
    if not header_ok(data):
        raise ValueError("not a TGA file")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    bomb.check("TGA", w, h)
    depth, flags = data[16], data[17]
    kind = itype & 7
    rawmode = _RAWMODES.get((kind, depth))
    if kind == 1 and not cmap_type:
        rawmode = None
    if rawmode is None:
        raise NotImplementedError(
            f"TGA of image type {itype} at {depth} bits a pixel (which PIL "
            f"opens without a raw mode) is not decoded by the port")
    if itype & 8 and depth == 1:
        raise NotImplementedError("TGA with run-length coded 1-bit pixels "
                                  "(which PIL does not read either) is not "
                                  "decoded by the port")
    pos = 18 + id_len
    pal = None
    if cmap_type:
        start, size, mapdepth = (struct.unpack_from("<H", data, 3)[0],
                                 struct.unpack_from("<H", data, 5)[0],
                                 data[7])
        if mapdepth == 32:
            raise NotImplementedError("TGA with a colour map of 32-bit "
                                      "entries (which PIL does not read "
                                      "either) is not decoded by the port")
        step = mapdepth // 8
        raw = data[pos:pos + step * size]
        pos += step * size
        if len(raw) < step * size:
            raise ValueError("TGA colour map runs past the end of the file")
        entries = np.frombuffer(raw, np.uint8).reshape(size, step)
        if mapdepth == 16:
            rgb = _bgr15(entries[:, 0].astype(np.int32)
                         | entries[:, 1].astype(np.int32) << 8)
        else:
            rgb = entries[:, 2::-1]
        pal = np.zeros((max(256, start + size), 3), np.uint8)
        pal[start:start + size] = rgb
    bpp = (depth + 7) // 8
    rowbytes = (w + 7) // 8 if depth == 1 else w * bpp
    if itype & 8:
        raw = _rle(data, pos, rowbytes, h, bpp)
    else:
        raw = data[pos:pos + rowbytes * h]
        if len(raw) < rowbytes * h:
            raise ValueError("TGA pixel data ends early")
    rows = np.frombuffer(raw, np.uint8).reshape(h, rowbytes)
    if depth == 1:
        px = unpack_samples(rows, w, 1)
        rgb = np.repeat((px * 255).astype(np.uint8)[..., None], 3, axis=2)
    elif rawmode == "P":
        rgb = pal[rows]
    elif rawmode in ("L", "LA"):
        rgb = np.repeat(rows.reshape(h, w, bpp)[..., :1], 3, axis=2)
    elif depth == 16:
        v = rows.reshape(h, w, 2).astype(np.int32)
        rgb = _bgr15(v[..., 0] | v[..., 1] << 8)
    else:
        rgb = rows.reshape(h, w, bpp)[..., 2::-1]
    if not flags & 0x20:
        rgb = rgb[::-1]
    if flags & 0x10:
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb, dtype=np.uint8)
