"""BMP decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_bmp` returns those bytes for every bitmap PIL's BmpImagePlugin
opens:

* OS/2 1.x headers (12 bytes) and BITMAPINFOHEADER (40) with its V2-V5
  extensions (52, 56, 108, 124) and the OS/2 2.x size (64);
* a DIB, the same bitmap without its 14-byte file header
  (`decode_dib`);
* 1, 4 and 8 bits through a palette, 16 (5-5-5, or 5-6-5 by bitfields),
  24 and 32 bits; BI_RGB, RLE8, RLE4 and BI_BITFIELDS with the masks PIL
  knows; bottom-up rows, or top-down ones (a negative height), each
  padded to 4 bytes.

It follows PIL where PIL departs from the format: 5- and 6-bit channels
widen as v * 255 // 31 and v * 255 // 63; a palette that is a grey ramp
(0, 1, 2, ... or black and white) is dropped, so an index past its end
reads as its own grey where a real palette reads black; a data offset
that points at the palette is moved past it; and the RLE reader is
PIL's: a delta escape takes its offsets from the two bytes after its own
two, an odd RLE4 absolute run reads one pixel fewer than it counts, and
a bitmap that fills fewer pixels than it has raises. A valid file of a
kind PIL does not open (other bit depths, 2 bits among them, other masks,
JPEG or PNG inside) or reads in another layout (a grey palette whose mode
"1" or "L" does not match the pixels' depth) raises NotImplementedError
naming it; malformed data raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb
from .png import unpack_samples

MAGIC = b"BM"
# the 32-bit masks PIL reads (r, g, b, a)
_MASKS32 = ((0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
            (0xFF000000, 0xFF00, 0xFF, 0x0),
            (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
            (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
            (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
            (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0))
_COMPRESSIONS = {4: "JPEG", 5: "PNG"}


def _u16(b: bytes, i: int) -> int:
    return struct.unpack_from("<H", b, i)[0]


def _u32(b: bytes, i: int) -> int:
    return struct.unpack_from("<I", b, i)[0]


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """PIL's BmpRleDecoder on the data from `pos`: palette indices of the
    rows in file order."""
    out = bytearray()
    x = 0
    n = len(data)
    while len(out) < w * h:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                                 # an encoded run
            count = max(0, min(count, w - x))
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                           # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                           # end of bitmap
            break
        elif byte == 2:                           # delta, read as PIL reads it
            if pos + 2 > n:
                break
            if pos + 4 > n:
                raise ValueError("BMP RLE delta runs past the end of the "
                                 "file")
            right, up = data[pos + 2:pos + 4]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                     # an absolute run
            take = byte // 2 if rle4 else byte
            run = data[pos:pos + take]
            pos += len(run)
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 15))
            else:
                out += run
            if len(run) < take:
                break
            x += byte
            pos += pos % 2
    if len(out) < w * h:
        raise ValueError("BMP RLE data fills fewer pixels than the bitmap "
                         "has")
    return bytes(out[:w * h])


DIB_SIZES = (12, 40, 52, 56, 64, 108, 124)


def dib_accept(data: bytes) -> bool:
    """PIL's test for a DIB (a bitmap without its file header): the first
    four bytes are a header size it knows."""
    return len(data) >= 4 and _u32(data, 0) in DIB_SIZES


def dib_pixels(data: bytes) -> int:
    """Where PIL's DibImageFile reads a DIB's pixels: right after what its
    header reader took (the header, the three bitfield masks of a 40-byte
    header, and the palette of a 1-, 4- or 8-bit bitmap)."""
    if not dib_accept(data) or len(data) < 16:
        raise ValueError("not a DIB (BMP without its file header)")
    hsize = _u32(data, 0)
    pos = hsize
    if hsize == 12:
        bits, compression, colors, pad = _u16(data, 10), 0, 0, 3
    else:
        if len(data) < 36:
            raise ValueError("DIB header runs past the end of the data")
        bits, compression, colors, pad = (_u16(data, 14), _u32(data, 16),
                                          _u32(data, 32), 4)
        if compression == 3 and hsize == 40:
            pos += 12
    if bits <= 8:
        pos += pad * (colors or 1 << bits)
    return pos


def decode_dib(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a DIB (a BMP without its 14-byte file header),
    PIL's `convert("RGB")` of it byte for byte, its pixels read from
    `dib_pixels`."""
    pos = dib_pixels(data)
    head = MAGIC + struct.pack("<IHHI", 14 + len(data), 0, 0, 14 + pos)
    try:
        return decode_bmp(head + data)
    except NotImplementedError as err:
        raise NotImplementedError(f"DIB (BMP without its file header): "
                                  f"{err}") from None


def decode_bmp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a BMP file, PIL's `convert("RGB")` of it byte
    for byte."""
    if not data.startswith(MAGIC):
        raise ValueError("not a BMP file")
    pos = 14
    if len(data) < pos + 16:
        raise ValueError("BMP header runs past the end of the file")
    offset = _u32(data, 10)
    hsize = _u32(data, pos)
    hd = data[pos + 4:pos + hsize]
    if len(hd) < hsize - 4:
        raise ValueError("BMP header runs past the end of the file")
    masks = None
    after = pos + hsize                    # where the palette or masks sit
    if hsize == 12:
        w, h, bits = _u16(hd, 0), _u16(hd, 2), _u16(hd, 6)
        compression, colors, pad, top_down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        top_down = hd[7] == 0xFF
        w = _u32(hd, 0)
        h = 2 ** 32 - _u32(hd, 4) if top_down else _u32(hd, 4)
        bits, compression = _u16(hd, 10), _u32(hd, 12)
        colors, pad = _u32(hd, 28), 4
        if compression == 3:
            if len(hd) >= 48:
                masks = tuple(_u32(hd, 36 + 4 * i) for i in range(3)) + (
                    _u32(hd, 48) if len(hd) >= 52 else 0,)
            else:
                masks = struct.unpack_from("<3I", data, after) + (0,)
                after += 12
    else:
        raise NotImplementedError(f"BMP with a {hsize}-byte header is not "
                                  f"decoded by the port")
    bomb.check("BMP", w, h)
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise NotImplementedError(f"{bits}-bit BMP (which PIL does not open "
                                  f"either) is not decoded by the port")
    if compression in _COMPRESSIONS or compression > 3:
        name = _COMPRESSIONS.get(compression, f"compression {compression}")
        raise NotImplementedError(f"BMP with {name} data is not decoded by "
                                  f"the port")
    if compression == 3 and not (
            (bits == 32 and masks in _MASKS32)
            or (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF))
            or (bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F),
                                             (0x7C00, 0x3E0, 0x1F)))):
        raise NotImplementedError(f"{bits}-bit BMP with bitfields "
                                  f"{masks} is not decoded by the port")
    if compression in (1, 2) and bits > 8:
        raise ValueError(f"{bits}-bit BMP with RLE data")
    if w == 0 or h == 0:
        raise ValueError(f"BMP of {w}x{h} pixels")

    pal, grey = None, False
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours")
        raw = data[after:after + pad * colors]
        entries = np.frombuffer(raw[:len(raw) // pad * pad], np.uint8)
        entries = entries.reshape(-1, pad)[:, 2::-1]
        ramp = np.array([0, 255]) if colors == 2 else np.arange(colors)
        grey = len(entries) == colors and np.array_equal(
            entries, np.repeat(ramp[:, None], 3, axis=1))
        if grey and (bits != (1 if colors == 2 else 8) if compression == 0
                     else colors == 2):
            # PIL drops the palette and reads the pixels in mode "1" or
            # "L" with that mode's own raw layout
            raise NotImplementedError(
                f"{bits}-bit BMP with a {colors}-entry grey palette (which "
                f"PIL misreads) is not decoded by the port")
        if not grey:
            pal = np.zeros((max(256, len(entries)), 3), np.uint8)
            pal[:len(entries)] = entries

    if compression in (1, 2):
        px = np.frombuffer(_rle(data, offset, w, h, compression == 2),
                           np.uint8).reshape(h, w).astype(np.int32)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        raw = data[offset:offset + h * stride]
        if len(raw) < h * stride:
            raise ValueError("BMP pixel data ends early")
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
        if bits <= 8:
            px = unpack_samples(rows, w, bits)
        elif bits == 16:
            v = unpack_samples(rows, w, 16, big_endian=False)
            g6 = masks is not None and masks[1] == 0x7E0
            px = np.stack([((v >> (11 if g6 else 10)) & 31) * 255 // 31,
                           ((v >> 5) & (63 if g6 else 31)) * 255
                           // (63 if g6 else 31),
                           (v & 31) * 255 // 31], -1)
        else:
            px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
            if bits == 32 and masks is not None and any(masks):
                at = [m.bit_length() // 8 - 1 for m in masks[:3]]
            else:
                at = [2, 1, 0]
            px = px[..., at].astype(np.int32)
    if not top_down:
        px = px[::-1]
    if bits > 8:
        return px.astype(np.uint8)
    if grey:
        px = px * 255 if colors == 2 else px
        return np.repeat(px[..., None], 3, axis=2).astype(np.uint8)
    return pal[px]
