"""ICNS (Mac OS icon) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_icns` returns those bytes for the icon PIL's IcnsImagePlugin
opens: the largest (width, height, scale) among the sizes the file has
an entry for, and of that size every entry PIL knows, read in PIL's
order:

* a PNG entry (ic07-ic14, icp4-icp6), decoded by png.py, which wins over
  the others of its size, or a JPEG 2000 entry of those types (a J2K
  codestream or a JP2 file), which PIL opens as a file of its own and
  converts to RGBA, decoded by jp2.py (a bare JP2 signature is no file
  PIL opens);
* a 24-bit RGB entry (is32, il32, ih32, and it32 after its four zero
  bytes): raw when its length is exactly three planes, else PIL's
  `read_32` run-length scheme, plane after plane (a byte n < 128 copies
  the n + 1 bytes after it, a byte n >= 128 repeats the next byte
  n - 125 times), read on past the entry's end as PIL reads it;
* its 8-bit mask (s8mk, l8mk, h8mk, t8mk), which the RGB conversion
  drops but PIL still reads (a mask that runs past the end of the file
  raises ValueError, as there).

PIL then checks the decoded size against the file's sizes; an image whose
size fits none of them raises ValueError, as there. Malformed data raises
ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import jp2, png

MAGIC = b"icns"
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
_J2K_BOX = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# IcnsFile.SIZES: (width, height, scale) -> the entry types PIL reads
SIZES = {
    (512, 512, 2): (b"ic10",),
    (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",),
    (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",),
    (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
    (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
_RGB = (b"is32", b"il32", b"ih32", b"it32")
_MASKS = (b"s8mk", b"l8mk", b"h8mk", b"t8mk")


def _entries(data: bytes) -> dict:
    """{type: (start, length)} of the entries, as IcnsFile reads the
    file's blocks up to the size its header gives (a later entry of a
    type replaces an earlier one)."""
    if len(data) < 8 or not data.startswith(MAGIC):
        raise ValueError("not an ICNS file")
    end = struct.unpack_from(">I", data, 4)[0]
    out, i = {}, 8
    while i < end:
        if i + 8 > len(data):
            raise ValueError("ICNS block header runs past the end of the "
                             "file")
        kind, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise ValueError("ICNS block of 0 bytes")
        out[kind] = (i + 8, size - 8)
        i += size
    return out


def _rle_planes(data: bytes, pos: int, n: int) -> np.ndarray:
    """(3, n) uint8: PIL's read_32 run-length planes read from pos."""
    planes = []
    for _ in range(3):
        out, left = bytearray(), n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                out += data[pos:pos + 1] * count
                pos += 1
            else:
                count = b + 1
                out += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"ICNS RGB plane ends {left} pixels off")
        if len(out) < n:
            raise ValueError("ICNS RGB data ends early")
        planes.append(np.frombuffer(bytes(out[:n]), np.uint8))
    return np.stack(planes)


def _rgb(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    n = side * side
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError("ICNS RGB data ends early")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3).copy()
    return _rle_planes(data, start, n).T.reshape(side, side, 3).copy()


def decode_icns(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of the icon of an ICNS file PIL opens, PIL's
    `convert("RGB")` of it byte for byte."""
    entries = _entries(data)
    sizes = [s for s, kinds in SIZES.items()
             if any(k in entries for k in kinds)]
    if not sizes:
        raise ValueError("ICNS without an icon PIL reads")
    best = max(sizes)
    side = best[0] * best[2]
    got = {}
    for kind in SIZES[best]:
        if kind not in entries:
            continue
        start, length = entries[kind]
        if kind in _MASKS:
            if len(data) - start < side * side:
                raise ValueError("ICNS mask runs past the end of the file")
        elif kind in _RGB:
            if kind == b"it32":
                if data[start:start + 4] != b"\x00" * 4:
                    raise ValueError("ICNS it32 without its four zero bytes")
                start, length = start + 4, length - 4
            got.setdefault("RGB", _rgb(data, start, length, side))
        else:
            head = data[start:start + 12]
            if head.startswith(png.MAGIC):
                got["RGBA"] = png.decode_png(data[start:])
            elif head.startswith(_J2K) or head == _J2K_BOX:
                got["RGBA"] = jp2.decode_jpeg2000(data[start:start + length])
            else:
                raise ValueError(f"ICNS {kind.decode('latin-1')} entry of "
                                 f"an unknown image format")
    if "RGBA" in got:
        img = got["RGBA"]
    elif "RGB" in got:
        img = got["RGB"]
    else:
        raise ValueError("ICNS icon with a mask and no colour")
    h, w = img.shape[:2]
    # IcnsImageFile's size setter: a size one of the file's sizes divides
    if not any(s[0] * s[2] // w == s[1] * s[2] / h for s in sizes):
        raise ValueError(f"ICNS icon of {w}x{h} fits none of its sizes")
    return img
