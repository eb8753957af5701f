"""PCX decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_pcx` returns those bytes for every file PIL's PcxImagePlugin
reads: a 128-byte header, then run-length coded scan lines (a byte
0xC0 | n repeats the next byte n times, any other byte is itself):

* 1 bit, 1 plane: mode "1" (a 1 is white);
* 1 bit, 2 or 4 planes: palette indices built from the bit planes, the
  16-colour palette of the header;
* version 5, 8 bits, 1 plane: grey ("L") unless the 769 bytes at the end
  of the file are a 0x0C byte and a palette that is not the grey ramp
  (then "P" through it);
* version 5, 8 bits, 3 planes: RGB, one plane after another in each line.

PIL's line length, not the header's: each plane holds (width * bits + 7)
// 8 bytes, rounded up to even where the header's own stride differs; the
bands of a line whose length is not a multiple of the width are moved
together as PcxDecode moves them, and the unpackers read the planes
where they read them. A run that
overruns its line, or data that ends before the last line, raises
ValueError; a layout PIL has no mode for raises NotImplementedError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb
from .png import unpack_samples


def accept(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def header_ok(data: bytes) -> bool:
    """Whether PIL's PcxImageFile._open gets past its size check and reads
    the header's 68 bytes (a file that fails either PIL tries as the next
    format)."""
    if not accept(data) or len(data) < 68:
        return False
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    return x1 + 1 > x0 and y1 + 1 > y0


def _lines(data: bytes, pos: int, linebytes: int, h: int) -> np.ndarray:
    """(h, linebytes) uint8: the run-length coded lines from `pos`."""
    out = bytearray()
    n = len(data)
    need = linebytes * h
    while len(out) < need:
        if pos >= n:
            raise ValueError("PCX pixel data ends early")
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise ValueError("PCX pixel data ends early")
            count = b & 0x3F
            if len(out) % linebytes + count > linebytes:
                raise ValueError("PCX run overruns its scan line")
            out += data[pos + 1:pos + 2] * count
            pos += 2
        else:
            out.append(b)
            pos += 1
    return np.frombuffer(bytes(out), np.uint8).reshape(h, linebytes)


def decode_pcx(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a PCX file, PIL's `convert("RGB")` of it byte for
    byte."""
    if not header_ok(data):
        raise ValueError("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    bomb.check("PCX", w, h)
    version, bits, planes = data[1], data[3], data[65]
    provided = struct.unpack_from("<H", data, 66)[0]
    pal = None
    if bits == 1 and planes == 1:
        kind = "1"
    elif bits == 1 and planes in (2, 4):
        kind = "planes"
        pal = np.zeros((256, 3), np.uint8)
        pal[:16] = np.frombuffer(data[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        kind = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            entries = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not np.array_equal(entries, np.repeat(
                    np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)):
                kind, pal = "P", entries
    elif version == 5 and bits == 8 and planes == 3:
        kind = "RGB"
    else:
        raise NotImplementedError(
            f"PCX version {version} of {bits}-bit pixels in {planes} planes "
            f"(which PIL does not open either) is not decoded by the port")
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    linebytes = planes * stride
    line = _lines(data, 128, linebytes, h).copy()
    # PIL's PcxDecode moves band i of a line from i * step to i * size
    # before unpacking: a bit plane's size is ceil(w / 8), any other band's
    # is w, and the step is the line's length over its bands
    if kind == "planes":
        size, bands = (w + 7) // 8, planes
    else:
        size, bands = w, linebytes // w
    step = linebytes // bands if bands else 0
    if step > size:
        for i in range(1, bands):
            line[:, i * size:(i + 1) * size] = line[:, i * step:i * step
                                                    + size]
    if kind == "1":
        v = unpack_samples(line, w, 1) * 255
        return np.repeat(v.astype(np.uint8)[..., None], 3, axis=2)
    if kind == "planes":
        idx = np.zeros((h, w), np.int64)
        for p in range(planes):
            idx |= unpack_samples(line[:, p * size:(p + 1) * size], w,
                                  1).astype(np.int64) << p
        return pal[idx]
    if kind == "RGB":            # "RGB;L": three planes of w bytes
        return np.ascontiguousarray(np.stack(
            [line[:, c * w:(c + 1) * w] for c in range(3)], -1))
    v = line[:, :w]
    if kind == "P":
        return pal[v]
    return np.repeat(v[..., None], 3, axis=2)
