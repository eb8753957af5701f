"""QOI ("Quite OK Image") decoding, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_qoi` returns those bytes for every file PIL's QoiImagePlugin
reads: a 14-byte header (magic "qoif", width, height, channels,
colour space), then the ops QOI_OP_RGB, RGBA, INDEX, DIFF, LUMA and RUN
from the pixel (0, 0, 0, 255). It is PIL's decoder, also where it departs
from the reference one: an index slot never written reads (0, 0, 0, 0),
and a run adds nothing to the index. Any channel count but 3 opens as
RGBA (alpha dropped). Data that ends before the last pixel raises
ValueError.

The ops are sequential, so the loop is Python over the bytes (about 0.1 s
for a 256x256 image).
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb

MAGIC = b"qoif"


def decode_qoi(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a QOI file, PIL's `convert("RGB")` of it byte for
    byte."""
    if not data.startswith(MAGIC) or len(data) < 14:
        raise ValueError("not a QOI file")
    w, h = struct.unpack_from(">II", data, 4)
    bomb.check("QOI", w, h)
    if w == 0 or h == 0:
        raise ValueError(f"QOI of {w}x{h} pixels")
    n = w * h
    out = bytearray()
    seen = {}
    r, g, b, a = 0, 0, 0, 255
    pos, end = 14, len(data)
    try:
        while len(out) < 4 * n:
            op = data[pos]
            pos += 1
            if op == 0xFE:                                  # QOI_OP_RGB
                r, g, b = data[pos], data[pos + 1], data[pos + 2]
                pos += 3
            elif op == 0xFF:                                # QOI_OP_RGBA
                r, g, b, a = data[pos], data[pos + 1], data[pos + 2], \
                    data[pos + 3]
                pos += 4
            elif op < 0x40:                                 # QOI_OP_INDEX
                r, g, b, a = seen.get(op, (0, 0, 0, 0))
            elif op < 0x80:                                 # QOI_OP_DIFF
                r = (r + ((op >> 4) & 3) - 2) % 256
                g = (g + ((op >> 2) & 3) - 2) % 256
                b = (b + (op & 3) - 2) % 256
            elif op < 0xC0:                                 # QOI_OP_LUMA
                dg = (op & 0x3F) - 32
                second = data[pos]
                pos += 1
                r = (r + dg + (second >> 4) - 8) % 256
                g = (g + dg) % 256
                b = (b + dg + (second & 15) - 8) % 256
            else:                                           # QOI_OP_RUN
                out += bytes((r, g, b, a)) * ((op & 0x3F) + 1)
                continue
            if pos > end:
                raise IndexError
            seen[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
            out += bytes((r, g, b, a))
    except IndexError:
        raise ValueError("QOI data ends before the last pixel") from None
    px = np.frombuffer(bytes(out[:4 * n]), np.uint8).reshape(h, w, 4)
    return np.ascontiguousarray(px[..., :3])
