"""MSP (Microsoft Paint) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_msp` returns those bytes for both versions PIL's MspImagePlugin
opens, each a 32-byte header whose sixteen 16-bit words XOR to 0 and
1-bit pixels, most significant bit first, white where set:

* version 1 ("DanM"): the rows raw, each padded to a byte;
* version 2 ("LinS"): a table of each row's byte count, then the rows
  run-length coded (a 0 byte, a count and a byte repeated; else a count
  and that many literal bytes). An empty row is white. PIL joins the
  decoded rows into one stream and reads the image from it, so a row
  that decodes to more or fewer bytes than a padded row moves the rest;
  that is kept.

Malformed data raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb

MAGICS = (b"DanM", b"LinS")


def accept(data: bytes) -> bool:
    """PIL's test of an MSP file: the magic and a header checksum of 0."""
    if data[:4] not in MAGICS or len(data) < 32:
        return False
    words = struct.unpack_from("<16H", data)
    check = 0
    for v in words:
        check ^= v
    return check == 0


def _rle_rows(data: bytes, h: int, stride: int) -> bytes:
    """PIL's MspDecoder: the rows after the row table, joined."""
    table = data[32:32 + 2 * h]
    if len(table) < 2 * h:
        raise ValueError("MSP row table ends early")
    out, pos = bytearray(), 32 + 2 * h
    for y, n in enumerate(struct.unpack(f"<{h}H", table)):
        if n == 0:
            out += b"\xff" * stride
            continue
        row = data[pos:pos + n]
        pos += n
        if len(row) != n:
            raise ValueError(f"MSP row {y} ends early")
        i = 0
        while i < n:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > n:
                    raise ValueError(f"MSP row {y} is corrupted")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + kind]
                i += kind
    return bytes(out)


def decode_msp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an MSP file, PIL's `convert("RGB")` of it byte
    for byte."""
    if not accept(data):
        raise ValueError("not an MSP file (or its checksum is not 0)")
    w, h = struct.unpack_from("<HH", data, 4)
    bomb.check("MSP", w, h)
    if w == 0 or h == 0:
        raise ValueError(f"MSP of {w}x{h} pixels")
    stride = (w + 7) // 8
    raw = data[32:] if data.startswith(b"DanM") else _rle_rows(data, h,
                                                                stride)
    if len(raw) < h * stride:
        raise ValueError("MSP pixel data ends early")
    rows = np.frombuffer(raw[:h * stride], np.uint8).reshape(h, stride)
    g = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    return np.repeat(g[..., None], 3, axis=2)
