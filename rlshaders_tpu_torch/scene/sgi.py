"""SGI image decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_sgi` returns those bytes for every file PIL's SgiImagePlugin
reads: a 512-byte header (magic 474), then verbatim planes or run-length
coded rows; 1 or 2 bytes a sample (16-bit samples keep their high byte,
as PIL's "L;16B" unpacker does); one (grey), three (RGB) or four (RGBA,
alpha dropped) channels; rows from the bottom up.

Run-length rows follow PIL's SgiRleDecode: the start and length tables
(big-endian, row-major within each channel) address each row's packets;
a packet's low 7 bits count the samples, its high bit says they follow
verbatim (else one sample repeats), a zero count ends the row. A row that
overruns the width or the file raises ValueError, as does a short file;
a layout PIL has no mode for raises NotImplementedError naming it.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb

MAGIC = 474
# (bytes a sample, dimension, channels) PIL opens (SgiImagePlugin.MODES)
_LAYOUTS = {(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (1, 3, 3), (2, 3, 3),
            (1, 3, 4), (2, 3, 4)}


def accept(data: bytes) -> bool:
    return len(data) >= 2 and struct.unpack_from(">H", data)[0] == MAGIC


def _rle_row(data: bytes, pos: int, length: int, w: int, bpc: int) -> list:
    """The samples of one run-length row (PIL's expandrow / expandrow2)."""
    out = []
    end = pos + length
    dt = ">u2" if bpc == 2 else np.uint8
    while pos < end:
        if pos + bpc > len(data):
            raise ValueError("SGI run-length row runs past the end of the "
                             "file")
        head = int.from_bytes(data[pos:pos + bpc], "big")
        pos += bpc
        count = head & 0x7F
        if not count:
            break
        if len(out) + count > w:
            raise ValueError("SGI run-length row overruns the width")
        if head & 0x80:
            chunk = data[pos:pos + bpc * count]
            if len(chunk) < bpc * count:
                raise ValueError("SGI run-length row runs past the end of "
                                 "the file")
            out.extend(np.frombuffer(chunk, dt).tolist())
            pos += bpc * count
        else:
            if pos + bpc > len(data):
                raise ValueError("SGI run-length row runs past the end of "
                                 "the file")
            out.extend([int.from_bytes(data[pos:pos + bpc], "big")] * count)
            pos += bpc
    return out


def decode_sgi(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an SGI file, PIL's `convert("RGB")` of it byte
    for byte."""
    if not accept(data) or len(data) < 512:
        raise ValueError("not an SGI file")
    compression, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">4H", data, 4)
    bomb.check("SGI", w, h)
    if (bpc, dim, z) not in _LAYOUTS:
        raise NotImplementedError(
            f"SGI of {bpc} bytes a sample, dimension {dim} and {z} channels "
            f"(which PIL does not open either) is not decoded by the port")
    if w == 0 or h == 0:
        raise ValueError(f"SGI of {w}x{h} pixels")
    if compression == 0:
        n = w * h * z * bpc
        raw = data[512:512 + n]
        if len(raw) < n:
            raise ValueError("SGI pixel data ends early")
        planes = np.frombuffer(raw, ">u2" if bpc == 2 else np.uint8)
        px = planes.reshape(z, h, w).transpose(1, 2, 0).astype(np.int64)
    elif compression == 1:
        tab = struct.unpack_from(f">{2 * h * z}I", data, 512)
        starts, lengths = tab[:h * z], tab[h * z:]
        px = np.zeros((h, w, z), np.int64)
        for c in range(z):
            for y in range(h):
                off, length = starts[y + c * h], lengths[y + c * h]
                if off < 512 or off + length > len(data):
                    raise ValueError("SGI run-length row outside the file")
                row = _rle_row(data, off, length, w, bpc)
                px[y, :len(row), c] = row
    else:
        raise NotImplementedError(f"SGI compression {compression} is not "
                                  f"decoded by the port")
    if bpc == 2:
        px = px >> 8
    px = px[::-1].astype(np.uint8)
    if z == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
