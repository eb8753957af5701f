"""XBM (X11 bitmap) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_xbm` returns those bytes for every XBM file PIL's XbmImagePlugin
opens. The header is PIL's pattern over the first 512 bytes (the
`_width` and `_height` defines, an optional hotspot, then anything up to
the last `_bits[]`); after it PIL's XbmDecode.c takes the two characters
after each "x" as a hexadecimal byte (a character that is not a hex
digit counts as 0), each row its (width + 7) / 8 bytes, the bits of each
byte least significant first, white where set (PIL's mode "1"). Data
that ends before the last row raises ValueError.
"""
from __future__ import annotations

import re

import numpy as np

from . import bomb

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)
# the value of each byte as a hex digit (XbmDecode.c's HEX: others are 0)
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789abcdef":
    _HEX[_c] = int(chr(_c), 16)
    _HEX[ord(chr(_c).upper())] = int(chr(_c), 16)


def accept(data: bytes) -> bool:
    """PIL's test of an XBM file (its _accept; its _open then needs the
    header pattern)."""
    return data.lstrip().startswith(b"#define")


def decode_xbm(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an XBM file, PIL's `convert("RGB")` of it byte
    for byte."""
    m = _HEAD.match(data[:512])
    if not m:
        raise ValueError("not an XBM file (PIL's header pattern fails)")
    w, h = int(m.group("width")), int(m.group("height"))
    bomb.check("XBM", w, h)
    if w == 0 or h == 0:
        raise ValueError(f"XBM of {w}x{h} pixels")
    stride = (w + 7) // 8
    body = np.frombuffer(data, np.uint8)[m.end():]
    xs = np.flatnonzero(body == ord("x"))
    # each "x" starts a byte unless it is one of the two characters read
    # after the "x" before it
    keep, nxt = [], 0
    for i in xs.tolist():
        if i >= nxt:
            if i + 2 >= len(body):
                break
            keep.append(i)
            nxt = i + 3
            if len(keep) == h * stride:
                break
    if len(keep) < h * stride:
        raise ValueError("XBM data ends early")
    at = np.asarray(keep) + 1
    vals = (_HEX[body[at]] << 4) + _HEX[body[at + 1]]
    bits = np.unpackbits(vals.astype(np.uint8).reshape(h, stride), axis=1,
                         bitorder="little")[:, :w]
    return np.repeat((bits * np.uint8(255))[..., None], 3, axis=2)
