"""SPIDER decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_spider` returns those bytes for every file PIL's
SpiderImagePlugin opens. A SPIDER file has no magic number: PIL reads 27
float32 label fields, big-endian first and then little-endian, and takes
the file where fields 1, 2, 5, 12, 13, 22 and 23 (counted from 1) are
whole numbers, the file type (iform, field 5) is one it knows (1, 3,
-11, -12, -21, -22) and the header's bytes (labbyt, field 22) are the
records (field 13) times the record length (field 23), and not 0.

It opens a 2D image (iform 1): nsam (field 12) float32 samples a row,
nrow (field 2) rows, in the header's byte order, after the header; of a
volume of iform 1 (nslice, field 1, above 1) that is the first slice.
A stack (istack, field 24, above 0 and imgnumber, field 27, 0) opens its
first image, which sits after the stack's header and the image's own
header, each labbyt bytes. Mode "F" converts to RGB as PFM does
(pnm.float_to_rgb: truncated toward zero, clamped to 0..255, NaN 0).

PIL opens no other kind: a volume of iform 3 and the Fourier forms
(-11, -12, -21, -22) are not 2D images to it, and the header of one image
of a stack read alone (istack 0, imgnumber above 0) fails in its reader.
They raise NotImplementedError naming them. A stack's inconsistent
fields, a negative header length and pixel data that ends early raise
ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb
from .pnm import float_to_rgb

IFORMS = (1, 3, -11, -12, -21, -22)
_KINDS = {3: "a volume (iform 3)", -11: "a 2D Fourier image (iform -11)",
          -12: "a 2D Fourier image (iform -12)",
          -21: "a 3D Fourier volume (iform -21)",
          -22: "a 3D Fourier volume (iform -22)"}
_FIELDS = 27        # the label fields PIL reads


def _whole(v: float) -> bool:
    """PIL's isInt: a finite float with no fraction."""
    return v == v and abs(v) != float("inf") and v == int(v)


def header(data: bytes):
    """(byte order, label fields counted from 1, header bytes) of a
    SPIDER header as PIL's reader takes it, or None."""
    if len(data) < 4 * _FIELDS:
        return None
    for e in "><":
        h = (99.0,) + struct.unpack_from(f"{e}{_FIELDS}f", data)
        if not all(_whole(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
            continue
        labbyt = int(h[22])
        if int(h[5]) in IFORMS and labbyt == int(h[13]) * int(h[23]) \
                and labbyt != 0:
            return e, h, labbyt
    return None


def accept(data: bytes) -> bool:
    """Whether PIL's SPIDER reader takes the file's label fields."""
    return header(data) is not None


def decode_spider(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a SPIDER file, PIL's `convert("RGB")` of it
    byte for byte."""
    found = header(data)
    if found is None:
        raise ValueError("not a SPIDER file")
    e, h, labbyt = found
    iform = int(h[5])
    if iform != 1:
        raise NotImplementedError(f"SPIDER of {_KINDS[iform]}, which PIL "
                                  f"does not open either, is not decoded "
                                  f"by the port")
    if labbyt < 0:
        raise ValueError(f"SPIDER header of {labbyt} bytes")
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = labbyt
    elif istack > 0 and imgnumber == 0:
        offset = 2 * labbyt
    elif istack == 0 and imgnumber > 0:
        raise NotImplementedError("SPIDER image of a stack read without "
                                  "the stack (which PIL does not open "
                                  "either) is not decoded by the port")
    else:
        raise ValueError("SPIDER stack header values are inconsistent")
    w, rows = int(h[12]), int(h[2])
    if w <= 0 or rows <= 0:
        raise ValueError(f"SPIDER image of {w}x{rows} pixels")
    bomb.check("SPIDER", w, rows)
    raw = data[offset:offset + 4 * w * rows]
    if len(raw) < 4 * w * rows:
        raise ValueError("SPIDER pixel data ends early")
    return float_to_rgb(np.frombuffer(raw, f"{e}f4").reshape(rows, w))
