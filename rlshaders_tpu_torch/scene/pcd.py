"""Kodak PhotoCD (PCD) decoding, equal to PIL's decode.

PIL's PcdImagePlugin reads only the 768x512 base image. Its `_open`
needs "PCD_" at byte 2048 and reads the orientation from byte 2048 +
1538 (`& 3`; a file too short to hold that byte passes to the next
plugin). Pillow's `PcdDecode.c` reads the base image from byte 96 x 2048
in chunks of 3 x 768 bytes: two rows of luma, then the two rows' chroma,
384 bytes of C1 and 384 of C2, each chroma sample shared by two
neighbouring columns of both rows. Its "YCC;P" unpacker converts
PhotoYCC to RGB through integer tables (r = L + CR, g = L + GB + GR,
b = L + CB, each clipped to 0..255), each entry (int)(k x (v - centre) +
0.5) as the constants below give it, held to the unpacker over all 2^24
inputs by the tests. Orientation 1 turns the image by 90 degrees and 3
by 270, both with `expand=True`, as PIL's `load_end` does. A file cut
before its 589,824 bytes of base image fails in PIL as "image file is
truncated" and raises ValueError here. The larger resolutions of a
PhotoCD file, which PIL does not read, are not read either.
"""
from __future__ import annotations

import numpy as np

from . import bomb, rawtile

BASE_OFFSET = 96 * 2048
BASE_BYTES = 768 * 512 * 3 // 2


def _table(k: float, centre: int) -> np.ndarray:
    return np.trunc(k * (np.arange(256) - centre) + 0.5).astype(np.int32)


# Pillow's UnpackYCC tables: Y = 1.3584 L, C1 = Cb - 156, C2 = Cr - 137
_L = _table(1.3584, 0)
_CB = _table(2.2179, 156)
_GB = _table(-0.4303, 156)
_CR = _table(1.8215, 137)
_GR = _table(-0.9271, 137)


def ycc_to_rgb(y: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Pillow's "YCC;P" unpacker of uint8 PhotoYCC samples: (..., 3)
    uint8."""
    lum = _L[y]
    return np.clip(np.stack([lum + _CR[c2], lum + _GB[c1] + _GR[c2],
                             lum + _CB[c1]], -1), 0, 255).astype(np.uint8)


def _header(data: bytes) -> int:
    """The orientation (0-3); Next where PIL passes the file on."""
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_") or len(s) < 1539:
        raise rawtile.Next("not a PhotoCD file")
    return s[1538] & 3


def accept(data: bytes) -> bool:
    return rawtile.takes(_header, data)


def decode_pcd(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a PhotoCD file's base image, PIL's
    `convert("RGB")` of it byte for byte."""
    turn = _header(data)
    bomb.check("PCD", *((512, 768) if turn in (1, 3) else (768, 512)))
    base = data[BASE_OFFSET:BASE_OFFSET + BASE_BYTES]
    if len(base) < BASE_BYTES:
        raise ValueError("PhotoCD base image truncated (PIL: image file is "
                         "truncated)")
    chunks = np.frombuffer(base, np.uint8).reshape(256, 3 * 768)
    y = chunks[:, :1536].reshape(512, 768)
    col = np.arange(768) // 2
    c1 = np.repeat(chunks[:, 1536 + col], 2, axis=0)
    c2 = np.repeat(chunks[:, 1920 + col], 2, axis=0)
    rgb = ycc_to_rgb(y, c1, c2)
    return np.ascontiguousarray(np.rot90(rgb, {1: 1, 3: 3}.get(turn, 0)))
