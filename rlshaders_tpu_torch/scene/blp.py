"""BLP (Blizzard Mipmap) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_blp` returns those bytes for mip level 0 of every BLP file PIL's
BlpImagePlugin decodes:

* BLP1 with JPEG data: the shared JPEG header and the level's bytes
  joined and decoded by the port's jpeg.py (four components as CMYK
  whatever the Adobe marker says: PIL asks libjpeg for CMYK, so a YCCK
  stream is not converted), and the RGB result read back as BGR, as PIL
  sets it (with the alpha flag too); BLP1 with palette indices
  (encodings 4 and 5), each byte through the 256 BGRA entries after the
  header;
* BLP2 with palette indices (encoding 1), and with DXT1, DXT3 or DXT5
  blocks (encoding 2), decoded as PIL's own Python functions decode them,
  not as its BcnDecode.c: 5-6-5 end points widened by a shift alone
  (no bit replication), DXT3 and DXT5 always in four-colour mode.

PIL joins the decoded pixels into one stream and reads the image's rows
from it, so a DXT image whose width is not a multiple of 4 reads the
padding pixels of each block row into the next row, and a DXT3 or DXT5
image without the alpha flag reads its RGBA stream as RGB; both are kept.
BLP2's raw BGRA encoding (3), which PIL does not decode either, and
compressions, encodings and alpha encodings PIL does not know raise
NotImplementedError naming them; malformed data raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb
from . import dds
from .jpeg import decode_jpeg

MAGICS = (b"BLP1", b"BLP2")


def _read(data: bytes, pos: int, n: int) -> bytes:
    """n bytes at pos, as PIL's _safe_read: all of them or an error."""
    if n <= 0:
        return b""
    out = data[pos:pos + n]
    if len(out) < n:
        raise ValueError("BLP data ends early")
    return out


def _palette(data: bytes, pos: int) -> np.ndarray:
    """(256, 4) uint8 RGBA of the 256 BGRA entries at pos."""
    bgra = np.frombuffer(_read(data, pos, 1024), np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3]]


def _rgb565(c: np.ndarray) -> np.ndarray:
    """(..., 3) int64 of 5-6-5 words as PIL's BLP unpack_565 widens them."""
    return np.stack([((c >> 11) & 31) << 3, ((c >> 5) & 63) << 2,
                     (c & 31) << 3], -1)


def _dxt_colour(blocks: np.ndarray, four: bool) -> tuple:
    """(n, 16, 3) int64 colours of (n, 8) colour blocks and (n, 16) bool,
    the pixels that are transparent black (DXT1's code 3 when c0 <= c1)."""
    w = blocks.astype(np.int64)
    c0 = w[:, 0] | w[:, 1] << 8
    c1 = w[:, 2] | w[:, 3] << 8
    lut = w[:, 4] | w[:, 5] << 8 | w[:, 6] << 16 | w[:, 7] << 24
    p0, p1 = _rgb565(c0), _rgb565(c1)
    mode4 = ((c0 > c1) | four)[:, None]
    p2 = np.where(mode4, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(mode4, (2 * p1 + p0) // 3, 0)
    pal = np.stack([p0, p1, p2, p3], 1)
    sel = (lut[:, None] >> (2 * np.arange(16))) & 3
    clear = (sel == 3) & ~mode4
    return np.take_along_axis(pal, sel[..., None], 1), clear


def _dxt(data: bytes, pos: int, w: int, h: int, kind: int,
         alpha: bool) -> np.ndarray:
    """The pixel stream of PIL's BLP2 DXT decode: each block row's four
    pixel rows of 4 * ceil(w / 4) pixels, RGB (DXT1 without alpha) or
    RGBA, as (pixels, channels) int64."""
    bw, bh = -(-w // 4), -(-h // 4)
    size = 8 if kind == 0 else 16
    blocks = np.frombuffer(_read(data, pos, bw * bh * size),
                           np.uint8).reshape(bw * bh, size)
    if kind == 0:
        rgb, clear = _dxt_colour(blocks, False)
        a = np.where(clear, 0, 255)
    else:
        rgb, _ = _dxt_colour(blocks[:, 8:], True)
        if kind == 1:                           # 4-bit alpha, low nibble first
            nib = blocks[:, :8].astype(np.int64)[:, np.arange(16) // 2]
            a = np.where(np.arange(16) % 2, nib >> 4, nib & 15) * 17
        else:
            a = dds._bc4(blocks[:, :8], False).astype(np.int64)
    px = np.concatenate([rgb, a[..., None]], -1)
    if kind == 0 and not alpha:
        px = px[..., :3]
    px = px.reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4)
    return px.reshape(bh * 4 * bw * 4, -1)


def _rows(stream: np.ndarray, w: int, h: int, channels: int) -> np.ndarray:
    """(h, w, 3) uint8: the first w * h pixels of a byte stream read as
    `channels` bytes a pixel (PIL's set_as_raw in the image's mode)."""
    flat = np.asarray(stream, np.uint8).reshape(-1)
    if flat.size < w * h * channels:
        raise ValueError("BLP data fills fewer pixels than the image has")
    return flat[:w * h * channels].reshape(h, w, channels)[..., :3].copy()


def decode_blp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a BLP file's first mip level, PIL's
    `convert("RGB")` of it byte for byte."""
    if data[:4] not in MAGICS or len(data) < 20:
        raise ValueError("not a BLP file (or its header ends early)")
    v1 = data[:4] == b"BLP1"
    compression = struct.unpack_from("<i", data, 4)[0]
    if v1:
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        start = 28
    else:
        encoding, alpha_flag, alpha_encoding = struct.unpack_from(
            "<3b", data, 8)
        alpha = alpha_flag != 0
        start = 20
    w, h = struct.unpack_from("<II", data, 12)
    bomb.check("BLP", w, h)
    if v1:
        if len(data) < 28:
            raise ValueError("BLP1 header ends early")
        encoding = struct.unpack_from("<i", data, 20)[0]
    if w == 0 or h == 0:
        raise ValueError(f"BLP of {w}x{h} pixels")
    offsets = struct.unpack("<16I", _read(data, start, 64))
    lengths = struct.unpack("<16I", _read(data, start + 64, 64))
    pos = start + 128
    channels = 4 if alpha else 3

    if v1:
        if compression == 0:
            size = struct.unpack("<I", _read(data, pos, 4))[0]
            head = _read(data, pos + 4, size)
            pos = max(pos + 4 + size, offsets[0])
            rgb = decode_jpeg(head + _read(data, pos, lengths[0]),
                              ycck=False)
            return _rows(rgb[..., ::-1], w, h, 3)
        if compression != 1:
            raise NotImplementedError(f"BLP1 compression {compression} "
                                      f"(which PIL does not open either) is "
                                      f"not decoded by the port")
        if encoding not in (4, 5):
            raise NotImplementedError(f"BLP1 encoding {encoding} (which PIL "
                                      f"does not open either) is not "
                                      f"decoded by the port")
        pal = _palette(data, pos)
        idx = np.frombuffer(_read(data, pos + 1024, lengths[0]), np.uint8)
        return _rows(pal[idx][:, :channels], w, h, channels)

    pal = _palette(data, pos)
    if compression != 1:
        raise NotImplementedError(f"BLP2 compression {compression} (which "
                                  f"PIL does not open either) is not "
                                  f"decoded by the port")
    if encoding == 1:
        idx = np.frombuffer(_read(data, offsets[0], lengths[0]), np.uint8)
        return _rows(pal[idx][:, :channels], w, h, channels)
    if encoding == 2:
        if alpha_encoding not in (0, 1, 7):
            raise NotImplementedError(
                f"BLP2 DXT alpha encoding {alpha_encoding} (which PIL does "
                f"not open either) is not decoded by the port")
        kind = {0: 0, 1: 1, 7: 2}[alpha_encoding]
        return _rows(_dxt(data, offsets[0], w, h, kind, alpha), w, h,
                     channels)
    what = " (raw BGRA)" if encoding == 3 else ""
    raise NotImplementedError(f"BLP2 encoding {encoding}{what} (which PIL "
                              f"does not open either) is not decoded by the "
                              f"port")
