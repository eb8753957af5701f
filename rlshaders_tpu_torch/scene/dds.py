"""DDS (DirectDraw Surface) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_dds` returns those bytes for the first surface (mip level 0, the
first face or slice) of every DDS file PIL's DdsImagePlugin decodes and
the port has a decoder for:

* uncompressed RGB(A) with any bit masks (PIL's DdsRgbDecoder: each
  channel is int((v & mask) >> shift) / (mask >> shift) * 255), 8-bit
  luminance, 16-bit luminance and alpha, 8-bit palette indices through
  the 256 RGBA entries after the header, and DX10 R8G8B8A8;
* block compression, as Pillow's BcnDecode.c decodes it: BC1/DXT1 (two
  5-6-5 end points widened by bit replication, the four-colour mode
  where c0 > c1, else three colours and transparent black), BC2/DXT3 and
  BC3/DXT5 (the BC1 colour block, always in four-colour mode; their alpha
  is dropped by the RGB conversion), BC5 unsigned and signed (two BC4
  channels as red and green, blue 0, or 128 when signed). Interpolated
  values truncate, as the integer divisions of BcnDecode.c do. Blocks
  cover 4x4 pixels; the last row and column of blocks are cut to the
  image.

Blocks decode as numpy over all blocks of the image at once, never a
Python loop a block. BC4, BC6H and BC7 (and DXGI formats PIL does not
decode) raise NotImplementedError naming them; malformed data raises
ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = b"DDS "
_RGB, _ALPHAPIXELS, _LUMINANCE, _PALETTE8, _FOURCC = (0x40, 0x1, 0x20000,
                                                       0x20, 0x4)
_FOURCCS = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3",
            b"BC5U": "BC5", b"ATI2": "BC5", b"BC5S": "BC5S",
            b"BC4U": "BC4", b"ATI1": "BC4"}
# DXGI formats PIL's plugin knows
_DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3", 77: "BC3",
         79: "BC4", 80: "BC4", 82: "BC5", 83: "BC5", 84: "BC5S",
         95: "BC6H", 96: "BC6HS", 97: "BC7", 98: "BC7", 99: "BC7",
         27: "RGBA", 28: "RGBA", 29: "RGBA"}
_BLOCK_BYTES = {"BC1": 8, "BC2": 16, "BC3": 16, "BC5": 16, "BC5S": 16}


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _rgb565(c: np.ndarray) -> np.ndarray:
    """(..., 3) int64 of 5-6-5 words widened as BcnDecode.c's decode_565."""
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)


def _bc1_colour(blocks: np.ndarray, four: bool) -> np.ndarray:
    """(n, 16, 3) uint8 of (n, 8) BC1 colour blocks."""
    w = blocks.astype(np.int64)
    c0 = w[:, 0] | w[:, 1] << 8
    c1 = w[:, 2] | w[:, 3] << 8
    lut = w[:, 4] | w[:, 5] << 8 | w[:, 6] << 16 | w[:, 7] << 24
    p0, p1 = _rgb565(c0), _rgb565(c1)
    mode4 = ((c0 > c1) | four)[:, None]
    p2 = np.where(mode4, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(mode4, (p0 + 2 * p1) // 3, 0)
    pal = np.stack([p0, p1, p2, p3], 1)                 # (n, 4, 3)
    sel = (lut[:, None] >> (2 * np.arange(16))) & 3     # (n, 16)
    return np.take_along_axis(pal, sel[..., None], 1).astype(np.uint8)


def _bc4(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """(n, 16) uint8 of (n, 8) BC4 blocks (BcnDecode.c decode_bc3_alpha)."""
    w = blocks.astype(np.int64)
    a0, a1 = w[:, 0], w[:, 1]
    if signed:                        # int8 end points + 128
        a0, a1 = a0 ^ 0x80, a1 ^ 0x80
    bits = sum(w[:, 2 + i] << (8 * i) for i in range(6))
    big = (a0 > a1)[:, None]
    k = np.arange(1, 7)[None]
    a0c, a1c = a0[:, None], a1[:, None]
    lerp7 = ((7 - k) * a0c + k * a1c) // 7
    k5 = np.arange(1, 5)[None]
    lerp5 = np.concatenate([((5 - k5) * a0c + k5 * a1c) // 5,
                            np.zeros_like(a0c), np.full_like(a0c, 255)], 1)
    pal = np.concatenate([a0c, a1c, np.where(big, lerp7, lerp5)], 1)
    sel = (bits[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(pal, sel, 1).astype(np.uint8)


def _bcn(data: bytes, pos: int, fmt: str, w: int, h: int) -> np.ndarray:
    bw, bh = -(-w // 4), -(-h // 4)
    size = _BLOCK_BYTES[fmt]
    raw = data[pos:pos + bw * bh * size]
    if len(raw) < bw * bh * size:
        raise ValueError(f"DDS {fmt} data ends early")
    blocks = np.frombuffer(raw, np.uint8).reshape(bw * bh, size)
    if fmt == "BC1":
        px = _bc1_colour(blocks, False)
    elif fmt in ("BC2", "BC3"):
        px = _bc1_colour(blocks[:, 8:], True)
    else:
        # blue is 0, or 128 (a signed 0) in a signed file
        px = np.full((bw * bh, 16, 3), 128 if fmt == "BC5S" else 0,
                     np.uint8)
        px[..., 0] = _bc4(blocks[:, :8], fmt == "BC5S")
        px[..., 1] = _bc4(blocks[:, 8:], fmt == "BC5S")
    img = px.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, 3)[:h, :w])


def _masked(data: bytes, pos: int, w: int, h: int, bitcount: int,
            masks: tuple) -> np.ndarray:
    """PIL's DdsRgbDecoder: int(((v & mask) >> shift) / (mask >> shift) *
    255) a channel, 0 for an empty mask."""
    step = bitcount // 8
    if step == 0:
        raise ValueError(f"DDS of {bitcount} bits a pixel")
    raw = data[pos:pos + step * w * h]
    if len(raw) < step * w * h:
        raise ValueError("DDS pixel data ends early")
    b = np.frombuffer(raw, np.uint8).reshape(h * w, step).astype(np.uint64)
    v = sum(b[:, i] << np.uint64(8 * i) for i in range(step))
    out = []
    for mask in masks[:3]:
        if not mask:
            out.append(np.zeros(h * w, np.uint8))
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        c = ((v & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        out.append((c / total * 255).astype(np.uint8))
    return np.stack(out, -1).reshape(h, w, 3)


def decode_dds(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a DDS file's first surface, PIL's
    `convert("RGB")` of it byte for byte."""
    if not data.startswith(MAGIC) or len(data) < 128:
        raise ValueError("not a DDS file (or its header ends early)")
    if _u32(data, 4) != 124:
        raise ValueError(f"DDS header of {_u32(data, 4)} bytes")
    h, w = _u32(data, 12), _u32(data, 16)
    if w == 0 or h == 0:
        raise ValueError(f"DDS of {w}x{h} pixels")
    pfflags, fourcc, bitcount = _u32(data, 80), data[84:88], _u32(data, 88)
    pos = 128
    if pfflags & _RGB:
        n = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{n}I", data, 92)
        return _masked(data, pos, w, h, bitcount, masks)
    if pfflags & _LUMINANCE:
        if bitcount == 8 or (bitcount == 16 and pfflags & _ALPHAPIXELS):
            step = bitcount // 8
            raw = data[pos:pos + step * w * h]
            if len(raw) < step * w * h:
                raise ValueError("DDS pixel data ends early")
            g = np.frombuffer(raw, np.uint8).reshape(h, w, step)[..., :1]
            return np.repeat(g, 3, axis=2)
        raise NotImplementedError(f"DDS luminance of {bitcount} bits (which "
                                  f"PIL does not open either) is not "
                                  f"decoded by the port")
    if pfflags & _PALETTE8:
        pal = np.frombuffer(data[pos:pos + 1024], np.uint8)
        if pal.size < 1024:
            raise ValueError("DDS palette ends early")
        raw = data[pos + 1024:pos + 1024 + w * h]
        if len(raw) < w * h:
            raise ValueError("DDS pixel data ends early")
        idx = np.frombuffer(raw, np.uint8).reshape(h, w)
        return pal.reshape(256, 4)[:, :3][idx]
    if not pfflags & _FOURCC:
        raise NotImplementedError(f"DDS pixel format flags {pfflags} (which "
                                  f"PIL does not open either) are not "
                                  f"decoded by the port")
    if fourcc == b"DX10":
        if len(data) < 148:
            raise ValueError("DDS DX10 header ends early")
        dxgi = _u32(data, 128)
        pos = 148
        fmt = _DXGI.get(dxgi)
        if fmt is None:
            raise NotImplementedError(f"DDS DXGI format {dxgi} (which PIL "
                                      f"does not open either) is not "
                                      f"decoded by the port")
        if fmt == "RGBA":
            raw = data[pos:pos + 4 * w * h]
            if len(raw) < 4 * w * h:
                raise ValueError("DDS pixel data ends early")
            return np.frombuffer(raw, np.uint8).reshape(h, w, 4)[..., :3] \
                .copy()
    else:
        fmt = _FOURCCS.get(fourcc)
        if fmt is None:
            raise NotImplementedError(f"DDS pixel format {fourcc!r} (which "
                                      f"PIL does not open either) is not "
                                      f"decoded by the port")
    if fmt not in _BLOCK_BYTES:
        raise NotImplementedError(f"DDS {fmt} blocks are not decoded by the "
                                  f"port (BC1, BC2, BC3 and BC5 only)")
    return _bcn(data, pos, fmt, w, h)
