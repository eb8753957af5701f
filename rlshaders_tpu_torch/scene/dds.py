"""DDS (DirectDraw Surface) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_dds` returns those bytes for the first surface (mip level 0, the
first face or slice) of every DDS file PIL's DdsImagePlugin decodes:

* uncompressed RGB(A) with any bit masks (PIL's DdsRgbDecoder: each
  channel is int((v & mask) >> shift) / (mask >> shift) * 255), 8-bit
  luminance, 16-bit luminance and alpha, 8-bit palette indices through
  the 256 RGBA entries after the header, and DX10 R8G8B8A8;
* block compression, as Pillow's BcnDecode.c decodes it: BC1/DXT1 (two
  5-6-5 end points widened by bit replication, the four-colour mode
  where c0 > c1, else three colours and transparent black), BC2/DXT3 and
  BC3/DXT5 (the BC1 colour block, always in four-colour mode; their alpha
  is dropped by the RGB conversion), BC4 (one channel, PIL's mode "L",
  repeated as grey), BC5 unsigned and signed (two BC4 channels as red and
  green, blue 0, or 128 when signed), BC6H unsigned and signed (`_bc6h`)
  and BC7 (`_bc7`). BC1-BC5 interpolate with truncating integer
  divisions, as BcnDecode.c does. Blocks cover 4x4 pixels; the last row
  and column of blocks are cut to the image.

Blocks decode as numpy over all blocks of the image at once (BC6H and
BC7 over all blocks of each mode at once), never a Python loop a block.
Formats PIL does not decode either (BC4 SNORM as DXGI 81 or FourCC BC4S,
BC6H TYPELESS and the other DXGI formats) raise NotImplementedError
naming them; malformed data raises ValueError.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from . import bomb

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
# block formats PIL refuses, named in the port's message
_REFUSED_DXGI = {81: " (BC4 SNORM)", 94: " (BC6H TYPELESS)"}
_BLOCK_BYTES = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16,
                "BC5S": 16, "BC6H": 16, "BC6HS": 16, "BC7": 16}


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


# ---------------------------------------------------------------------------
# BC7 and BC6H: the tables of the D3D specification, as BcnDecode.c holds
# them. A partition is a 16-pixel map, pixel i's subset in bit i (two
# subsets) or bits 2i, 2i + 1 (three); the anchor of a subset is the
# pixel whose index has its top bit implied (0 for subset 0).
# ---------------------------------------------------------------------------

BC7_PARTITIONS2 = (
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22,
)
BC7_PARTITIONS3 = (
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000,
    0xA0A05050, 0x5555A0A0, 0x5A5A5050, 0xAA550000, 0xAA555500,
    0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450,
    0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0,
    0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4,
    0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414,
    0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
    0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0,
    0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444, 0x54A854A8,
    0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414,
    0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000,
    0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254,
)
# the anchor of subset 1 of each two-subset partition
BC7_ANCHORS2 = (
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
)
# the anchors of subsets 1 and 2 of each three-subset partition
BC7_ANCHORS3 = (
    (3, 15), (3, 8), (15, 8), (15, 3), (8, 15), (3, 15), (15, 3), (15, 8),
    (8, 15), (8, 15), (6, 15), (6, 15), (6, 15), (5, 15), (3, 15), (3, 8),
    (3, 15), (3, 8), (8, 15), (15, 3), (3, 15), (3, 8), (6, 15), (10, 8),
    (5, 3), (8, 15), (8, 6), (6, 10), (8, 15), (5, 15), (15, 10), (15, 8),
    (8, 15), (15, 3), (3, 15), (5, 10), (6, 10), (10, 8), (8, 9), (15, 10),
    (15, 6), (3, 15), (15, 8), (5, 15), (15, 3), (15, 6), (15, 6), (15, 8),
    (3, 15), (15, 3), (5, 15), (5, 15), (5, 15), (8, 15), (5, 15), (10, 15),
    (5, 15), (10, 15), (8, 15), (13, 15), (15, 3), (12, 15), (3, 15), (3, 8),
)
_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
            4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}


class _Bc7Mode(NamedTuple):
    subsets: int
    partition_bits: int
    rotation_bits: int
    selector_bits: int
    colour_bits: int
    alpha_bits: int
    endpoint_pbits: bool     # a p-bit an end point
    shared_pbits: bool       # a p-bit a subset (mode 1)
    index_bits: int
    index2_bits: int         # the second index set of modes 4 and 5


BC7_MODES = (
    _Bc7Mode(3, 4, 0, 0, 4, 0, True, False, 3, 0),
    _Bc7Mode(2, 6, 0, 0, 6, 0, False, True, 3, 0),
    _Bc7Mode(3, 6, 0, 0, 5, 0, False, False, 2, 0),
    _Bc7Mode(2, 6, 0, 0, 7, 0, True, False, 2, 0),
    _Bc7Mode(1, 0, 2, 1, 5, 6, False, False, 2, 3),
    _Bc7Mode(1, 0, 2, 0, 7, 8, False, False, 2, 2),
    _Bc7Mode(1, 0, 0, 0, 7, 7, True, False, 4, 0),
    _Bc7Mode(2, 6, 0, 0, 5, 5, True, False, 2, 0),
)


def subset_map(subsets: int, count: int = 64) -> np.ndarray:
    """(count, 16) int64: the subset of each pixel of each partition."""
    if subsets == 1:
        return np.zeros((count, 16), np.int64)
    table, bits = ((BC7_PARTITIONS2, 1) if subsets == 2
                   else (BC7_PARTITIONS3, 2))
    t = np.asarray(table[:count], np.int64)[:, None]
    return (t >> (bits * np.arange(16))) & ((1 << bits) - 1)


def anchor_map(subsets: int, count: int = 64) -> np.ndarray:
    """(count, 16) bool: the anchor pixels of each partition."""
    out = np.zeros((count, 16), bool)
    out[:, 0] = True
    rows = np.arange(count)
    if subsets == 2:
        out[rows, np.asarray(BC7_ANCHORS2[:count])] = True
    elif subsets == 3:
        a = np.asarray(BC7_ANCHORS3[:count])
        out[rows, a[:, 0]] = True
        out[rows, a[:, 1]] = True
    return out


def _field(bits: np.ndarray, pos: int, n: int) -> np.ndarray:
    """(k,) int64: the n-bit fields at bit `pos` of (k, 128) bit rows,
    least significant bit first."""
    return bits[:, pos:pos + n].astype(np.int64) @ (
        np.int64(1) << np.arange(n, dtype=np.int64))


def _indices(bits: np.ndarray, pos: int, widths: np.ndarray) -> np.ndarray:
    """(k, 16) int64: pixel indices packed from bit `pos` at the per-pixel
    `widths` ((k, 16), the anchors one bit narrower)."""
    widths = np.broadcast_to(widths, (len(bits), 16))
    starts = pos + np.cumsum(widths, 1) - widths
    out = np.zeros(widths.shape, np.int64)
    for j in range(int(widths.max())):
        at = np.minimum(starts + j, 127)
        b = np.take_along_axis(bits, at, 1).astype(np.int64)
        out |= (b * (j < widths)) << j
    return out


def _expand(v: np.ndarray, bits: int) -> np.ndarray:
    """BcnDecode.c's expand_quantized: an n-bit value to 8 bits."""
    v = (v << (8 - bits)) & 255
    return v | (v >> bits)


def _bc7_mode(bits: np.ndarray, m: int) -> np.ndarray:
    """(k, 16, 4) int64 RGBA of the (k, 128) bit rows of mode-m blocks."""
    info = BC7_MODES[m]
    k, ns = len(bits), info.subsets
    pos = m + 1
    part = _field(bits, pos, info.partition_bits)
    pos += info.partition_bits
    rotation = _field(bits, pos, info.rotation_bits)
    pos += info.rotation_bits
    selector = _field(bits, pos, info.selector_bits)
    pos += info.selector_bits
    n_ep = 2 * ns
    cb, ab = info.colour_bits, info.alpha_bits
    ep = np.full((k, n_ep, 4), 255, np.int32)
    for c in range(3):
        for e in range(n_ep):
            ep[:, e, c] = _field(bits, pos, cb)
            pos += cb
    if ab:
        for e in range(n_ep):
            ep[:, e, 3] = _field(bits, pos, ab)
            pos += ab
    chans = 4 if ab else 3
    if info.endpoint_pbits or info.shared_pbits:
        cb, ab = cb + 1, ab + bool(ab)
        for e in range(0, n_ep, 1 if info.endpoint_pbits else 2):
            p = _field(bits, pos, 1)[:, None]
            pos += 1
            span = 1 if info.endpoint_pbits else 2
            ep[:, e:e + span, :chans] = ep[:, e:e + span, :chans] << 1 | \
                p[:, :, None]
    ep[..., :3] = _expand(ep[..., :3], cb)
    if ab:
        ep[..., 3] = _expand(ep[..., 3], ab)

    subset = subset_map(ns)[part]                         # (k, 16)
    anchors = anchor_map(ns)[part]
    ib, ib2 = info.index_bits, info.index2_bits
    i0 = _indices(bits, pos, ib - anchors)
    cw = np.asarray(_WEIGHTS[ib], np.int32)[i0]
    if ib2:
        first = np.zeros((1, 16), np.int64)
        first[0, 0] = 1
        i1 = _indices(bits, pos + 16 * ib - ns, ib2 - first)
        aw = np.asarray(_WEIGHTS[ib2], np.int32)[i1]
        sel = selector[:, None] == 1
        wc, wa = np.where(sel, aw, cw), np.where(sel, cw, aw)
    else:
        wc = wa = cw
    e0 = np.take_along_axis(ep, (2 * subset)[..., None], 1)   # (k, 16, 4)
    e1 = np.take_along_axis(ep, (2 * subset + 1)[..., None], 1)
    w = np.concatenate([np.repeat(wc[..., None], 3, 2), wa[..., None]], 2)
    px = ((64 - w) * e0 + w * e1 + 32) >> 6
    for r in (1, 2, 3):                # rotation swaps a channel and alpha
        sw = rotation == r
        px[sw, :, r - 1], px[sw, :, 3] = px[sw, :, 3], px[sw, :, r - 1]
    return px


# the lowest set bit of each byte value (8 for 0)
_LOWEST_BIT = np.array([8] + [(v & -v).bit_length() - 1
                              for v in range(1, 256)], np.int64)


def _bc7(blocks: np.ndarray) -> np.ndarray:
    """(n, 16, 3) uint8 of (n, 16) BC7 blocks. The mode is the lowest set
    bit of the first byte; a first byte of 0 (a reserved mode) is black,
    as BcnDecode.c decodes it (opaque there; the RGB conversion drops
    alpha)."""
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    mode = _LOWEST_BIT[blocks[:, 0]]
    out = np.zeros((len(blocks), 16, 3), np.uint8)
    for m in range(8):
        sel = mode == m
        if sel.any():
            out[sel] = _bc7_mode(bits[sel], m)[..., :3]
    return out


class _Bc6Mode(NamedTuple):
    subsets: int
    transformed: bool        # end points after the first are deltas
    partition_bits: int
    endpoint_bits: int
    delta_bits: tuple        # (r, g, b)
    layout: str              # the end points' bits in stream order


# The 14 modes in BcnDecode.c's order (the D3D specification's modes 1-14;
# mode byte 00, 01, then 00010 ... 11110, then 00011 ... 01111). In a
# layout, w and x are subset 0's end points, y and z subset 1's; "rw0..9"
# is rw's bits 0 to 9 in stream order, "rw15..10" its bits 15 down to 10.
BC6_MODES = (
    _Bc6Mode(2, True, 5, 10, (5, 5, 5),
             "gy4 by4 bz4 rw0..9 gw0..9 bw0..9 rx0..4 gz4 gy0..3 gx0..4 "
             "bz0 gz0..3 bx0..4 bz1 by0..3 ry0..4 bz2 rz0..4 bz3"),
    _Bc6Mode(2, True, 5, 7, (6, 6, 6),
             "gy5 gz4 gz5 rw0..6 bz0 bz1 by4 gw0..6 by5 bz2 gy4 bw0..6 bz3 "
             "bz5 bz4 rx0..5 gy0..3 gx0..5 gz0..3 bx0..5 by0..3 ry0..5 "
             "rz0..5"),
    _Bc6Mode(2, True, 5, 11, (5, 4, 4),
             "rw0..9 gw0..9 bw0..9 rx0..4 rw10 gy0..3 gx0..3 gw10 bz0 "
             "gz0..3 bx0..3 bw10 bz1 by0..3 ry0..4 bz2 rz0..4 bz3"),
    _Bc6Mode(2, True, 5, 11, (4, 5, 4),
             "rw0..9 gw0..9 bw0..9 rx0..3 rw10 gz4 gy0..3 gx0..4 gw10 "
             "gz0..3 bx0..3 bw10 bz1 by0..3 ry0..3 bz0 bz2 rz0..3 gy4 bz3"),
    _Bc6Mode(2, True, 5, 11, (4, 4, 5),
             "rw0..9 gw0..9 bw0..9 rx0..3 rw10 by4 gy0..3 gx0..3 gw10 bz0 "
             "gz0..3 bx0..4 bw10 by0..3 ry0..3 bz1 bz2 rz0..3 bz4 bz3"),
    _Bc6Mode(2, True, 5, 9, (5, 5, 5),
             "rw0..8 by4 gw0..8 gy4 bw0..8 bz4 rx0..4 gz4 gy0..3 gx0..4 bz0 "
             "gz0..3 bx0..4 bz1 by0..3 ry0..4 bz2 rz0..4 bz3"),
    _Bc6Mode(2, True, 5, 8, (6, 5, 5),
             "rw0..7 gz4 by4 gw0..7 bz2 gy4 bw0..7 bz3 bz4 rx0..5 gy0..3 "
             "gx0..4 bz0 gz0..3 bx0..4 bz1 by0..3 ry0..5 rz0..5"),
    _Bc6Mode(2, True, 5, 8, (5, 6, 5),
             "rw0..7 bz0 by4 gw0..7 gy5 gy4 bw0..7 gz5 bz4 rx0..4 gz4 "
             "gy0..3 gx0..5 gz0..3 bx0..4 bz1 by0..3 ry0..4 bz2 rz0..4 bz3"),
    _Bc6Mode(2, True, 5, 8, (5, 5, 6),
             "rw0..7 bz1 by4 gw0..7 by5 gy4 bw0..7 bz5 bz4 rx0..4 gz4 "
             "gy0..3 gx0..4 bz0 gz0..3 bx0..5 by0..3 ry0..4 bz2 rz0..4 bz3"),
    _Bc6Mode(2, False, 5, 6, (6, 6, 6),
             "rw0..5 gz4 bz0 bz1 by4 gw0..5 gy5 by5 bz2 gy4 bw0..5 gz5 bz3 "
             "bz5 bz4 rx0..5 gy0..3 gx0..5 gz0..3 bx0..5 by0..3 ry0..5 "
             "rz0..5"),
    _Bc6Mode(1, False, 0, 10, (10, 10, 10),
             "rw0..9 gw0..9 bw0..9 rx0..9 gx0..9 bx0..9"),
    _Bc6Mode(1, True, 0, 11, (9, 9, 9),
             "rw0..9 gw0..9 bw0..9 rx0..8 rw10 gx0..8 gw10 bx0..8 bw10"),
    _Bc6Mode(1, True, 0, 12, (8, 8, 8),
             "rw0..9 gw0..9 bw0..9 rx0..7 rw11..10 gx0..7 gw11..10 bx0..7 "
             "bw11..10"),
    _Bc6Mode(1, True, 0, 16, (4, 4, 4),
             "rw0..9 gw0..9 bw0..9 rx0..3 rw15..10 gx0..3 gw15..10 bx0..3 "
             "bw15..10"),
)


def bc6_layout(layout: str) -> np.ndarray:
    """(n, 2) int64 of a layout string: for each stream bit, the end point
    value it sets (0-11: rw gw bw rx gx bx ry gy by rz gz bz) and the bit
    of that value."""
    out = []
    for tok in layout.split():
        value = "wxyz".index(tok[1]) * 3 + "rgb".index(tok[0])
        lo, _, hi = tok[2:].partition("..")
        lo = int(lo)
        hi = int(hi) if hi else lo
        step = 1 if hi >= lo else -1
        out += [(value, b) for b in range(lo, hi + step, step)]
    return np.asarray(out, np.int64)


def _sext(v: np.ndarray, bits) -> np.ndarray:
    """BcnDecode.c's bc6_sign_extend: an n-bit two's complement value as
    a 16-bit word."""
    bits = np.asarray(bits, np.int64)
    neg = (v >> (bits - 1)) & 1
    return np.where(neg == 1, (v | (-1 << bits)) & 0xFFFF, v)


def _bc6_unquantize(v: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    """BcnDecode.c's bc6_unquantize of 16-bit words `v` of `prec` bits."""
    if not signed:
        if prec >= 15:
            return v
        q = ((v << 16) + 0x8000) >> prec
        return np.where(v == 0, 0, np.where(v == (1 << prec) - 1, 0xFFFF, q))
    if prec >= 16:
        return np.where(v & 0x8000, v - 0x10000, v)
    neg = (v & 0x8000) != 0
    a = np.where(neg, (-v) & 0xFFFF, v)
    q = ((a << 15) + 0x4000) >> (prec - 1)
    q = np.where(a >= (1 << (prec - 1)) - 1, 0x7FFF, q)
    return np.where(a == 0, 0, np.where(neg, -q, q))


def _bc6_to_8bit(v: np.ndarray, signed: bool) -> np.ndarray:
    """BcnDecode.c's bc6_finalize and bc6_clamp: the interpolated value
    scaled to a half float (x 31/64 unsigned, x 31/32 signed, the sign
    kept), that half as a float, clamped to [0, 1] and truncated to 8 bits
    as (UINT8)(f * 255.0f); NaN, which the cast leaves undefined, is 0 on
    x86 as there."""
    if signed:
        half = np.where(v < 0, 0x8000 | ((-v) * 31 // 32), v * 31 // 32)
    else:
        half = v * 31 // 64
    f = (half & 0xFFFF).astype(np.uint16).view(np.float16).astype(
        np.float32)
    with np.errstate(invalid="ignore"):
        g = (np.clip(np.nan_to_num(f, nan=0.0), 0.0, 1.0)
             * np.float32(255.0)).astype(np.uint8)
    return np.where(f > 1.0, np.uint8(255), g)


def _bc6_mode(bits: np.ndarray, m: int, signed: bool) -> np.ndarray:
    """(k, 16, 3) uint8 of the (k, 128) bit rows of mode-m BC6H blocks."""
    info = BC6_MODES[m]
    ns = info.subsets
    layout = bc6_layout(info.layout)
    pos = 2 if m < 2 else 5
    raw = bits[:, pos:pos + len(layout)].astype(np.int64) << layout[:, 1]
    ep = raw @ (layout[:, :1] == np.arange(12)).astype(np.int64)  # (k, 12)
    pos += len(layout)
    part = _field(bits, pos, info.partition_bits)
    pos += info.partition_bits
    n_ep = 6 * ns
    prec = info.endpoint_bits
    mask = (1 << prec) - 1
    if signed:
        ep[:, :3] = _sext(ep[:, :3], prec)
    if signed or info.transformed:
        ep[:, 3:n_ep] = _sext(ep[:, 3:n_ep],
                              np.tile(info.delta_bits, ns * 2 - 1))
    if info.transformed:             # no sign extension after this
        ep[:, 3:n_ep] = (ep[:, 3:n_ep] + np.tile(ep[:, :3], ns * 2 - 1)) \
            & mask
    ue = _bc6_unquantize(ep[:, :n_ep], prec, signed)

    ib = 3 if ns == 2 else 4
    subset = subset_map(ns, 32)[part]
    anchors = anchor_map(ns, 32)[part]
    w = np.asarray(_WEIGHTS[ib])[_indices(bits, pos, ib - anchors)]
    e0 = np.take_along_axis(ue.reshape(-1, 2 * ns, 3), (2 * subset)[..., None],
                            1)
    e1 = np.take_along_axis(ue.reshape(-1, 2 * ns, 3),
                            (2 * subset + 1)[..., None], 1)
    v = (e0 * (64 - w[..., None]) + e1 * w[..., None]) >> 6
    return _bc6_to_8bit(v, signed)


def _bc6_modes(first: np.ndarray) -> np.ndarray:
    """The BcnDecode.c mode number (0-13; 14 for the reserved values) of
    each block's first byte."""
    m5 = first & 0x1F
    low = m5 & 3
    return np.where(low < 2, low,
                    np.where(low == 2, 2 + (m5 >> 2),
                             np.minimum(10 + (m5 >> 2), 14)))


def _bc6h(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """(n, 16, 3) uint8 of (n, 16) BC6H blocks, as BcnDecode.c decodes them
    to 8 bits. Two departures from the D3D specification are kept: in a
    signed file the end points made from deltas are not sign-extended
    again (a value past the top of its range unquantizes to the largest
    positive one), and 16-bit signed end points (mode 14) are used as
    signed 16-bit words with no unquantization. The 5-bit mode values
    10011, 10111, 11011 and 11111 are reserved: black."""
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    mode = _bc6_modes(blocks[:, 0].astype(np.int64))
    out = np.zeros((len(blocks), 16, 3), np.uint8)
    for m in range(14):
        sel = mode == m
        if sel.any():
            out[sel] = _bc6_mode(bits[sel], m, signed)
    return out


def bcn(data: bytes, pos: int, fmt: str, w: int, h: int) -> np.ndarray:
    """(h, w, 3) uint8 of the `fmt` blocks (BC1 to BC7) at `pos`, as PIL's
    BCn decoder gives them (also FTEX's DXT1, ftex.py)."""
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
    elif fmt == "BC4":                    # PIL's mode "L", as grey
        px = np.repeat(_bc4(blocks, False)[..., None], 3, axis=2)
    elif fmt in ("BC6H", "BC6HS"):
        px = _bc6h(blocks, fmt == "BC6HS")
    elif fmt == "BC7":
        px = _bc7(blocks)
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
    bomb.check("DDS", w, h)
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
            what = _REFUSED_DXGI.get(dxgi, "")
            raise NotImplementedError(f"DDS DXGI format {dxgi}{what} (which "
                                      f"PIL does not open either) is not "
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
            what = " (BC4 SNORM)" if fourcc == b"BC4S" else ""
            raise NotImplementedError(f"DDS pixel format {fourcc!r}{what} "
                                      f"(which PIL does not open either) is "
                                      f"not decoded by the port")
    return bcn(data, pos, fmt, w, h)
