"""Texture loading and filtered sampling (mipmapped smart-bicubic).

Counterpart of rlshaders_tpu/scene/texture.py. The host decodes an image
to (H, W, 3) float32 in storage space (no gamma: texture_gamma is applied
after filtering, in models/dispatch.py); `TextureStack.build` keeps every
mip level of every texture (2x box reduction) in one flat (TOTAL, 3)
table indexed through per-(texture, level) offsets and sizes, so a lookup
is a row gather with no per-texture control flow. The lookup is the JAX
package's analogue of Arnold's `smart_bicubic` MayaFile filter: a level of
detail from the ray footprint, Mitchell bicubic taps on the finer level
blended linearly with a bilinear tap on the coarser one, wrap addressing.

The JAX package decodes with PIL; the port decodes PNG (zlib and numpy:
8-bit RGB or RGBA, no interlace, the five row filters) and sequential
Huffman JPEG (scene/jpeg.py, equal to PIL's decode) itself, and raises on
any other format, naming it.
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..core import vec3
from ..core.vec3 import V3
from .jpeg import decode_jpeg

MAX_LEVELS = 12
# texel centres sit at (i + TEX_SHIFT) / size (OIIO and Arnold; the JAX
# package's RLS_TEX_SHIFT default)
TEX_SHIFT = 0.5

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"
# formats that raise
_MAGICS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
           (b"MM\x00*", "TIFF"), (b"\x76\x2f\x31\x01", "OpenEXR"))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of h
    scanlines of w pixels of bpp bytes, each led by its filter byte.

    A pixel's predictor reads its left, upper and upper-left neighbours,
    so the pixels of one anti-diagonal (x + y constant) are independent:
    the loop runs over the h + w - 1 diagonals, each one numpy step over
    its pixels and their bpp channels, with each row's own filter."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (w * bpp + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{h * (w * bpp + 1)}")
    rows = rows.reshape(h, w * bpp + 1)
    ftype = rows[:, 0].astype(np.int64)
    if (ftype > 4).any():
        y = int(np.argmax(ftype > 4))
        raise ValueError(f"PNG row {y} has filter type {ftype[y]}")
    data = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # a zero row above and a zero column left of the image: the neighbours
    # that PNG reads as 0
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a = out[y + 1, x]
        b = out[y, x + 1]
        c = out[y, x]
        f = ftype[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB or RGBA, non-interlaced PNG (the
    alpha channel is dropped, as PIL's convert("RGB") drops it)."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG file")
    pos = len(_PNG_MAGIC)
    header, idat = None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(
            f"PNG with bit depth {depth}, colour type {color}, interlace "
            f"{interlace}: only 8-bit RGB or RGBA without interlace is "
            f"decoded")
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    return px.reshape(h, w, channels)[..., :3]


def load_image(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) float32 in storage space: the
    8-bit values over 255 (texture_gamma is applied after filtering). PNG
    and JPEG; any other format raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_MAGIC):
        px = decode_png(data)
    elif data.startswith(_JPEG_MAGIC):
        px = decode_jpeg(data)
    else:
        kind = next((k for m, k in _MAGICS if data.startswith(m)),
                    "an unknown format")
        raise NotImplementedError(
            f"{path}: {kind} images are not decoded by the port (PNG and "
            f"JPEG only)")
    return px.astype(np.float32) / 255.0


def _downsample2(im: np.ndarray) -> np.ndarray:
    """2x box reduction with odd-size handling (duplicate last row/col)."""
    h, w = im.shape[:2]
    if h % 2:
        im = np.concatenate([im, im[-1:]], axis=0)
    if w % 2:
        im = np.concatenate([im, im[:, -1:]], axis=1)
    return 0.25 * (
        im[0::2, 0::2] + im[1::2, 0::2] + im[0::2, 1::2] + im[1::2, 1::2]
    )


class TextureStack(NamedTuple):
    """All mip levels of all textures packed into one flat texel table."""

    data: torch.Tensor      # (TOTAL, 3) float32 texels, row-major per level
    offset: torch.Tensor    # (N, L) int32 start of (tex, level) in data
    sizes: torch.Tensor     # (N, L, 2) int32 (h, w) per level
    n_levels: torch.Tensor  # (N,) int32 real levels per texture

    @staticmethod
    def build(images: list, device="cuda") -> "TextureStack":
        """The stack of `images` ((H, W, 3) float32 arrays) on `device`.
        Past a texture's last real level the tables repeat that level, so
        an over-large level of detail reads valid data. No image gives one
        black texel and one level."""
        if not images:
            return TextureStack(
                data=torch.zeros((1, 3), device=device),
                offset=torch.zeros((1, MAX_LEVELS), dtype=torch.int32,
                                   device=device),
                sizes=torch.ones((1, MAX_LEVELS, 2), dtype=torch.int32,
                                 device=device),
                n_levels=torch.ones((1,), dtype=torch.int32, device=device),
            )
        flat = []
        offs = np.zeros((len(images), MAX_LEVELS), np.int64)
        sizes = np.ones((len(images), MAX_LEVELS, 2), np.int64)
        n_levels = np.zeros((len(images),), np.int64)
        cursor = 0
        for i, im in enumerate(images):
            lv = im.astype(np.float32)
            lvl = 0
            while True:
                h, w = lv.shape[:2]
                offs[i, lvl] = cursor
                sizes[i, lvl] = (h, w)
                flat.append(lv.reshape(-1, 3))
                cursor += h * w
                lvl += 1
                if (h == 1 and w == 1) or lvl >= MAX_LEVELS:
                    break
                lv = _downsample2(lv)
            n_levels[i] = lvl
            offs[i, lvl:] = offs[i, lvl - 1]
            sizes[i, lvl:] = sizes[i, lvl - 1]

        def t(a, dtype):
            return torch.as_tensor(a, device=device).to(dtype)

        return TextureStack(
            data=t(np.concatenate(flat, axis=0), torch.float32),
            offset=t(offs, torch.int32), sizes=t(sizes, torch.int32),
            n_levels=t(n_levels, torch.int32),
        )


def _cubic_weights(t):
    """Mitchell-Netravali (B = C = 1/3) weights of the 4 taps around a
    sample at fractional position t in [0, 1)."""
    b = c = 1.0 / 3.0

    def k(x):
        ax = torch.abs(x)
        ax2 = ax * ax
        ax3 = ax2 * ax
        w1 = ((12 - 9 * b - 6 * c) * ax3 + (-18 + 12 * b + 6 * c) * ax2
              + (6 - 2 * b)) / 6.0
        w2 = ((-b - 6 * c) * ax3 + (6 * b + 30 * c) * ax2
              + (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6.0
        return torch.where(ax < 1.0, w1, torch.where(ax < 2.0, w2, 0.0))

    return [k(t + 1.0), k(t), k(t - 1.0), k(t - 2.0)]


def _fetch(stack: TextureStack, tid, lvl, y, x) -> V3:
    """Texels at integer (y, x) of level `lvl`, wrap addressing (floor
    modulo, as jnp.mod)."""
    h = stack.sizes[tid, lvl, 0]
    w = stack.sizes[tid, lvl, 1]
    yy = torch.remainder(y, h)
    xx = torch.remainder(x, w)
    rows = stack.data[(stack.offset[tid, lvl] + yy * w + xx).long()]
    return V3(rows[..., 0], rows[..., 1], rows[..., 2])


def _level_uv(stack: TextureStack, tid, lvl, uv):
    """Continuous texel coordinates on a level: (x0f, y0f, fx, fy). v runs
    up (image row 0 is v = 1)."""
    h = stack.sizes[tid, lvl, 0].to(torch.float32)
    w = stack.sizes[tid, lvl, 1].to(torch.float32)
    u = torch.remainder(uv[..., 0], 1.0) * w - TEX_SHIFT
    v = (1.0 - torch.remainder(uv[..., 1], 1.0)) * h - TEX_SHIFT
    x0f = torch.floor(u)
    y0f = torch.floor(v)
    return x0f, y0f, u - x0f, v - y0f


def _zero3(like) -> V3:
    z = torch.zeros_like(like)
    return V3(z, z, z)


def _bicubic_level(stack: TextureStack, tid, lvl, uv) -> V3:
    """Mitchell bicubic on one level (16 taps)."""
    x0f, y0f, fx, fy = _level_uv(stack, tid, lvl, uv)
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    wxs = _cubic_weights(fx)
    wys = _cubic_weights(fy)
    out = _zero3(fx)
    for dy in range(4):
        row = _zero3(fx)
        for dx in range(4):
            row = row + _fetch(stack, tid, lvl, y0 + (dy - 1),
                               x0 + (dx - 1)) * wxs[dx]
        out = out + row * wys[dy]
    return out


def _bilinear_level(stack: TextureStack, tid, lvl, uv) -> V3:
    """Bilinear on one level (4 taps)."""
    x0f, y0f, fx, fy = _level_uv(stack, tid, lvl, uv)
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    c00 = _fetch(stack, tid, lvl, y0, x0)
    c01 = _fetch(stack, tid, lvl, y0, x0 + 1)
    c10 = _fetch(stack, tid, lvl, y0 + 1, x0)
    c11 = _fetch(stack, tid, lvl, y0 + 1, x0 + 1)
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def compute_lod(stack: TextureStack, tex_id, fp_uv, bias: float = 0.0):
    """Continuous mip level from a UV-space footprint: log2 of the texels
    it covers at level 0 (fp_uv times the larger side), plus `bias`,
    clamped to the texture's levels."""
    tid = torch.clamp_min(tex_id, 0).long()
    w = stack.sizes[tid, 0, 1].to(torch.float32)
    h = stack.sizes[tid, 0, 0].to(torch.float32)
    texels = fp_uv * torch.maximum(h, w)
    lod = torch.log2(torch.clamp_min(texels, 1e-12)) + bias
    top = (stack.n_levels[tid] - 1).to(torch.float32)
    return torch.clamp(torch.clamp_min(lod, 0.0), max=top)


def _blend(fine: V3, coarse: V3, frac) -> V3:
    return fine * (1.0 - frac) + coarse * frac


def sample_smart_bicubic(stack: TextureStack, tex_id, uv, lod=None) -> V3:
    """Mitchell bicubic on the finer level of `lod` (a continuous level;
    None = level 0), blended linearly with a bilinear tap on the coarser
    one. tex_id < 0 (no texture) returns 1; uv wraps."""
    tid = torch.clamp_min(tex_id, 0).long()
    if lod is None:
        out = _bicubic_level(stack, tid, 0, uv)
    else:
        l0 = torch.floor(lod).long()
        l1 = torch.clamp_max(l0 + 1, MAX_LEVELS - 1)
        out = _blend(_bicubic_level(stack, tid, l0, uv),
                     _bilinear_level(stack, tid, l1, uv),
                     lod - l0.to(torch.float32))
    return vec3.where(tex_id >= 0, out, 1.0)


def sample_bicubic(stack: TextureStack, tex_id, uv) -> V3:
    """Level-0 Mitchell bicubic lookup."""
    return sample_smart_bicubic(stack, tex_id, uv, None)


def sample_bilinear(stack: TextureStack, tex_id, uv, lod=None) -> V3:
    """Bilinear lookup with wrap addressing, blended between two levels
    when `lod` is given."""
    tid = torch.clamp_min(tex_id, 0).long()
    if lod is None:
        out = _bilinear_level(stack, tid, 0, uv)
    else:
        l0 = torch.floor(lod).long()
        l1 = torch.clamp_max(l0 + 1, MAX_LEVELS - 1)
        out = _blend(_bilinear_level(stack, tid, l0, uv),
                     _bilinear_level(stack, tid, l1, uv),
                     lod - l0.to(torch.float32))
    return vec3.where(tex_id >= 0, out, 1.0)
