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

The JAX package decodes with PIL (`Image.open(path).convert("RGB")`); the
port decodes every texture it renders itself, with no PIL: `load_image`
names the format by the file's bytes, as PIL's `open` does (never by its
extension), and hands it to the port's decoder of it, each equal to PIL's
decode byte for byte: PNG (scene/png.py), JPEG (jpeg.py), GIF (gif.py),
BMP and DIB (bmp.py), TIFF (tiff.py, with lzw.py, jpeg.py, ccitt.py and
zstd.py, whose Zstandard decoder is native code; LAB converted as
LittleCMS converts it, lab.py), PNM and PFM (pnm.py), PCX (pcx.py), DCX
(dcx.py), DDS with BC1-BC7 blocks (dds.py), BLP (blp.py), ICO and CUR
(ico.py), ICNS (icns.py), IM (im.py), IMT (imt.py), IPTC (iptc.py), FITS
(fits.py), FLI and FLC (fli.py), PhotoCD (pcd.py), MSP (msp.py), QOI
(qoi.py), SGI (sgi.py), SPIDER (spider.py), TGA (tga.py), WebP, still
and animated (webp.py, with vp8l.py for lossless and vp8.py for lossy
images), JPEG 2000 as J2K and JP2 files (jp2.py, with j2k.py and
j2k_t1.py, whose tier-1 is native code), AVIF: still, grids and an image
sequence's first frame, frames libavif scales (avif.py, with av1.py,
whose tile decoder is native code, and yuvscale.py), PSD (psd.py, LAB
through lab.py), Sun raster (sun.py), XPM (xpm.py), FTEX (ftex.py), GIMP
brushes (gbr.py), PIXAR (pixar.py), McIdas (mcidas.py), XV thumbnails
(xvthumb.py) and XBM (xbm.py). Every decoder keeps PIL's
decompression-bomb limit (bomb.py). A format PIL opens and the port does
not decode (BUFR, EPS, GRIB, HDF5, WMF/EMF and the rest of PIL's
plugins) raises NotImplementedError naming it; MPEG, which PIL opens and
cannot load, raises ValueError; data that no PIL plugin accepts raises
NotImplementedError as an unknown format.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from ..core import vec3
from ..core.vec3 import V3
from . import (avif, blp, bmp, dcx, dds, fits, fli, ftex, gbr, gif, icns,
               ico, im, imt, iptc, jp2, mcidas, msp, pcd, pcx, pixar, png,
               pnm, psd, qoi, sgi, spider, sun, tga, tiff, webp, xbm, xpm,
               xvthumb)
from .jpeg import decode_jpeg
from .png import decode_png

MAX_LEVELS = 12
# texel centres sit at (i + TEX_SHIFT) / size (OIIO and Arnold; the JAX
# package's RLS_TEX_SHIFT default)
TEX_SHIFT = 0.5


def _u32(d: bytes) -> int:
    return struct.unpack_from("<I", d.ljust(4, b"\x00"))[0]


def _mpeg_size(d: bytes) -> bool:
    """PIL's MpegImagePlugin opens a sequence header whose 12-bit width
    and height (after the start code) are both set."""
    return len(d) >= 7 and d.startswith(b"\x00\x00\x01\xb3") and bool(
        d[4] << 4 | d[5] >> 4) and bool((d[5] & 15) << 8 | d[6])


def _mpeg(d: bytes) -> np.ndarray:
    raise ValueError("MPEG: PIL opens the stream and cannot load an image "
                     "from it")


# PIL's plugins in the order its `open` tries them (Image.ID: BMP, DIB,
# GIF, JPEG, PPM and PNG first, then the rest as PIL.__init__ lists
# them): (name, the test of the file's bytes, the port's decoder or None).
# A test is the plugin's `_accept`, and for the formats whose `_open`
# may still refuse a file it accepted (PNM, PCX, DCX, FITS, FLI, FTEX,
# GBR, TGA, ICO, CUR, MSP, MCIDAS, MPEG, PIXAR, SUN, XPM, XVThumb: PIL
# then tries the next plugin), that check too; IM, IMT, IPTC and PCD have
# no prefix test, so their header readers decide (IMT's and IPTC's run on
# every file the plugins before them refuse). The name of a decoded
# format is PIL's `format` for it.
_FORMATS = (
    ("BMP", lambda d: d.startswith(bmp.MAGIC), bmp.decode_bmp),
    ("DIB", bmp.dib_accept, bmp.decode_dib),
    ("GIF", lambda d: d.startswith(gif.MAGICS), gif.decode_gif),
    ("JPEG", lambda d: d.startswith(b"\xff\xd8\xff"), decode_jpeg),
    ("PPM", pnm.header_ok, pnm.decode_pnm),
    ("PNG", lambda d: d.startswith(png.MAGIC), decode_png),
    ("AVIF", avif.accept, avif.decode_avif),
    ("BLP", lambda d: d[:4] in blp.MAGICS, blp.decode_blp),
    ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), None),
    ("CUR", lambda d: ico.accept(d, ico.CUR_MAGIC), ico.decode_cur),
    ("PCX", pcx.header_ok, pcx.decode_pcx),
    ("DCX", dcx.accept, dcx.decode_dcx),
    ("DDS", lambda d: d.startswith(dds.MAGIC), dds.decode_dds),
    ("EPS", lambda d: d.startswith(b"%!PS") or _u32(d) == 0xC6D3D0C5, None),
    ("FITS", fits.accept, fits.decode_fits),
    ("FLI", fli.accept, fli.decode_fli),
    ("FTEX", ftex.accept, ftex.decode_ftex),
    ("GBR", gbr.accept, gbr.decode_gbr),
    ("GRIB", lambda d: d.startswith(b"GRIB") and len(d) > 7 and d[7] == 1,
     None),
    ("HDF5", lambda d: d.startswith(b"\x89HDF\r\n\x1a\n"), None),
    ("JPEG2000", jp2.accept, jp2.decode_jpeg2000),
    ("ICNS", lambda d: d.startswith(icns.MAGIC), icns.decode_icns),
    ("ICO", lambda d: ico.accept(d, ico.ICO_MAGIC), ico.decode_ico),
    ("IM", im.accept, im.decode_im),
    ("IMT", imt.accept, imt.decode_imt),
    ("IPTC", iptc.accept, iptc.decode_iptc),
    ("MCIDAS", mcidas.accept, mcidas.decode_mcidas),
    ("MPEG", _mpeg_size, _mpeg),
    ("TIFF", lambda d: d.startswith(tiff.MAGICS + tiff.BIGTIFF),
     tiff.decode_tiff),
    ("MSP", msp.accept, msp.decode_msp),
    ("PCD", pcd.accept, pcd.decode_pcd),
    ("PIXAR", pixar.accept, pixar.decode_pixar),
    ("PSD", lambda d: d.startswith(psd.MAGIC), psd.decode_psd),
    ("QOI", lambda d: d.startswith(qoi.MAGIC), qoi.decode_qoi),
    ("SGI", sgi.accept, sgi.decode_sgi),
    ("SPIDER", spider.accept, spider.decode_spider),
    ("SUN", sun.accept, sun.decode_sun),
    ("TGA", tga.header_ok, tga.decode_tga),
    ("WEBP", webp.accept, webp.decode_webp),
    ("WMF/EMF", lambda d: d.startswith(b"\xd7\xcd\xc6\x9a\x00\x00") or (
        d.startswith(b"\x01\x00\x00\x00") and d[40:44] == b" EMF"), None),
    ("XBM", xbm.accept, xbm.decode_xbm),
    ("XPM", xpm.accept, xpm.decode_xpm),
    ("XVThumb", xvthumb.accept, xvthumb.decode_xvthumb),
    ("OpenEXR (which PIL does not open either)",
     lambda d: d.startswith(b"\x76\x2f\x31\x01"), None),
    ("PAM (which PIL does not open either)",
     lambda d: d.startswith(b"P7") and d[2:3] in b"\n\r\t \x0b\x0c", None),
)
# what the port decodes, named in its messages (the MPEG row only raises
# ValueError: PIL opens the stream and cannot load it)
DECODED = ", ".join(name for name, _, dec in _FORMATS
                    if dec not in (None, _mpeg))


def _format(data: bytes):
    return next(((name, dec) for name, test, dec in _FORMATS if test(data)),
                ("an unknown format", None))


def image_format(data: bytes) -> str:
    """The name of the format of an image file's bytes, as PIL's `open`
    picks it: PIL's own name (its `format`) for a format the port decodes,
    a descriptive name for another of PIL's, or "an unknown format"."""
    return _format(data)[0]


def decode_image(data: bytes, name: str = "image") -> np.ndarray:
    """(H, W, 3) uint8 of an image file's bytes, PIL's `convert("RGB")` of
    them, for every format the port decodes (`DECODED`: BMP, DIB, GIF,
    JPEG, PNM and PFM, PNG, AVIF, BLP, CUR, PCX, DCX, DDS, FITS, FLI,
    FTEX, GBR, JPEG2000, ICNS, ICO, IM, IMT, IPTC, MCIDAS, TIFF, MSP, PCD,
    PIXAR, PSD, QOI, SGI, SPIDER, SUN, TGA, WEBP, XBM, XPM and XVThumb);
    damaged JPEG data as libjpeg-turbo decodes it; any other format
    raises NotImplementedError (naming it and `name`), as does a feature
    of a decoded format that is still left (a JPEG 2000 code-block style,
    CCITT RLEW TIFF, planar LAB TIFF); an image past PIL's
    decompression-bomb limit, MPEG (which PIL cannot load) and malformed
    data raise ValueError."""
    fmt, decode = _format(data)
    if decode is None:
        raise NotImplementedError(
            f"{name}: {fmt} images are not decoded by the port ({DECODED} "
            f"only)")
    return decode(data)


def load_image(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) float32 in storage space: the
    8-bit values over 255 (texture_gamma is applied after filtering)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, path).astype(np.float32) / 255.0


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
