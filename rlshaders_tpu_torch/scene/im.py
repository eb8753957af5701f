"""IM (IFUNC Image Memory) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_im` returns those bytes for the first frame of every IM file of
an image type PIL's IM writer writes. The text header is read as
ImImagePlugin reads it (lines of "key: value", at most 100 bytes each, a
known key at least once, up to the first 0x1A; the size defaults to
512x512 and the type to greyscale), then the 768-byte "Lut" palette
where the header names one, then the rows, bottom row first:

* "0 1" (1 bit, white where set), "Greyscale" (8-bit grey, or palette
  indices through a Lut that is not a grey ramp), "LA" (grey or, with a
  colour Lut, palette indices, each row followed by its alpha row);
* "L 32S" (32-bit signed), "L 16", "L 16L" and "L 16B" (16-bit), each
  clamped to [0, 255] by the RGB conversion, and "L 32F" (32-bit float,
  truncated toward 0 and clamped; NaN is 0);
* "RGB", "RGBA", "RGBX", "CMYK" and "YCC", each row its channels' rows
  one after another; CMYK converts as (255 - C)(255 - K) / 255 rounded
  as PIL's MULDIV255, YCbCr through PIL's own fixed-point tables (not
  libjpeg's).

Other image types PIL reads but does not write raise NotImplementedError
naming them, as does a type PIL does not know; malformed data raises
ValueError.
"""
from __future__ import annotations

import re

import numpy as np

from . import bomb
from .jpeg import muldiv255
from .pnm import float_to_rgb

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_TAGS = ("Comment", "Date", "Digitalization equipment",
         "File size (no of images)", "Lut", "Name", "Scale (x,y)",
         "Image size (x*y)", "Image type")
_NUMBERS = ("File size (no of images)", "Scale (x,y)", "Image size (x*y)")
# the image types PIL's writer writes: (PIL's mode, sample layout)
_TYPES = {
    "0 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "LA image": ("LA", "LA;L"), "L 32S image": ("I", "<i4"),
    "L 16 image": ("I;16", "<u2"), "L 16L image": ("I;16", "<u2"),
    "L 16B image": ("I;16", ">u2"), "L 32F image": ("F", "<f4"),
    "RGB image": ("RGB", 3), "RGBA image": ("RGBA", 4),
    "RGBX image": ("RGB", 4), "CMYK image": ("CMYK", 4),
    "YCC image": ("YCbCr", 3),
    "L": ("L", "L"),                # PIL's default where no type is named
}


class NotIm(Exception):
    """What makes PIL's IM plugin pass a file on to the next plugin."""


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _header(data: bytes) -> tuple:
    """(header values, where the data after the 0x1A starts), as
    ImImagePlugin._open reads them; NotIm where PIL tries the next
    plugin."""
    if b"\n" not in data[:100]:
        raise NotIm
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    pos, n, last = 0, 0, b""
    while True:
        last = data[pos:pos + 1]
        pos += 1
        if last == b"\r":
            continue
        if not last or last in (b"\0", b"\x1a"):
            break
        nl = data.find(b"\n", pos)
        end = len(data) if nl < 0 else nl + 1
        line = last + data[pos:end]
        pos = end
        if len(line) > 100:
            raise NotIm
        if line.endswith(b"\r\n"):
            line = line[:-2]
        elif line.endswith(b"\n"):
            line = line[:-1]
        m = _SPLIT.match(line)
        if not m:
            raise NotIm
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in _NUMBERS:
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        info[k] = v
        n += k in _TAGS
    if not n:
        raise NotIm
    while last and not last.startswith(b"\x1a"):
        last = data[pos:pos + 1]
        pos += 1
    if not last:
        raise NotIm
    if "Lut" in info and len(data) - pos < 768:
        raise NotIm
    return info, pos


def accept(data: bytes) -> bool:
    """Whether PIL's IM plugin takes the file (it has no prefix test: its
    header reader decides; a header value it cannot read is an error of
    an IM file)."""
    try:
        _header(data)
    except NotIm:
        return False
    except ValueError:
        pass
    return True


# PIL's YCbCr to RGB tables (ConvertYCbCr.c, 6 fractional bits)
_I = np.arange(256) - 128
_R_CR = np.trunc(1.402 * 64 * _I + 0.5).astype(np.int64)
_G_CB = np.trunc(-0.34414 * 64 * _I + 0.5).astype(np.int64)
_G_CR = np.trunc(-0.71414 * 64 * _I + 0.5).astype(np.int64)
_B_CB = np.trunc(1.772 * 64 * _I + 0.5).astype(np.int64)


def ycbcr_to_rgb(px: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB of (..., 3) YCbCr samples, as PIL's
    ImagingConvertYCbCr2RGB converts them."""
    y, cb, cr = (px[..., i].astype(np.int64) for i in range(3))
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_im(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an IM file's first frame, PIL's `convert("RGB")`
    of it byte for byte."""
    try:
        info, pos = _header(data)
    except NotIm:
        raise ValueError("not an IM file") from None
    kind = info["Image type"]
    size = info["Image size (x*y)"]
    if not (isinstance(size, tuple) and len(size) == 2
            and all(isinstance(v, int) and v > 0 for v in size)):
        raise ValueError(f"IM image size {size!r}")
    w, h = size
    bomb.check("IM", w, h)
    if kind not in _TYPES:
        raise NotImplementedError(
            f"IM {kind!r} (not a type PIL writes) is not decoded by the port")
    mode, layout = _TYPES[kind]
    pal = None
    if "Lut" in info:
        lut = np.frombuffer(data[pos:pos + 768], np.uint8).reshape(3, 256)
        pos += 768
        grey = (lut[0] == lut[1]).all() and (lut[1] == lut[2]).all()
        if mode in ("L", "LA") and not grey:
            pal = lut.T                          # a palette image
    if isinstance(layout, int):
        stride = w * layout
    elif layout[0] in "<>":
        stride = w * int(layout[2])
    else:
        stride = {"1": (w + 7) // 8, "L": w, "LA;L": 2 * w}[layout]
    raw = data[pos:pos + h * stride]
    if len(raw) < h * stride:
        raise ValueError("IM pixel data ends early")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)[::-1]
    if layout == "1":
        g = np.unpackbits(rows, axis=1)[:, :w].astype(np.int64) * 255
    elif layout in ("L", "LA;L"):
        g = rows[:, :w].astype(np.int64)
        if pal is not None:
            return pal[g]
    elif isinstance(layout, str):                # one wide sample a pixel
        v = rows.copy().view(layout)
        if mode == "F":
            return float_to_rgb(v)
        g = np.clip(v.astype(np.int64), 0, 255)
    else:                                        # a row of each channel
        planes = rows.reshape(h, layout, w).transpose(0, 2, 1)
        if mode == "CMYK":
            k = 255 - planes[..., 3:4].astype(np.int32)
            return muldiv255(255 - planes[..., :3].astype(np.int32),
                             k).astype(np.uint8)
        if mode == "YCbCr":
            return ycbcr_to_rgb(planes)
        return np.ascontiguousarray(planes[..., :3])
    return np.repeat(g[..., None], 3, axis=2).astype(np.uint8)
