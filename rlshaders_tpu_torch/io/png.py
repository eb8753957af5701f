"""PNG writing and image resampling in numpy, in place of PIL.

The JAX package's `cli display` writes its sheets through PIL and `cli
test` resizes a render through PIL when its shape differs from its
golden's. The machine the port runs on has no PIL, so the port does both
here:

* `write_png`: 8-bit RGB, every row with filter type 0, one zlib stream;
* `resize`: Pillow's default `Image.resize` of an 8-bit RGB image (bicubic,
  a = -0.5), reproduced as Pillow's libImaging/Resample.c computes it: per
  axis, the filter's support widened by the scale when downscaling,
  coefficients in double precision normalised to sum to 1, then turned
  into integers of 22 fraction bits; a horizontal pass and a vertical pass,
  each rounding and clamping to 8 bits.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_SUPPORT = 2.0


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64 coefficients of one axis, as Pillow's
    precompute_coeffs and normalize_coeffs_8bpc make them."""
    scale = filterscale = float(in_size) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = _BICUBIC_SUPPORT * filterscale
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            if ww != 0.0:
                w /= ww
            out[xx, xmin + x] = (int(-0.5 + w * (1 << _PRECISION_BITS))
                                 if w < 0 else
                                 int(0.5 + w * (1 << _PRECISION_BITS)))
    return out


def _pass(img: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One axis of the resample over the last-but-one axis of img
    (rows, n, 3) -> (rows, m, 3), rounded and clamped to 8 bits."""
    acc = np.einsum("mn,rnc->rmc", weights, img.astype(np.int64))
    acc += 1 << (_PRECISION_BITS - 1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Pillow's `Image.fromarray(img).resize(size)` of an (H, W, 3) uint8
    image; size is (width, height), as Pillow takes it."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    out_w, out_h = size
    if out_w != w:
        img = _pass(img, _weights(w, out_w))
    if out_h != h:
        img = _pass(img.transpose(1, 0, 2),
                    _weights(h, out_h)).transpose(1, 0, 2)
    return np.ascontiguousarray(img)
