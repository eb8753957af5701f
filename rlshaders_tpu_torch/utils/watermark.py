"""Arnold license-watermark mask, derived from the goldens themselves.

Every reference golden was rendered in watermarked mode (`skip_license_check
on` renders without a license, which stamps the "arnold" banner across rows
~28-108; visible as grey letters on the black backgrounds of cases 0003 and
0009). The overlay is unmatchable content for any re-implementation, so the
harness reports BOTH the full-frame RMSE and the RMSE with the letter pixels
masked, gating on the latter.

The mask is extracted at runtime from the goldens, not hand-drawn. The
watermark GRAIN is stochastic per render (measured: one golden's letter
pixels don't cover another's), so the mask is the solid GLYPH footprint:
union over the four dark-background goldens of in-banner letter pixels
excluding each scene's own content, morphological closing, 1-px fringe
guard. ~17% of the frame (the banner rows are 31%); the harness reports
the full-frame RMSE alongside the masked gate.

Copied verbatim from rlshaders_tpu/utils/watermark.py: importing any
module of rlshaders_tpu imports jax, which the torch port must not need.
"""
from __future__ import annotations

import os

import numpy as np


def _shift(m: np.ndarray, dy: int, dx: int) -> np.ndarray:
    out = np.zeros_like(m)
    h, w = m.shape
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[ys, xs] = m[yd, xd]
    return out


def _dilate(m: np.ndarray, it: int = 1) -> np.ndarray:
    for _ in range(it):
        m = (m | _shift(m, 1, 0) | _shift(m, -1, 0)
             | _shift(m, 0, 1) | _shift(m, 0, -1))
    return m


def _smooth(a: np.ndarray, it: int = 3) -> np.ndarray:
    for _ in range(it):
        a = 0.25 * (_shiftf(a, 1, 0) + _shiftf(a, -1, 0)
                    + _shiftf(a, 0, 1) + _shiftf(a, 0, -1))
    return a


def _shiftf(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
    return np.roll(np.roll(a, dy, axis=0), dx, axis=1)


def _erode(m: np.ndarray, it: int = 1) -> np.ndarray:
    for _ in range(it):
        m = (m & _shift(m, 1, 0) & _shift(m, -1, 0)
             & _shift(m, 0, 1) & _shift(m, 0, -1))
    return m


# The mask is PINNED (VERDICT r3 weak#5): the gate is measured on
# watermark-masked pixels, so any silent mask growth would inflate pass
# claims. wm_mask_256.bits is the packbits of the (256, 256) derived mask,
# committed once; pinned_mask() is what the harness gates on, and a test
# asserts watermark_mask() still reproduces it bit-for-bit.
PINNED_SHA256 = "a0ef3b7e82eee465ab72f42391c47022f2e233249c04dad1797b1784fea3a3e1"
PINNED_COVERAGE = 0.1733856201171875


def pinned_mask() -> np.ndarray:
    """The checked-in (256, 256) bool watermark mask (glyph footprint)."""
    path = os.path.join(os.path.dirname(__file__), "wm_mask_256.bits")
    bits = np.fromfile(path, dtype=np.uint8)
    return np.unpackbits(bits).astype(bool).reshape(256, 256)


def watermark_mask(suite: str) -> np.ndarray | None:
    """(256, 256) bool mask of the watermark GLYPH footprint, or None if
    the donor goldens are unavailable.

    The watermark is stochastic grain stamped into the fixed 'arnold'
    glyphs (each golden carries a DIFFERENT grain realization — measured:
    a pixel-exact mask from one render cannot cover another's letters), so
    the mask must be the union of the glyph footprints. Derived from all
    four dark-background goldens (0003/0008/0009/0010), each excluding its
    own scene content, then a morphological closing to solidify glyph
    interiors and a 1-px guard dilation for the antialiased fringe."""
    from ..io import exr

    donors = []
    for case, content_th in (("0003", 0.02), ("0008", 0.02),
                             ("0009", 0.06), ("0010", 0.06)):
        p = os.path.join(suite, "mtoa", case, "ref", "ref.exr")
        if not os.path.exists(p):
            continue
        lum = exr.read_rgb(p).mean(-1)
        if lum.shape != (256, 256):
            continue
        donors.append((lum, content_th))
    if not donors:
        return None
    band = np.zeros((256, 256), bool)
    band[28:108] = True
    wm = np.zeros((256, 256), bool)
    for lum, content_th in donors:
        content = _dilate(_smooth(lum) > content_th, 3)
        wm |= band & (lum > 0.004) & ~content
    # closing (solidify glyph interiors) + fringe guard
    wm = _erode(_dilate(wm, 2), 2)
    wm = _dilate(wm, 1) & band
    return wm
