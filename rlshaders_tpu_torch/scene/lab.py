"""CIE L*a*b* to RGB as Pillow converts mode LAB: through LittleCMS 2.17.

Pillow's `convert("RGB")` of a LAB image builds, with lcms2, a transform
from `cmsCreateLab2Profile(NULL)` (D50) to `cmsCreate_sRGBProfile()`,
perceptual intent, no flags, over 8-bit pixels. lcms2 optimises that
pipeline (its Lab profile's stages cancel, leaving Lab to XYZ, the
inverse of sRGB's colorant matrix and sRGB's inverse tone curves) into a
16-bit CLUT of 33 points a side, resampled once, which it then
interpolates tetrahedrally in 16.16 fixed point for every pixel. This
module builds the same table, lazily, in numpy and evaluates it as
lcms2's 8-bit path does:

* an 8-bit sample widens to 16 bits as v * 257, so a* = b* = 0 (128)
  is 0x8080 and falls between nodes (no prelinearisation moves it; the
  white-point fix-up finds no node under it and changes nothing);
* each node is the float pipeline at the node's 16-bit coordinates
  (`_cmsQuantizeVal`): words over 65535 in float32, cmsLab2XYZ in
  float64 over D50, stored in float32 over 1 + 32767/32768, the 3x3
  matrix (float64 products of the float32 inputs, stored in float32),
  sRGB's parametric curve inverted (type -4) in float64, stored in
  float32, and `_cmsQuickSaturateWord` of the value times 65535;
* the colorant matrix is lcms2's own arithmetic: the primaries' and
  D65's xyY to XYZ, Bradford adaptation to D50, and its 3x3 inverse;
* the output word narrows to 8 bits as (v * 65281 + 2^23) >> 24.

Pillow stores a* and b* offset by 128 (its TIFF unpacker flips the sign
bit of TIFF's signed samples; PSD stores them offset already), which is
lcms2's 8-bit Lab encoding. tests/test_torch_image_formats_h.py holds
`to_rgb` to PIL on all 2^24 inputs.
"""
from __future__ import annotations

import math
import threading

import numpy as np

GRID = 33
D50 = (0.9642, 1.0, 0.8249)
# cmsCreate_sRGBProfile: D65 and the Rec. 709 primaries (xy), the
# Bradford cone matrix, and IEC 61966-2.1's curve (type 4 parameters)
D65 = (0.3127, 0.3290)
PRIMARIES = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367),
            (0.0389, -0.0685, 1.0296))
SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
# XYZ as lcms2 encodes it: 1.15 fixed point, so 0xFFFF is this
MAX_XYZ = 1.0 + 32767.0 / 32768.0

_table = None
_lock = threading.Lock()


def _inv3(a):
    """_cmsMAT3inverse, in its own order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return (
        (c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
         (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
        (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
         (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
        (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
         (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _ev(a, v):
    """_cmsMAT3eval."""
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
                 for i in range(3))


def _per(a, b):
    """_cmsMAT3per: a times b."""
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j]
                       + a[i][2] * b[2][j] for j in range(3))
                 for i in range(3))


def _bradford(src, dst):
    """_cmsAdaptationMatrix with the Bradford cone matrix."""
    s, d = _ev(BRADFORD, src), _ev(BRADFORD, dst)
    cone = ((d[0] / s[0], 0.0, 0.0), (0.0, d[1] / s[1], 0.0),
            (0.0, 0.0, d[2] / s[2]))
    return _per(_inv3(BRADFORD), _per(cone, BRADFORD))


def output_matrix() -> np.ndarray:
    """The matrix stage of sRGB's output: the inverse of its colorants
    (RGB to XYZ, adapted to D50) scaled by lcms2's XYZ encoding."""
    xn, yn = D65
    (xr, yr), (xg, yg), (xb, yb) = PRIMARIES
    prim = ((xr, xg, xb), (yr, yg, yb), (1 - xr - yr, 1 - xg - yg,
                                         1 - xb - yb))
    c = _ev(_inv3(prim), (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    rgb2xyz = ((c[0] * xr, c[1] * xg, c[2] * xb),
               (c[0] * yr, c[1] * yg, c[2] * yb),
               (c[0] * (1.0 - xr - yr), c[1] * (1.0 - xg - yg),
                c[2] * (1.0 - xb - yb)))
    white = ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0)
    rgb2xyz = _per(_bradford(white, D50), rgb2xyz)
    return np.array([[v * MAX_XYZ for v in row] for row in _inv3(rgb2xyz)])


def _inverse_srgb(r: float) -> float:
    """sRGB's curve inverted, lcms2's parametric type -4 (libm's pow)."""
    g, a, b, c, d = SRGB_CURVE
    if r >= math.pow(a * d + b, g):
        return (math.pow(r, 1.0 / g) - b) / a
    return r / c


def saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5 clamped to 0..65535 and floored
    the way its magic-number floor does (to the nearest 2^-16 first)."""
    d = np.asarray(d, np.float64) + 0.5
    q = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, q)).astype(
        np.int64)


def pipeline(words: np.ndarray) -> np.ndarray:
    """(n, 3) 16-bit Lab (lcms2's V4 encoding) to (n, 3) 16-bit RGB
    through the float stages, as cmsPipelineEval16 runs them."""
    f = (words.astype(np.float32) / np.float32(65535.0)).astype(np.float64)
    y = (f[:, 0] * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (f[:, 1] * 255.0 - 128.0)
    z = y - 0.005 * (f[:, 2] * 255.0 - 128.0)
    t = np.stack([x, y, z], -1)
    xyz = np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                   t * t * t) * np.array(D50)
    xyz = (xyz / MAX_XYZ).astype(np.float32).astype(np.float64)
    m = output_matrix()
    rgb = np.stack([xyz[:, 0] * m[i, 0] + xyz[:, 1] * m[i, 1]
                    + xyz[:, 2] * m[i, 2] for i in range(3)], -1)
    rgb = rgb.astype(np.float32).astype(np.float64)
    curve = np.frompyfunc(_inverse_srgb, 1, 1)
    out = curve(rgb).astype(np.float64).astype(np.float32)
    return saturate_word(out.astype(np.float64) * 65535.0)


def table() -> np.ndarray:
    """(33, 33, 33, 3) int64: the CLUT lcms2 resamples, L* slowest."""
    global _table
    with _lock:
        if _table is None:
            q = saturate_word(np.arange(GRID) * 65535.0 / (GRID - 1))
            nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1)
            _table = pipeline(nodes.reshape(-1, 3)).reshape(
                GRID, GRID, GRID, 3)
    return _table


def _fixed(v: np.ndarray) -> np.ndarray:
    """_cmsToFixedDomain of v times the grid's domain (32)."""
    a = v * (GRID - 1)
    return a + (a + 0x7FFF) // 0xFFFF


# the order lcms2's Eval3Inputs walks the axes in, by its comparisons
# rx >= ry (8), ry >= rz (4), rz >= rx (2) and rx >= rz (1)
_ORDER = np.zeros((16, 3), np.int64)
for _code in range(16):
    _a, _b, _c, _d = (_code >> 3 & 1, _code >> 2 & 1, _code >> 1 & 1,
                      _code & 1)
    _ORDER[_code] = ((0, 1, 2) if _a and _b else (2, 0, 1) if _a and _c
                     else (0, 2, 1) if _a else (1, 0, 2) if _d
                     else (1, 2, 0) if _b else (2, 1, 0))


def tetrahedral(t: np.ndarray, words: np.ndarray) -> np.ndarray:
    """lcms2's Eval3Inputs: (n, 3) 16-bit inputs to (n, 3) 16-bit
    outputs, 16.16 fixed point, its rounding and its tie order."""
    flat = t.reshape(-1, 3)
    f = _fixed(words)
    rest = f & 0xFFFF
    stride = np.array([GRID * GRID, GRID, 1])
    step = np.where(words == 0xFFFF, 0, stride)
    c0 = ((f >> 16) * stride).sum(1)
    rx, ry, rz = rest.T
    order = _ORDER[(rx >= ry) * 8 + (ry >= rz) * 4 + (rz >= rx) * 2
                   + (rx >= rz)]
    r = np.take_along_axis(rest, order, 1)
    corner = c0[:, None] + np.cumsum(np.take_along_axis(step, order, 1), 1)
    v0 = flat[c0]
    v = flat[corner]                      # (n, 3 corners, 3 channels)
    acc = ((v[:, 0] - v0) * r[:, 0:1] + (v[:, 1] - v[:, 0]) * r[:, 1:2]
           + (v[:, 2] - v[:, 1]) * r[:, 2:3] + 0x8001)
    return (v0 + ((acc + (acc >> 16)) >> 16)) & 0xFFFF


def to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 L*, a* + 128, b* + 128 (Pillow's LAB) to (..., 3)
    uint8 RGB, byte-equal to Pillow's `convert("RGB")`. Each distinct
    colour is converted once."""
    shape = lab.shape
    flat = lab.reshape(-1, 3).astype(np.int64)
    colours, where = np.unique(flat[:, 0] << 16 | flat[:, 1] << 8
                               | flat[:, 2], return_inverse=True)
    words = np.stack([colours >> 16, colours >> 8 & 255, colours & 255],
                     -1) * 257
    t = table()
    out = np.empty((len(words), 3), np.uint8)
    for i in range(0, len(words), 1 << 20):
        w = tetrahedral(t, words[i:i + (1 << 20)])
        out[i:i + len(w)] = (w * 65281 + 8388608) >> 24
    return out[where.reshape(-1)].reshape(shape)
