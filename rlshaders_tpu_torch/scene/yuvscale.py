"""libyuv's ScalePlane with the box filter, in numpy: what libavif does to
an AVIF frame whose AV1 size is not its item's ispe (or track header)
size (`avifImageScale`, each of Y, U, V and alpha on its own).

`scale_plane` follows libyuv's dispatch: the filter is first reduced by
the sizes (box to bilinear where either axis keeps half or more,
bilinear to linear where the height is kept or divided by 3 or the
source is one row, linear to none where the width is kept or divided by
3 or the source is one column), then the first path that applies runs:
a copy; the vertical-only filter; the exact ratios 3/4, 1/2, 3/8 and 1/4
down; the box average; the exact 2x linear and bilinear up-samplers;
bilinear up or down; point sampling. Positions are 16.16 fixed point as
libyuv steps them, and each path rounds as the row functions that this
x86 build of libyuv runs (SSSE3 and AVX2) round: the column filter
blends with 7-bit fractions, the row blend with 8-bit ones.
"""
from __future__ import annotations

import numpy as np

NONE, LINEAR, BILINEAR, BOX = 0, 1, 2, 3
MAX_SOURCE = 16384      # libavif refuses wider or taller sources


def _fixed_div(num: int, div: int) -> int:
    return (num << 16) // div


def _fixed_div1(num: int, div: int) -> int:
    return ((num << 16) - 0x00010001) // (div - 1)


def _center(d: int, s: int) -> int:
    return (d >> 1) + s


def _reduce_filter(sw: int, sh: int, dw: int, dh: int, f: int) -> int:
    """libyuv's ScaleFilterReduce."""
    if f == BOX and (dw * 2 >= sw or dh * 2 >= sh):
        f = BILINEAR
    if f == BILINEAR:
        if sh == 1 or dh == sh or dh * 3 == sh:
            f = LINEAR
        if sw == 1:
            f = NONE
    if f == LINEAR and (sw == 1 or dw == sw or dw * 3 == sw):
        f = NONE
    return f


def _slope(sw: int, sh: int, dw: int, dh: int, f: int) -> tuple:
    """libyuv's ScaleSlope: (x, y, dx, dy) in 16.16."""
    x = y = dx = dy = 0
    if f == BOX:
        return 0, 0, _fixed_div(sw, dw), _fixed_div(sh, dh)
    if f in (BILINEAR, LINEAR):
        if dw <= sw:
            dx = _fixed_div(sw, dw)
            x = _center(dx, -32768)
        elif sw > 1 and dw > 1:
            dx = _fixed_div1(sw, dw)
        if f == LINEAR:
            dy = _fixed_div(sh, dh)
            y = dy >> 1
        elif dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _center(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
        return x, y, dx, dy
    dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
    return _center(dx, 0), _center(dy, 0), dx, dy


def _steps(start: int, step: int, n: int, top: int | None = None):
    v = start + step * np.arange(n, dtype=np.int64)
    return v if top is None else np.minimum(v, top)


def _blend_rows(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> np.ndarray:
    """InterpolateRow: (a (256 - f) + b f + 128) >> 8, f per row."""
    f = f[:, None]
    return (a * (256 - f) + b * f + 128) >> 8


def _filter_cols(rows: np.ndarray, x: int, dx: int, dw: int) -> np.ndarray:
    """ScaleFilterCols (x86: a 7-bit fraction of x's 16 bits)."""
    xs = _steps(x, dx, dw)
    xi = xs >> 16
    f = (xs & 0xFFFF) >> 9
    last = rows.shape[1] - 1
    a = rows[:, np.minimum(xi, last)]
    b = rows[:, np.minimum(xi + 1, last)]
    return a + ((f * (b - a) + 0x40) >> 7)


def _vertical(p, dw, dh, f):
    sh = p.shape[0]
    y = dy = 0
    if dh <= sh:
        dy = _fixed_div(sh, dh)
        y = _center(dy, -32768)
    elif sh > 1 and dh > 1:
        dy = _fixed_div1(sh, dh)
    top = ((sh - 1) << 16) - 1 if sh > 1 else 0
    ys = _steps(y, dy, dh, top)
    yi = ys >> 16
    yf = (ys >> 8) & 255 if f else np.zeros_like(ys)
    return _blend_rows(p[yi], p[np.minimum(yi + 1, sh - 1)], yf)


def _down2(p, dw, dh):
    q = p[:2 * dh, :2 * dw]
    return (q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
            + 2) >> 2


def _down4(p, dw, dh):
    q = p[:4 * dh, :4 * dw].reshape(dh, 4, dw, 4)
    return (q.sum(axis=(1, 3)) + 8) >> 4


def _avg(a, b):
    return (a + b + 1) >> 1


def _h34(r):
    """The horizontal part of ScaleRowDown34_*_Box: each 4 samples to 3,
    weighted (3 1), (2 2), (1 3), over 4, rounded."""
    g = r.reshape(r.shape[0], -1, 4)
    return np.stack([(g[..., 0] * 3 + g[..., 1] + 2) >> 2,
                     (g[..., 1] + g[..., 2] + 1) >> 1,
                     (g[..., 2] + g[..., 3] * 3 + 2) >> 2],
                    -1).reshape(r.shape[0], -1)


def _down34(p, dw, dh):
    """ScalePlaneDown34: each 4 source rows to 3, mixed 3:1, 1:1 and 1:3.
    The SSSE3 rows (24 samples at a time) mix the rows first with pavgb
    (3:1 as avg(s, avg(s, t))), then the columns; the C rows that finish
    a width not a multiple of 24 mix the columns first."""
    r = [p[k:4 * dh // 3:4, :dw // 3 * 4] for k in range(4)]
    n = dw - dw % 24
    out = np.empty((dh, dw), np.int64)
    out[0::3, :n] = _h34(_avg(r[0], _avg(r[0], r[1]))[:, :n // 3 * 4])
    out[1::3, :n] = _h34(_avg(r[1], r[2])[:, :n // 3 * 4])
    out[2::3, :n] = _h34(_avg(r[3], _avg(r[3], r[2]))[:, :n // 3 * 4])
    g = [_h34(q[:, n // 3 * 4:]) for q in r]
    out[0::3, n:] = (g[0] * 3 + g[1] + 2) >> 2
    out[1::3, n:] = (g[1] + g[2] + 1) >> 1
    out[2::3, n:] = (g[3] * 3 + g[2] + 2) >> 2
    return out


def _h38(rows, n):
    """ScaleRowDown38_{3,2}_Box: 8 samples of n summed rows to 3, each sum
    times 65536 // its count, over 2^16."""
    g = sum(rows).reshape(rows[0].shape[0], -1, 8)
    return np.stack([
        ((g[..., 0] + g[..., 1] + g[..., 2]) * (65536 // (3 * n))) >> 16,
        ((g[..., 3] + g[..., 4] + g[..., 5]) * (65536 // (3 * n))) >> 16,
        ((g[..., 6] + g[..., 7]) * (65536 // (2 * n))) >> 16],
        -1).reshape(rows[0].shape[0], -1)


def _down38(p, dw, dh):
    """ScalePlaneDown38: each 8 source rows to 3 (3, 3 and 2 rows). The
    SSSE3 two-row filter (6 samples at a time) averages its rows with
    pavgb first and divides sums of 3 and 2; the C rows that finish a
    width not a multiple of 6 sum all 6 and 4."""
    q = p[:8 * dh // 3, :dw // 3 * 8]
    n = dw - dw % 6
    out = np.empty((dh, dw), np.int64)
    out[0::3] = _h38([q[0::8], q[1::8], q[2::8]], 3)
    out[1::3] = _h38([q[3::8], q[4::8], q[5::8]], 3)
    out[2::3, :n] = _h38([_avg(q[6::8], q[7::8])[:, :n // 3 * 8]], 1)
    out[2::3, n:] = _h38([q[6::8, n // 3 * 8:], q[7::8, n // 3 * 8:]], 2)
    return out


def _box(p, dw, dh):
    sh, sw = p.shape
    _, _, dx, dy = _slope(sw, sh, dw, dh, BOX)
    ys = np.minimum(dy * np.arange(dh + 1, dtype=np.int64), sh << 16)
    iy = ys[:-1] >> 16
    bh = np.maximum((ys[1:] >> 16) - iy, 1)
    cum = np.concatenate([np.zeros((1, sw), np.int64), np.cumsum(p, 0)])
    sums = (cum[np.minimum(iy + bh, sh)] - cum[iy]) & 0xFFFF
    ccum = np.concatenate([np.zeros((dh, 1), np.int64),
                           np.cumsum(sums, 1)], 1)
    xs = dx * np.arange(dw + 1, dtype=np.int64)
    if dx & 0xFFFF:
        ix = xs[:-1] >> 16
        bw = np.maximum((xs[1:] >> 16) - ix, 1)
        minbw = dx >> 16
        tbl = np.stack([65536 // (max(minbw, 1) * bh),
                        65536 // (max(minbw + 1, 1) * bh)], -1)
        scale = tbl[:, np.clip(bw - minbw, 0, 1)]
    else:
        bw0 = max(dx >> 16, 1)
        ix = bw0 * np.arange(dw, dtype=np.int64)
        bw = np.full(dw, bw0, np.int64)
        scale = (65536 // (bw0 * bh))[:, None]
    tot = ccum[:, np.minimum(ix + bw, sw)] - ccum[:, ix]
    return (((tot * scale) & 0xFFFFFFFF) >> 16) & 0xFF


def _up2_linear(p, dw, dh):
    sh, sw = p.shape
    if dh == 1:
        rows = p[[(sh - 1) // 2]]
    else:
        dy = _fixed_div(sh - 1, dh - 1)
        rows = p[_steps((1 << 15) - 1, dy, dh) >> 16]
    out = np.empty((dh, dw), np.int64)
    out[:, 0] = rows[:, 0]
    n = (dw - 1) // 2
    s0, s1 = rows[:, :n], rows[:, 1:n + 1]
    out[:, 1:2 * n + 1:2] = (s0 * 3 + s1 + 2) >> 2
    out[:, 2:2 * n + 1:2] = (s0 + s1 * 3 + 2) >> 2
    out[:, dw - 1] = rows[:, (dw - 1) // 2]
    return out


def _up2_bilinear_rows(s, t, dw):
    """ScaleRowUp2_Bilinear_Any of row pairs: (d, e)."""
    d = np.empty((s.shape[0], dw), np.int64)
    e = np.empty_like(d)
    d[:, 0] = (3 * s[:, 0] + t[:, 0] + 2) >> 2
    e[:, 0] = (s[:, 0] + 3 * t[:, 0] + 2) >> 2
    n = (dw - 1) // 2
    a, b, c, g = s[:, :n], s[:, 1:n + 1], t[:, :n], t[:, 1:n + 1]
    d[:, 1:2 * n + 1:2] = (a * 9 + b * 3 + c * 3 + g + 8) >> 4
    d[:, 2:2 * n + 1:2] = (a * 3 + b * 9 + c + g * 3 + 8) >> 4
    e[:, 1:2 * n + 1:2] = (a * 3 + b + c * 9 + g * 3 + 8) >> 4
    e[:, 2:2 * n + 1:2] = (a + b * 3 + c * 3 + g * 9 + 8) >> 4
    ls = (dw - 1) // 2              # the last column, whatever the parity
    d[:, dw - 1] = (3 * s[:, ls] + t[:, ls] + 2) >> 2
    e[:, dw - 1] = (s[:, ls] + 3 * t[:, ls] + 2) >> 2
    return d, e


def _up2_bilinear(p, dw, dh):
    sh = p.shape[0]
    out = np.empty((dh, dw), np.int64)
    out[0] = _up2_bilinear_rows(p[:1], p[:1], dw)[0][0]
    if sh > 1:
        d, e = _up2_bilinear_rows(p[:-1], p[1:], dw)
        out[1:2 * sh - 1:2] = d
        out[2:2 * sh - 1:2] = e
    if dh % 2 == 0:
        out[dh - 1] = _up2_bilinear_rows(p[-1:], p[-1:], dw)[0][0]
    return out


def _bilinear_up(p, dw, dh, f):
    sh, sw = p.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    ys = _steps(min(y, (sh - 1) << 16), dy, dh)
    yi = np.minimum(ys >> 16, sh - 1)
    cols = _filter_cols(p, x, dx, dw)
    if f == LINEAR:
        return cols[yi]
    return _blend_rows(cols[yi], cols[np.minimum(yi + 1, sh - 1)],
                       (ys >> 8) & 255)


def _bilinear_down(p, dw, dh, f):
    sh, sw = p.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    ys = _steps(y, dy, dh, (sh - 1) << 16)
    yi = ys >> 16
    if f == LINEAR:
        rows = p[yi]
    else:
        rows = _blend_rows(p[yi], p[np.minimum(yi + 1, sh - 1)],
                           (ys >> 8) & 255)
    return _filter_cols(rows, x, dx, dw)


def _simple(p, dw, dh):
    sh, sw = p.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, NONE)
    rows = p[_steps(y, dy, dh) >> 16]
    if sw * 2 == dw and x < 0x8000:
        return rows[:, np.arange(dw) >> 1]
    return rows[:, _steps(x, dx, dw) >> 16]


def scale_plane(plane: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """(dh, dw) uint8: libyuv's ScalePlane(kFilterBox) of an 8-bit
    plane, as libavif calls it."""
    sh, sw = plane.shape
    if dw <= 0 or dh <= 0:
        raise ValueError("AVIF frame scaled to an empty size")
    if sw > MAX_SOURCE or sh > MAX_SOURCE:
        raise ValueError("AVIF frame too large for libyuv's scaler")
    p = plane.astype(np.int64)
    if (dw, dh) == (sw, sh):
        return plane.copy()
    f = _reduce_filter(sw, sh, dw, dh, BOX)
    if dw == sw and f != BOX:
        out = _vertical(p, dw, dh, f)
    elif dw <= sw and dh <= sh and 4 * dw == 3 * sw and 4 * dh == 3 * sh:
        out = _down34(p, dw, dh)
    elif dw <= sw and dh <= sh and 2 * dw == sw and 2 * dh == sh:
        out = _down2(p, dw, dh)
    elif dw <= sw and dh <= sh and 8 * dw == 3 * sw and 8 * dh == 3 * sh:
        out = _down38(p, dw, dh)
    elif (dw <= sw and dh <= sh and 4 * dw == sw and 4 * dh == sh
          and f in (BOX, NONE)):
        out = _down4(p, dw, dh)
    elif f == BOX and dh * 2 < sh:
        out = _box(p, dw, dh)
    elif (dw + 1) // 2 == sw and f == LINEAR:
        out = _up2_linear(p, dw, dh)
    elif (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and f in (BILINEAR,
                                                              BOX):
        out = _up2_bilinear(p, dw, dh)
    elif f and dh > sh:
        out = _bilinear_up(p, dw, dh, f)
    elif f:
        out = _bilinear_down(p, dw, dh, f)
    else:
        out = _simple(p, dw, dh)
    return out.astype(np.uint8)
