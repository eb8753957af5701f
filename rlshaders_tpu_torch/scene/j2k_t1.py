"""JPEG 2000 tier-1 (EBCOT) decoding of code-blocks, as OpenJPEG 2.5 does.

A code-block's bytes are one MQ-coded segment (code-block style 0: no
bypass, no termination on each pass, no reset, no vertical causality, no
segmentation symbols). Its passes run from its most significant bit-plane
down: a cleanup pass, then a significance propagation, a magnitude
refinement and a cleanup pass for each lower plane, over stripes of four
rows, column by column. A coefficient is held as OpenJPEG holds it, one
bit finer than its magnitude: significance at plane p (counted from 1)
sets 3 << (p - 1) (the plane's bit and the half below it), a refinement
moves it by half a plane up or down, so a coefficient decoded down to the
last plane is 2 * magnitude + 1, with its sign. `j2k.py` dequantizes it.

`decode_blocks` decodes every code-block of a codestream in one call of
the native decoder, `csrc/j2k_t1.cpp`, compiled by g++ at first use into
`rlshaders_tpu_torch/build/` and bound with ctypes as `accel/native.py`
binds the BVH builder; a missing compiler or a failed compile raises.
`decode_block` is its plain version, which the tests hold it to.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..accel import native

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "j2k_t1.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
# fields of a row of `decode_blocks`' table
FIELDS = ("data_at", "data_len", "w", "h", "orient", "numbps", "passes",
          "out_at")

# the MQ coder's states (ITU-T T.800 Table C.2): probability, next state
# after a more and a less probable symbol, and whether the latter swaps
# the more probable symbol
QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
      0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
      0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
      0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
      0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
      0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
        20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
        37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
        17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
        33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
SWITCH = (1, 0, 0, 0, 0, 0, 1) + (0,) * 7 + (1,) + (0,) * 32
# contexts: zero coding 0-8, sign coding 9-13, refinement 14-16, run 17,
# uniform 18
MAG, RUN, UNI = 14, 17, 18


class _MQ:
    """The MQ decoder over a segment, as OpenJPEG's opj_mqc_* runs it: the
    bytes end in an artificial 0xFF 0xFF, so past the data it reads 1s."""

    def __init__(self, data: bytes):
        self.buf = bytes(data) + b"\xff\xff"
        self.bp = 0
        self.c = self.buf[0] << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000
        self.st = [0] * 19
        self.mps = [0] * 19
        self.st[UNI], self.st[RUN], self.st[0] = 46, 3, 4

    def _bytein(self) -> None:
        nxt = self.buf[self.bp + 1]
        if self.buf[self.bp] == 0xFF:
            if nxt > 0x8F:
                self.c = (self.c + 0xFF00) & 0xFFFFFFFF
                self.ct = 8
            else:
                self.bp += 1
                self.c = (self.c + (nxt << 9)) & 0xFFFFFFFF
                self.ct = 7
        else:
            self.bp += 1
            self.c = (self.c + (nxt << 8)) & 0xFFFFFFFF
            self.ct = 8

    def _renorm(self) -> None:
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a >= 0x8000:
                return

    def decode(self, cx: int) -> int:
        s = self.st[cx]
        qe = QE[s]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d = self.mps[cx]
                self.st[cx] = NMPS[s]
            else:
                d = 1 - self.mps[cx]
                self.mps[cx] ^= SWITCH[s]
                self.st[cx] = NLPS[s]
            self.a = qe
            self._renorm()
            return d
        self.c -= qe << 16
        if self.a & 0x8000:
            return self.mps[cx]
        if self.a < qe:
            d = 1 - self.mps[cx]
            self.mps[cx] ^= SWITCH[s]
            self.st[cx] = NLPS[s]
        else:
            d = self.mps[cx]
            self.st[cx] = NMPS[s]
        self._renorm()
        return d


def zc_context(h: int, v: int, d: int, orient: int) -> int:
    """The zero-coding context (T.800 Table D.1) of a coefficient with h
    horizontal, v vertical and d diagonal significant neighbours, in a
    band of OpenJPEG's orientation (0 LL, 1 HL, 2 LH, 3 HH)."""
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv else 6
        if d == 1:
            return 5 if hv >= 2 else 3 + hv
        return min(hv, 2)
    if orient == 1:
        h, v = v, h
    if h == 2:
        return 8
    if h == 1:
        return 7 if v else (6 if d else 5)
    if v:
        return 2 + v
    return min(d, 2)


# (horizontal, vertical) sign contributions -> (context, xor bit)
_SC_TABLE = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
             (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
             (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}


def decode_block(data: bytes, w: int, h: int, orient: int, numbps: int,
                 passes: int) -> np.ndarray:
    """(h, w) int32: one code-block's coefficients after `passes` coding
    passes from bit-plane `numbps` (counted from 1) down. The plain
    version of `decode_blocks`."""
    out = np.zeros((h, w), np.int32)
    if numbps < 1 or passes < 1 or not w or not h:
        return out
    # padded by one on each side: significance, sign (1 negative),
    # visited in this plane's significance pass, refined before
    sig = [[0] * (w + 2) for _ in range(h + 2)]
    neg = [[0] * (w + 2) for _ in range(h + 2)]
    vis = [[0] * (w + 2) for _ in range(h + 2)]
    ref = [[0] * (w + 2) for _ in range(h + 2)]
    val = [[0] * w for _ in range(h)]
    mq = _MQ(data)

    def context(y, x):
        s0, s1, s2 = sig[y - 1], sig[y], sig[y + 1]
        hh = s1[x - 1] + s1[x + 1]
        vv = s0[x] + s2[x]
        dd = s0[x - 1] + s0[x + 1] + s2[x - 1] + s2[x + 1]
        return zc_context(hh, vv, dd, orient)

    def contribution(y, x):
        return 0 if not sig[y][x] else (-1 if neg[y][x] else 1)

    def significant(y, x, one):
        hc = max(-1, min(1, contribution(y, x - 1) + contribution(y, x + 1)))
        vc = max(-1, min(1, contribution(y - 1, x) + contribution(y + 1, x)))
        cx, flip = _SC_TABLE[(hc, vc)]
        s = mq.decode(cx) ^ flip
        val[y - 1][x - 1] = -one if s else one
        sig[y][x], neg[y][x] = 1, s

    def stripes():
        for y0 in range(1, h + 1, 4):
            for x in range(1, w + 1):
                yield y0, x

    kind, plane = 2, numbps
    for _ in range(passes):
        if plane < 1:
            break
        one = (1 << plane) | (1 << plane >> 1)
        if kind == 0:                              # significance
            for y0, x in stripes():
                for y in range(y0, min(y0 + 4, h + 1)):
                    if sig[y][x]:
                        continue
                    cx = context(y, x)
                    if cx:
                        if mq.decode(cx):
                            significant(y, x, one)
                        vis[y][x] = 1
        elif kind == 1:                            # refinement
            half = 1 << plane >> 1
            for y0, x in stripes():
                for y in range(y0, min(y0 + 4, h + 1)):
                    if not sig[y][x] or vis[y][x]:
                        continue
                    # a first refinement by whether a neighbour is
                    # significant (its zero-coding context is not 0)
                    cx = MAG + (2 if ref[y][x] else int(context(y, x) > 0))
                    v = mq.decode(cx)
                    cur = val[y - 1][x - 1]
                    val[y - 1][x - 1] = cur + (half if v ^ (cur < 0)
                                               else -half)
                    ref[y][x] = 1
        else:                                      # cleanup
            for y0, x in stripes():
                y = y0
                if y0 + 3 <= h and not any(
                        sig[yy][x] or vis[yy][x] or context(yy, x)
                        for yy in range(y0, y0 + 4)):
                    if not mq.decode(RUN):
                        continue
                    r = mq.decode(UNI) << 1
                    r |= mq.decode(UNI)
                    y = y0 + r
                    significant(y, x, one)
                    y += 1
                for yy in range(y, min(y0 + 4, h + 1)):
                    if sig[yy][x] or vis[yy][x]:
                        continue
                    if mq.decode(context(yy, x)):
                        significant(yy, x, one)
            for row in vis:
                row[:] = [0] * (w + 2)
        kind += 1
        if kind == 3:
            kind, plane = 0, plane - 1
    out[:] = val
    return out


_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native.build(CXX_FLAGS, SOURCE, "librls_j2k"))
            lib.rls_j2k_t1.restype = ctypes.c_int
            lib.rls_j2k_t1.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p]
            _lib = lib
    return _lib


def decode_blocks(data: bytes, table: np.ndarray, size: int) -> np.ndarray:
    """Every code-block of `table` ((n, 8) int64 rows of FIELDS: where its
    bytes sit in `data`, their length, its width, height, orientation,
    top bit-plane and pass count, and where its coefficients go) decoded
    by the native tier-1 into one int32 array of `size` values."""
    table = np.ascontiguousarray(table, np.int32).reshape(-1, len(FIELDS))
    at, n, w, h, _, _, _, dst = table.T.astype(np.int64)
    if len(table) and ((at < 0) | (n < 0) | (at + n > len(data)) | (w < 0)
                       | (h < 0) | (dst < 0) | (dst + w * h > size)).any():
        raise ValueError("JPEG 2000 tier-1 table outside its buffers")
    out = np.zeros(size, np.int32)
    lib = _lib or _load()
    lib.rls_j2k_t1(bytes(data), table.ctypes.data, len(table),
                   out.ctypes.data)
    return out
