"""WebP lossy (VP8 key frame) decoding, equal to libwebp's decode.

RFC 6386's key frame as libwebp 1.6 reads it, down to the planes it
hands its output stage:

* the frame tag (a key frame, profile 0-3, shown, the first partition's
  length), the start code 9d 01 2a and the 14-bit width and height (the
  scale bits are ignored);
* the first partition, through the boolean decoder: colour space and
  clamping bits, segmentation (quantizer and filter-strength updates,
  absolute or delta, the segment-map probabilities), the loop filter
  (simple or normal, level, sharpness, reference and mode deltas), 1, 2,
  4 or 8 token partitions, the quantizer indices and deltas, the
  coefficient-probability updates, the skip probability, and each
  macroblock's segment, skip flag and intra modes (16x16 DC, V, H, TM,
  or 16 sub-block modes coded against the modes above and left; the
  chroma mode);
* the tokens of each macroblock row from partition row % count: the
  Y2 block of a 16x16 macroblock, then 16 Y and 8 chroma blocks, each
  coded against the above and left blocks' non-zero flags through the
  band of each position, with no end of block right after a zero and the
  extra bits of categories 3-6; a zero run to position 16 counts as
  non-zero, as in libwebp;
* dequantization (Y2 DC x2, Y2 AC x155/100 at least 8, chroma DC at most
  132, products kept to 16 bits), the inverse WHT and the 4x4 IDCT;
* prediction from the unfiltered neighbours (127 above the frame, 129
  left of it; DC without an edge averages the other; a sub-block right
  of the macroblock takes the row above-right of the macroblock, or its
  own above row's last pixel at the right edge);
* the simple or normal loop filter in macroblock order, its strength
  from the segment, the deltas and the sharpness; inner edges are
  skipped in a macroblock that is not B_PRED and holds no non-zero
  coefficient. libwebp filters only where the frame's level is above 0.

The boolean decoder and the tokens run in a Python loop; the transforms
run over all blocks at once in numpy, and prediction and the filter
over each anti-diagonal of macroblocks (x + 2y constant) at once, which
depend on none of each other. Malformed data raises ValueError.
"""
from __future__ import annotations

import numpy as np

from .vp8_tables import (AC_TABLE, BMODE_PROBS, COEFF_PROBS,
                         COEFF_UPDATE_PROBS, DC_TABLE)

START_CODE = b"\x9d\x01\x2a"
# sub-block modes (libwebp's order); the 16x16 and chroma modes are
# DC, TM, V (= VE) and H (= HE)
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
# the sub-block mode tree: node i reads prob[i]; a leaf is -mode
_BMODE_TREE = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR,
               -B_LD, 7, -B_VL, 8, -B_HD, -B_HU)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
# extra bits of the categories 3-6
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135),
              (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the shift that brings a range of 1..127 back to 128..255
_NORM = [0] + [8 - v.bit_length() for v in range(1, 256)]


class _Bool:
    """The boolean decoder (RFC 6386, section 7) over one partition:
    `val` holds the partition's bits up to byte `pos`, the 8 compared
    with the split above `cnt` more, and takes 6 bytes (48 bits) at a
    time. libwebp fails a partition where a read's 8-bit window starts
    past its end (a read's start: cnt - 8 pos below -8 len(data)); this
    decoder raises there. The token loop (`_tokens`) runs the same
    arithmetic inline on this state."""

    def __init__(self, data: bytes):
        self.buf = bytes(data) + bytes(96)
        self.end = -8 * len(data)
        self.val = int.from_bytes(self.buf[:8], "big")
        self.pos, self.cnt, self.rng = 8, 56, 255

    def bit(self, prob: int) -> int:
        if self.cnt - 8 * self.pos < self.end:
            raise ValueError("VP8 partition ends early")
        sp = 1 + (((self.rng - 1) * prob) >> 8)
        bs = sp << self.cnt
        if self.val >= bs:
            self.rng -= sp
            self.val -= bs
            b = 1
        else:
            self.rng = sp
            b = 0
        if self.rng < 128:
            s = _NORM[self.rng]
            self.rng <<= s
            self.cnt -= s
            if self.cnt < 0:
                self.val = (self.val << 48) | int.from_bytes(
                    self.buf[self.pos:self.pos + 6], "big")
                self.pos += 6
                self.cnt += 48
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def flagged(self, n: int) -> int:
        """A signed n-bit value behind a flag bit, else 0."""
        return self.signed(n) if self.bit(128) else 0


def _wrap16(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.int64) + 32768) & 0xFFFF) - 32768


def _tokens(parts: list, mbs: list, mbw: int, probs: list, dq: list,
            index: list, value: list, nzs: bytearray) -> None:
    """Decode the coefficient tokens of the macroblocks `mbs` ((rank, x,
    is 4x4, segment, skip) in raster order), row y from partition y %
    len(parts), the above blocks' flags carried across partitions: the
    dequantized coefficients go to index/value (the flat position rank *
    400 + block * 16 + raster position; Y2 is block 24), and each block's
    end (the position past its last token, 16 after a run of zeros to
    the end) to nzs[rank * 25 + block]."""
    states = [_Bool(d) for d in parts]
    norm = _NORM
    zz = ZIGZAG
    top = [[0] * 9 for _ in range(mbw)]      # Y cols 0-3, U 4-5, V 6-7, Y2
    left = [0] * 9
    state = None
    st = 0                                   # cnt - 8 pos at a read's start
    row = -1

    for rank, x, is4, seg, skip in mbs:
        if x == 0:
            if state is not None:
                state.val, state.pos, state.cnt, state.rng = val, pos, cnt, rng
            row += 1
            state = states[row % len(states)]
            buf, end = state.buf, state.end
            val, pos, cnt, rng = state.val, state.pos, state.cnt, state.rng
            left = [0] * 9
        t = top[x]
        if skip:
            for k in range(8):
                t[k] = left[k] = 0
            if not is4:
                t[8] = left[8] = 0
            continue
        y1dc, y1ac, y2dc, y2ac, uvdc, uvac = dq[seg]
        base = rank * 400
        if is4:
            plan = [(3, 0, k, y1dc, y1ac) for k in range(16)]
        else:
            plan = [(1, 0, 24, y2dc, y2ac)] + [(0, 1, k, 0, y1ac)
                                               for k in range(16)]
        plan += [(2, 0, 16 + k, uvdc, uvac) for k in range(8)]
        for typ, first, blk, qdc, qac in plan:
            # the context of this block: its above and left flags
            if blk == 24:
                ta, la = 8, 8
            elif blk < 16:
                ta, la = blk & 3, blk >> 2
            elif blk < 20:
                ta, la = 4 + ((blk - 16) & 1), 4 + ((blk - 16) >> 1)
            else:
                ta, la = 6 + ((blk - 20) & 1), 6 + ((blk - 20) >> 1)
            pt = probs[typ]
            n = first
            p = pt[n][t[ta] + left[la]]
            bb = base + blk * 16
            nz = 16
            while n < 16:
                # not the end of block? (p[0]; each read below is _Bool.bit
                # inline, the loop's hot path)
                st = cnt - (pos << 3)
                sp = 1 + (((rng - 1) * p[0]) >> 8)
                bs = sp << cnt
                if val >= bs:
                    rng -= sp
                    val -= bs
                    more = True
                else:
                    rng = sp
                    more = False
                if rng < 128:
                    s = norm[rng]
                    rng <<= s
                    cnt -= s
                    if cnt < 0:
                        val = (val << 48) | int.from_bytes(
                            buf[pos:pos + 6], "big")
                        pos += 6
                        cnt += 48
                if not more:
                    nz = n
                    break
                # zeros (p[1]) until a non-zero coefficient
                while True:
                    st = cnt - (pos << 3)
                    sp = 1 + (((rng - 1) * p[1]) >> 8)
                    bs = sp << cnt
                    if val >= bs:
                        rng -= sp
                        val -= bs
                        one = True
                    else:
                        rng = sp
                        one = False
                    if rng < 128:
                        s = norm[rng]
                        rng <<= s
                        cnt -= s
                        if cnt < 0:
                            val = (val << 48) | int.from_bytes(
                                buf[pos:pos + 6], "big")
                            pos += 6
                            cnt += 48
                    if one:
                        break
                    n += 1
                    if n == 16:
                        break
                    p = pt[n][0]
                if n == 16:
                    nz = 16
                    break
                # one (p[2]) or more
                st = cnt - (pos << 3)
                sp = 1 + (((rng - 1) * p[2]) >> 8)
                bs = sp << cnt
                if val >= bs:
                    rng -= sp
                    val -= bs
                    large = True
                else:
                    rng = sp
                    large = False
                if rng < 128:
                    s = norm[rng]
                    rng <<= s
                    cnt -= s
                    if cnt < 0:
                        val = (val << 48) | int.from_bytes(
                            buf[pos:pos + 6], "big")
                        pos += 6
                        cnt += 48
                if large:
                    state.val, state.pos, state.cnt, state.rng = \
                        val, pos, cnt, rng
                    v = _large(p, state.bit)
                    val, pos, cnt, rng = \
                        state.val, state.pos, state.cnt, state.rng
                    p = pt[n + 1][2]
                else:
                    v = 1
                    p = pt[n + 1][1]
                # the sign, at probability one half
                st = cnt - (pos << 3)
                sp = 1 + ((rng - 1) >> 1)
                bs = sp << cnt
                if val >= bs:
                    rng -= sp
                    val -= bs
                    v = -v
                else:
                    rng = sp
                if rng < 128:
                    s = norm[rng]
                    rng <<= s
                    cnt -= s
                    if cnt < 0:
                        val = (val << 48) | int.from_bytes(
                            buf[pos:pos + 6], "big")
                        pos += 6
                        cnt += 48
                index.append(bb + zz[n])
                value.append(v * (qdc if n == 0 else qac))
                n += 1
            t[ta] = left[la] = 1 if nz > first else 0
            nzs[rank * 25 + blk] = nz
        if st < end:
            raise ValueError("VP8 token partition ends early")


def _large(p, bit) -> int:
    """A coefficient of 2 or more: the token tree below p[3] and the
    extra bits of categories 3-6, read by `bit`."""
    if not bit(p[3]):
        return 2 if not bit(p[4]) else 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        v = 7 + 2 * bit(165)
        return v + bit(145)
    b1 = bit(p[8])
    cat = 2 * b1 + bit(p[9 + b1])
    v = 0
    for prob in _CAT_PROBS[cat]:
        v += v + bit(prob)
    return v + 3 + (8 << cat)


# ---------------------------------------------------------------------------
# the frame header and the modes
# ---------------------------------------------------------------------------

class Frame:
    """What the first partition says of a key frame."""

    def __init__(self, data: bytes):
        if len(data) < 10:
            raise ValueError("VP8 frame header ends early")
        bits = data[0] | data[1] << 8 | data[2] << 16
        if bits & 1:
            raise ValueError("VP8 frame is not a key frame")
        if (bits >> 1) & 7 > 3:
            raise ValueError(f"VP8 profile {(bits >> 1) & 7}")
        if not (bits >> 4) & 1:
            raise ValueError("VP8 frame is not shown")
        first = bits >> 5
        if data[3:6] != START_CODE:
            raise ValueError("VP8 start code missing")
        self.width = (data[6] | data[7] << 8) & 0x3FFF
        self.height = (data[8] | data[9] << 8) & 0x3FFF
        if not self.width or not self.height:
            raise ValueError("VP8 frame of zero size")
        if first > len(data) - 10:
            raise ValueError("VP8 first partition runs past the frame")
        self.mbw = (self.width + 15) >> 4
        self.mbh = (self.height + 15) >> 4
        br = self.br = _Bool(data[10:10 + first])
        br.literal(2)                           # colour space, clamping
        # segmentation
        self.segments = br.bit(128)
        self.absolute = 1
        quant, strength = [0] * 4, [0] * 4
        self.update_map = 0
        self.seg_probs = [255, 255, 255]
        if self.segments:
            self.update_map = br.bit(128)
            if br.bit(128):
                self.absolute = br.bit(128)
                quant = [br.flagged(7) for _ in range(4)]
                strength = [br.flagged(6) for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.literal(8) if br.bit(128) else 255
                                  for _ in range(3)]
        # the loop filter
        simple = br.bit(128)
        self.level = br.literal(6)
        self.sharpness = br.literal(3)
        ref_delta, mode_delta = [0] * 4, [0] * 4
        if br.bit(128) and br.bit(128):
            ref_delta = [br.flagged(6) for _ in range(4)]
            mode_delta = [br.flagged(6) for _ in range(4)]
        self.filter = 0 if self.level == 0 else 1 if simple else 2
        # the token partitions
        count = 1 << br.literal(2)
        rest = data[10 + first:]
        if len(rest) < 3 * (count - 1):
            raise ValueError("VP8 partition sizes run past the frame")
        start = 3 * (count - 1)
        self.parts = []
        for k in range(count - 1):
            size = min(int.from_bytes(rest[3 * k:3 * k + 3], "little"),
                       len(rest) - start)
            self.parts.append(rest[start:start + size])
            start += size
        if start >= len(rest):
            raise ValueError("VP8 last partition is empty")
        self.parts.append(rest[start:])
        # the quantizers of each segment
        q0 = br.literal(7)
        dy1dc, dy2dc, dy2ac, duvdc, duvac = (br.flagged(4) for _ in range(5))

        def clip(v, top=127):
            return min(max(v, 0), top)

        self.dq = []
        for s in range(4):
            q = (quant[s] + (0 if self.absolute else q0)) if self.segments \
                else q0
            self.dq.append((
                DC_TABLE[clip(q + dy1dc)], AC_TABLE[clip(q)],
                DC_TABLE[clip(q + dy2dc)] * 2,
                max((AC_TABLE[clip(q + dy2ac)] * 101581) >> 16, 8),
                DC_TABLE[clip(q + duvdc, 117)], AC_TABLE[clip(q + duvac)]))
        # the filter's strength of each segment, 16x16 and 4x4
        self.strength = {}
        for s in range(4):
            base = self.level
            if self.segments:
                base = strength[s] + (0 if self.absolute else self.level)
            for is4 in (0, 1):
                level = base + ref_delta[0] + (mode_delta[0] if is4 else 0)
                level = min(max(level, 0), 63)
                if level == 0:
                    self.strength[s, is4] = (0, 0, 0)
                    continue
                ilevel = level
                if self.sharpness > 0:
                    ilevel >>= 2 if self.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - self.sharpness)
                ilevel = max(ilevel, 1)
                self.strength[s, is4] = (2 * level + ilevel, ilevel,
                                         2 if level >= 40 else
                                         1 if level >= 15 else 0)
        br.bit(128)                             # refresh entropy probs
        flat = [br.literal(8) if br.bit(u) else p0
                for u, p0 in zip(COEFF_UPDATE_PROBS, COEFF_PROBS)]
        # probs[type][position][context] -> the 11 probabilities
        self.probs = [[[flat[((t * 8 + BANDS[n]) * 3 + c) * 11:
                             ((t * 8 + BANDS[n]) * 3 + c + 1) * 11]
                        for c in range(3)] for n in range(17)]
                      for t in range(4)]
        self.skip_prob = br.literal(8) if br.bit(128) else None

    def modes(self):
        """Per macroblock (raster order): segment, skip flag, is-4x4, the
        16 sub-block modes (the 16x16 mode repeated), the chroma mode."""
        br = self.br
        n = self.mbw * self.mbh
        seg = np.zeros(n, np.int64)
        skip = np.zeros(n, bool)
        is4 = np.zeros(n, bool)
        ymodes = np.zeros((n, 16), np.int64)
        uvmode = np.zeros(n, np.int64)
        top = [B_DC] * (4 * self.mbw)
        sp = self.seg_probs
        for y in range(self.mbh):
            left = [B_DC] * 4
            for x in range(self.mbw):
                i = y * self.mbw + x
                if self.update_map:
                    seg[i] = (br.bit(sp[1]) if not br.bit(sp[0])
                              else 2 + br.bit(sp[2]))
                if self.skip_prob is not None:
                    skip[i] = br.bit(self.skip_prob)
                if not br.bit(145):
                    is4[i] = True
                    m = ymodes[i]
                    for r in range(4):
                        mode = left[r]
                        for c in range(4):
                            at = (top[4 * x + c] * 10 + mode) * 9
                            prob = BMODE_PROBS[at:at + 9]
                            k = _BMODE_TREE[br.bit(prob[0])]
                            while k > 0:
                                k = _BMODE_TREE[2 * k + br.bit(prob[k])]
                            mode = top[4 * x + c] = -k
                            m[4 * r + c] = mode
                        left[r] = mode
                else:
                    mode = ((B_TM if br.bit(128) else B_HE) if br.bit(156)
                            else (B_VE if br.bit(163) else B_DC))
                    ymodes[i] = mode
                    top[4 * x:4 * x + 4] = [mode] * 4
                    left = [mode] * 4
                uvmode[i] = (B_DC if not br.bit(142) else
                             B_VE if not br.bit(114) else
                             B_TM if br.bit(183) else B_HE)
        return seg, skip, is4, ymodes, uvmode


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------

def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def idct(c: np.ndarray) -> np.ndarray:
    """(N, 4, 4) residuals (the inverse DCT's output >> 3, as libwebp
    adds it) of (N, 16) coefficients in raster order."""
    c = c.reshape(-1, 4, 4).astype(np.int64)
    r0, r1, r2, r3 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    a, b = r0 + r2, r0 - r2
    cc, d = _mul2(r1) - _mul1(r3), _mul1(r1) + _mul2(r3)
    rows = []
    for t in (a + d, b + cc, b - cc, a - d):      # each column's output k
        dc = t[:, 0] + 4
        a2, b2 = dc + t[:, 2], dc - t[:, 2]
        c2 = _mul2(t[:, 1]) - _mul1(t[:, 3])
        d2 = _mul1(t[:, 1]) + _mul2(t[:, 3])
        rows.append(np.stack([a2 + d2, b2 + c2, b2 - c2, a2 - d2], -1) >> 3)
    return np.stack(rows, 1)


def _mulhi(a: np.ndarray, k: int) -> np.ndarray:
    return ((a.astype(np.int32) * k) >> 16).astype(np.int16)


def idct16(c: np.ndarray) -> np.ndarray:
    """`idct` as libwebp's SSE2 transform computes it, in 16-bit lanes
    that wrap (the constants' "k - 65536" form). Equal to `idct` for
    coefficients in libwebp's exact range ([-2048, 2047]); past it the
    wrap decides, and libwebp takes this path for a luma block with
    tokens past position 3 and for both chroma planes' blocks where one
    holds an AC token."""
    c = c.reshape(-1, 4, 4).astype(np.int16)

    def rows(x0, x1, x2, x3):
        a, b = x0 + x2, x0 - x2
        cc = (x1 - x3) + (_mulhi(x1, -30068) - _mulhi(x3, 20091))
        d = (x1 + x3) + (_mulhi(x1, 20091) + _mulhi(x3, -30068))
        return a + d, b + cc, b - cc, a - d

    t = np.stack(rows(c[:, 0], c[:, 1], c[:, 2], c[:, 3]), 1)  # [k, col]
    t = t.transpose(0, 2, 1)                       # [col, k]: a column a row
    out = rows(t[:, 0] + np.int16(4), t[:, 1], t[:, 2], t[:, 3])
    return np.stack([o >> 3 for o in out], -1).astype(np.int64)


def iwht(c: np.ndarray) -> np.ndarray:
    """(N, 16) DC coefficients of the 16 Y blocks (raster order) from
    (N, 16) Y2 coefficients in raster order."""
    c = c.reshape(-1, 4, 4).astype(np.int64)
    r0, r1, r2, r3 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    a0, a1, a2, a3 = r0 + r3, r1 + r2, r1 - r2, r0 - r3
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)   # [row, col]
    dc = t[:, :, 0] + 3
    b0, b1 = dc + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    b2, b3 = t[:, :, 1] - t[:, :, 2], dc - t[:, :, 3]
    return (np.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], -1)
            >> 3).reshape(-1, 16)


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

# a sub-block's edge: I J K L (left, top down), X (above-left), A..H
# (above, then above-right)
_I, _J, _K, _L, _X, _A, _B, _C, _D, _E, _F, _G, _H = range(13)


def _submode_tables():
    """(weights (10, 16, 13), rounding (10, 16), shift (10, 16)) of the
    ten sub-block predictors: pixel 4 * row + col of mode m is
    (weights . edge + rounding) >> shift, clipped to 0..255."""
    w = np.zeros((10, 16, 13), np.int64)
    rnd = np.zeros((10, 16), np.int64)
    sh = np.zeros((10, 16), np.int64)

    def put(m, cells, taps, r, s):
        for x, y in cells:
            for e, k in taps:
                w[m, 4 * y + x, e] += k
            rnd[m, 4 * y + x], sh[m, 4 * y + x] = r, s

    def avg3(m, cells, a, b, c):
        put(m, cells, ((a, 1), (b, 2), (c, 1)), 2, 2)

    def avg2(m, cells, a, b):
        put(m, cells, ((a, 1), (b, 1)), 1, 1)

    every = [(x, y) for y in range(4) for x in range(4)]
    put(B_DC, every, [(e, 1) for e in (_I, _J, _K, _L, _A, _B, _C, _D)],
        4, 3)
    for x, y in every:
        put(B_TM, [(x, y)], ((_I + y, 1), (_A + x, 1), (_X, -1)), 0, 0)
    for x, (a, b, c) in enumerate(((_X, _A, _B), (_A, _B, _C),
                                   (_B, _C, _D), (_C, _D, _E))):
        avg3(B_VE, [(x, y) for y in range(4)], a, b, c)
    for y, (a, b, c) in enumerate(((_X, _I, _J), (_I, _J, _K),
                                   (_J, _K, _L), (_K, _L, _L))):
        avg3(B_HE, [(x, y) for x in range(4)], a, b, c)
    avg3(B_RD, [(0, 3)], _J, _K, _L)
    avg3(B_RD, [(1, 3), (0, 2)], _I, _J, _K)
    avg3(B_RD, [(2, 3), (1, 2), (0, 1)], _X, _I, _J)
    avg3(B_RD, [(3, 3), (2, 2), (1, 1), (0, 0)], _A, _X, _I)
    avg3(B_RD, [(3, 2), (2, 1), (1, 0)], _B, _A, _X)
    avg3(B_RD, [(3, 1), (2, 0)], _C, _B, _A)
    avg3(B_RD, [(3, 0)], _D, _C, _B)
    avg3(B_LD, [(0, 0)], _A, _B, _C)
    avg3(B_LD, [(1, 0), (0, 1)], _B, _C, _D)
    avg3(B_LD, [(2, 0), (1, 1), (0, 2)], _C, _D, _E)
    avg3(B_LD, [(3, 0), (2, 1), (1, 2), (0, 3)], _D, _E, _F)
    avg3(B_LD, [(3, 1), (2, 2), (1, 3)], _E, _F, _G)
    avg3(B_LD, [(3, 2), (2, 3)], _F, _G, _H)
    avg3(B_LD, [(3, 3)], _G, _H, _H)
    avg2(B_VR, [(0, 0), (1, 2)], _X, _A)
    avg2(B_VR, [(1, 0), (2, 2)], _A, _B)
    avg2(B_VR, [(2, 0), (3, 2)], _B, _C)
    avg2(B_VR, [(3, 0)], _C, _D)
    avg3(B_VR, [(0, 3)], _K, _J, _I)
    avg3(B_VR, [(0, 2)], _J, _I, _X)
    avg3(B_VR, [(0, 1), (1, 3)], _I, _X, _A)
    avg3(B_VR, [(1, 1), (2, 3)], _X, _A, _B)
    avg3(B_VR, [(2, 1), (3, 3)], _A, _B, _C)
    avg3(B_VR, [(3, 1)], _B, _C, _D)
    avg2(B_VL, [(0, 0)], _A, _B)
    avg2(B_VL, [(1, 0), (0, 2)], _B, _C)
    avg2(B_VL, [(2, 0), (1, 2)], _C, _D)
    avg2(B_VL, [(3, 0), (2, 2)], _D, _E)
    avg3(B_VL, [(0, 1)], _A, _B, _C)
    avg3(B_VL, [(1, 1), (0, 3)], _B, _C, _D)
    avg3(B_VL, [(2, 1), (1, 3)], _C, _D, _E)
    avg3(B_VL, [(3, 1), (2, 3)], _D, _E, _F)
    avg3(B_VL, [(3, 2)], _E, _F, _G)
    avg3(B_VL, [(3, 3)], _F, _G, _H)
    avg2(B_HU, [(0, 0)], _I, _J)
    avg2(B_HU, [(2, 0), (0, 1)], _J, _K)
    avg2(B_HU, [(2, 1), (0, 2)], _K, _L)
    avg3(B_HU, [(1, 0)], _I, _J, _K)
    avg3(B_HU, [(3, 0), (1, 1)], _J, _K, _L)
    avg3(B_HU, [(3, 1), (1, 2)], _K, _L, _L)
    put(B_HU, [(3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)],
        ((_L, 1),), 0, 0)
    avg2(B_HD, [(0, 0), (2, 1)], _I, _X)
    avg2(B_HD, [(0, 1), (2, 2)], _J, _I)
    avg2(B_HD, [(0, 2), (2, 3)], _K, _J)
    avg2(B_HD, [(0, 3)], _L, _K)
    avg3(B_HD, [(3, 0)], _A, _B, _C)
    avg3(B_HD, [(2, 0)], _X, _A, _B)
    avg3(B_HD, [(1, 0), (3, 1)], _I, _X, _A)
    avg3(B_HD, [(1, 1), (3, 2)], _X, _I, _J)
    avg3(B_HD, [(1, 2), (3, 3)], _I, _J, _K)
    avg3(B_HD, [(1, 3)], _J, _K, _L)
    return w, rnd, sh


_SUB_W, _SUB_R, _SUB_S = _submode_tables()


def _waves(mbw: int, mbh: int):
    """The macroblocks' (y, x) in anti-diagonals x + 2y = t: each one's
    left, above-left, above and above-right neighbours lie in earlier
    diagonals."""
    for t in range(mbw + 2 * (mbh - 1)):
        ys = np.arange(max(0, (t - mbw + 2) // 2), min(mbh - 1, t // 2) + 1)
        yield ys, t - 2 * ys


def _predict_big(buf, ys, xs, modes, size: int, res):
    """16x16 (or 8x8 chroma) prediction by mode plus the residual, into
    buf (bordered: pixel (py, px) at buf[py + 1, px + 1])."""
    r = np.arange(size)
    rows = size * ys[:, None] + 1 + r            # (K, size)
    cols = size * xs[:, None] + 1 + r
    top = buf[(size * ys)[:, None], cols]
    left = buf[rows, (size * xs)[:, None]]
    tl = buf[size * ys, size * xs]
    sh = size.bit_length() - 1                   # log2 of the size
    dc_all = (top.sum(1) + left.sum(1) + size) >> (sh + 1)
    dc_left = (left.sum(1) + size // 2) >> sh
    dc_top = (top.sum(1) + size // 2) >> sh
    dc = np.where(ys == 0, np.where(xs == 0, 128, dc_left),
                  np.where(xs == 0, dc_top, dc_all))
    m = modes[:, None, None]
    pred = np.where(m == B_DC, dc[:, None, None], np.where(
        m == B_VE, top[:, None, :], np.where(
            m == B_HE, left[:, :, None],
            np.clip(left[:, :, None] + top[:, None, :] - tl[:, None, None],
                    0, 255))))
    buf[rows[:, :, None], cols[:, None, :]] = np.clip(pred + res, 0, 255)


def _predict_sub(buf, ys, xs, modes, res, mbw):
    """The 16 sub-blocks of B_PRED macroblocks in turn, each by its mode
    plus its residual (res (K, 16, 4, 4))."""
    tr = buf[(16 * ys)[:, None], (16 * xs + 17)[:, None] + np.arange(4)]
    edge = (xs == mbw - 1) & (ys > 0)
    tr[edge] = buf[16 * ys[edge], 16 * xs[edge] + 16][:, None]
    r4 = np.arange(4)
    for n in range(16):
        sr, sc = divmod(n, 4)
        py = 16 * ys + 4 * sr                    # pixel row and column
        px = 16 * xs + 4 * sc
        left = buf[(py + 1)[:, None] + r4, px[:, None]]
        corner = buf[py, px][:, None]
        above = buf[py[:, None], (px + 1)[:, None] + np.arange(8)]
        if sc == 3:
            above[:, 4:] = tr
        e = np.concatenate([left, corner, above], 1)
        m = modes[:, n]
        pred = np.clip((np.einsum("kpe,ke->kp", _SUB_W[m], e) + _SUB_R[m])
                       >> _SUB_S[m], 0, 255).reshape(-1, 4, 4)
        buf[(py + 1)[:, None, None] + r4[:, None],
            (px + 1)[:, None, None] + r4] = np.clip(pred + res[:, n], 0, 255)


# ---------------------------------------------------------------------------
# the loop filter
# ---------------------------------------------------------------------------

def _clip255(v):
    return np.clip(v, 0, 255)


def _filter_lines(flat, q, step, thresh, ilevel, hev, kind: str) -> None:
    """Filter the edge before each q (flat index of its first pixel
    past the edge) across `step`: kind "simple", "mb" (the normal
    filter on a macroblock edge) or "inner" (on an inner edge)."""
    if len(q) == 0:
        return
    taps = q[:, None] + step[:, None] * np.arange(-4, 4)
    v = flat[taps]
    p3, p2, p1, p0, q0, q1, q2, q3 = v.T
    t2 = 2 * thresh + 1
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind != "simple":
        need &= ((np.abs(p3 - p2) <= ilevel) & (np.abs(p2 - p1) <= ilevel)
                 & (np.abs(p1 - p0) <= ilevel) & (np.abs(q3 - q2) <= ilevel)
                 & (np.abs(q2 - q1) <= ilevel) & (np.abs(q1 - q0) <= ilevel))
        strong = (np.abs(p1 - p0) > hev) | (np.abs(q1 - q0) > hev)
    else:
        strong = np.ones_like(need)
    out = v.copy()
    # two pixels changed (the simple filter, and high edge variance)
    f2 = need & strong
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    out[f2, 3] = _clip255(p0 + a2)[f2]
    out[f2, 4] = _clip255(q0 - a1)[f2]
    rest = need & ~strong
    if kind == "mb":
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        w1, w2, w3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        for k, new in ((1, p2 + w3), (2, p1 + w2), (3, p0 + w1),
                       (4, q0 - w1), (5, q1 - w2), (6, q2 - w3)):
            out[rest, k] = _clip255(new)[rest]
    elif kind == "inner":
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for k, new in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1),
                       (5, q1 - a3)):
            out[rest, k] = _clip255(new)[rest]
    flat[taps] = out


def _loop_filter(f: Frame, planes, limit, ilevel, hev, inner) -> None:
    """libwebp's DoFilter on every macroblock, in anti-diagonals (a
    macroblock's filter reads what its left, above and above-right
    neighbours' filters wrote)."""
    ystride = 16 * f.mbw
    cstride = 8 * f.mbw
    r16 = np.arange(16)
    simple = f.filter == 1
    for ys, xs in _waves(f.mbw, f.mbh):
        ids = ys * f.mbw + xs
        on = limit[ids] > 0
        ys, xs, ids = ys[on], xs[on], ids[on]
        if len(ids) == 0:
            continue
        inn = inner[ids]

        def run(sel, size, stride, origin, across, kind, lim_add, flat):
            """One edge of each selected macroblock: `origin` (K,) the
            pixel row/column offsets, `across` True for a vertical edge."""
            k = size
            rr = r16[:size]
            oy, ox = origin
            if across:                           # vertical edge, step 1
                q = ((oy[sel, None] + rr) * stride + ox[sel, None]).ravel()
                step = np.ones_like(q)
            else:                                # horizontal edge
                q = (oy[sel, None] * stride + ox[sel, None] + rr).ravel()
                step = np.full_like(q, stride)
            rep = np.repeat
            _filter_lines(flat, q, step, rep(limit[ids[sel]] + lim_add, k),
                          rep(ilevel[ids[sel]], k), rep(hev[ids[sel]], k),
                          kind)

        left_edge = xs > 0
        top_edge = ys > 0
        y0, x0 = 16 * ys, 16 * xs
        c0y, c0x = 8 * ys, 8 * xs
        lum = planes[0]
        if simple:
            run(left_edge, 16, ystride, (y0, x0), True, "simple", 4, lum)
            for k in (4, 8, 12):
                run(inn, 16, ystride, (y0, x0 + k), True, "simple", 0, lum)
            run(top_edge, 16, ystride, (y0, x0), False, "simple", 4, lum)
            for k in (4, 8, 12):
                run(inn, 16, ystride, (y0 + k, x0), False, "simple", 0, lum)
            continue
        run(left_edge, 16, ystride, (y0, x0), True, "mb", 4, lum)
        for c in planes[1:]:
            run(left_edge, 8, cstride, (c0y, c0x), True, "mb", 4, c)
        for k in (4, 8, 12):
            run(inn, 16, ystride, (y0, x0 + k), True, "inner", 0, lum)
        for c in planes[1:]:
            run(inn, 8, cstride, (c0y, c0x + 4), True, "inner", 0, c)
        run(top_edge, 16, ystride, (y0, x0), False, "mb", 4, lum)
        for c in planes[1:]:
            run(top_edge, 8, cstride, (c0y, c0x), False, "mb", 4, c)
        for k in (4, 8, 12):
            run(inn, 16, ystride, (y0 + k, x0), False, "inner", 0, lum)
        for c in planes[1:]:
            run(inn, 8, cstride, (c0y + 4, c0x), False, "inner", 0, c)


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

def decode_planes(data: bytes):
    """(Y (H, W), U, V (each ((H + 1) // 2, (W + 1) // 2))) uint8 planes
    of a VP8 key frame (the payload of a WebP file's VP8 chunk), filtered
    and cropped."""
    f = Frame(data)
    seg, skip, is4, ymodes, uvmode = f.modes()
    mbw, mbh = f.mbw, f.mbh
    n = mbw * mbh
    index, value, nzs = [], [], bytearray(25 * n)
    mbs = [(i, i % mbw, bool(is4[i]), int(seg[i]), bool(skip[i]))
           for i in range(n)]
    _tokens(f.parts, mbs, mbw, f.probs, f.dq, index, value, nzs)
    nz = np.frombuffer(bytes(nzs), np.uint8).reshape(n, 25)
    coef = np.zeros(n * 400, np.int64)
    coef[np.asarray(index, np.int64)] = _wrap16(np.asarray(value, np.int64))
    coef = coef.reshape(n, 25, 16)
    big = ~is4
    if big.any():
        coef[big, :16, 0] = _wrap16(iwht(coef[big, 24]))
    # a skipped macroblock holds no coefficient
    inner = is4 | (nz[:, :24] > 1).any(1) | (coef[:, :24, 0] != 0).any(1)
    res = idct(coef[:, :24].reshape(-1, 16)).reshape(n, 24, 4, 4)
    # the blocks libwebp's SSE2 transform takes (its C code the rest)
    wide = nz[:, :24] > 3
    wide[:, 16:20] = (nz[:, 16:20] > 1).any(1, keepdims=True)
    wide[:, 20:24] = (nz[:, 20:24] > 1).any(1, keepdims=True)
    if wide.any():
        res[wide] = idct16(coef[:, :24][wide])
    # the planes, bordered by 127 above and 129 left
    ybuf = np.empty((16 * mbh + 1, 16 * mbw + 5), np.int64)
    ubuf = np.empty((8 * mbh + 1, 8 * mbw + 1), np.int64)
    vbuf = np.empty_like(ubuf)
    for b in (ybuf, ubuf, vbuf):
        b[0] = 127
        b[1:, 0] = 129
    res16 = res[:, :16].reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)
    resu = res[:, 16:20].reshape(n, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 8, 8)
    resv = res[:, 20:24].reshape(n, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 8, 8)
    for ys, xs in _waves(mbw, mbh):
        ids = ys * mbw + xs
        sub = is4[ids]
        if (~sub).any():
            _predict_big(ybuf, ys[~sub], xs[~sub], ymodes[ids[~sub], 0], 16,
                         res16[ids[~sub]])
        if sub.any():
            _predict_sub(ybuf, ys[sub], xs[sub], ymodes[ids[sub]],
                         res[ids[sub], :16], mbw)
        _predict_big(ubuf, ys, xs, uvmode[ids], 8, resu[ids])
        _predict_big(vbuf, ys, xs, uvmode[ids], 8, resv[ids])
    planes = [ybuf[1:, 1:16 * mbw + 1].ravel().copy(),
              ubuf[1:, 1:].ravel().copy(), vbuf[1:, 1:].ravel().copy()]
    if f.filter:
        strength = np.array([f.strength[int(s), int(i)]
                             for s, i in zip(seg, is4)], np.int64)
        _loop_filter(f, planes, strength[:, 0], strength[:, 1],
                     strength[:, 2], inner)
    w, h = f.width, f.height
    cw, ch = (w + 1) // 2, (h + 1) // 2
    y = planes[0].reshape(16 * mbh, 16 * mbw)[:h, :w]
    u = planes[1].reshape(8 * mbh, 8 * mbw)[:ch, :cw]
    v = planes[2].reshape(8 * mbh, 8 * mbw)[:ch, :cw]
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


# ---------------------------------------------------------------------------
# libwebp's output stage
# ---------------------------------------------------------------------------

def _fancy(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h, w) of a chroma plane ((h + 1) // 2, (w + 1) // 2) by libwebp's
    fancy upsampler: each output row pair between chroma rows t (above)
    and c (below) weighs the nearer 3:1 across and along, through two
    rounded diagonal means; the first and last rows and columns take
    their one or two nearest samples."""
    c = c.astype(np.int64)
    ch = c.shape[0]
    r = np.arange(h)
    # the chroma rows each output row is made between: row 0 between row
    # 0 and itself, rows 2k - 1 and 2k between k - 1 and k (clamped)
    tops = np.where(r == 0, 0, (r - 1) // 2)
    curs = np.minimum(np.where(r == 0, 0, (r + 1) // 2), ch - 1)
    upper = (r % 2 == 1) | (r == 0)          # the row nearer `tops`
    t, b = c[tops], c[curs]
    near, far = np.where(upper[:, None], t, b), np.where(upper[:, None], b, t)
    out = np.empty((h, w), np.int64)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    n = (w - 1) >> 1                             # the pairs past the first
    if n:
        tl, tt = t[:, :n], t[:, 1:n + 1]
        ll, cc = b[:, :n], b[:, 1:n + 1]
        avg = tl + tt + ll + cc + 8
        d12 = (avg + 2 * (tt + ll)) >> 3
        d03 = (avg + 2 * (tl + cc)) >> 3
        up = upper[:, None]
        out[:, 1:2 * n:2] = np.where(up, (d12 + tl) >> 1, (d03 + ll) >> 1)
        out[:, 2:2 * n + 1:2] = np.where(up, (d03 + tt) >> 1,
                                         (d12 + cc) >> 1)
    if w % 2 == 0:
        out[:, w - 1] = (3 * near[:, -1] + far[:, -1] + 2) >> 2
    return out


def _clip8(v: np.ndarray) -> np.ndarray:
    """libwebp's VP8Clip8: a 14-bit fixed-point value to 0..255."""
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 of the planes as libwebp writes RGB: fancy
    upsampling, then its fixed-point BT.601 conversion."""
    h, w = y.shape
    y = y.astype(np.int64)
    u = _fancy(u, h, w)
    v = _fancy(v, h, w)
    yy = (y * 19077) >> 8
    r = _clip8(yy + ((v * 26149) >> 8) - 14234)
    g = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = _clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a VP8 key frame, libwebp's RGB output."""
    return yuv_to_rgb(*decode_planes(data))
