"""Huffman-coded JPEG decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with PIL (rlshaders_tpu/scene/texture.py);
the card's image has no PIL, so the port decodes JPEG itself. It follows
what PIL asks of libjpeg-turbo 3.1 by default, so that `decode_jpeg`
returns the bytes of `np.asarray(Image.open(path).convert("RGB"))`, on
damaged data too:

* the integer IDCT (`JDCT_ISLOW`) as libjpeg-turbo's SSE2 and AVX2
  routines compute it (`jsimd_idct_islow`, which PIL runs on any x86-64
  host), not as its C routine (jidctint.c): 16-bit lanes. Dequantisation
  is a 16-bit multiply that wraps (a quantisation value past 32767 is
  negative), the even part's in0 +- in4 and the odd part's z3 = in3 + in7
  and z4 = in1 + in5 wrap at 16 bits, the products are exact 32-bit
  multiply-adds, each pass's outputs saturate to 16 bits, and the samples
  saturate to [-128, 127] before the +128 (the C routine's range-limit
  table wraps instead). A block whose coefficient rows 1-7 are all zero
  takes the column pass's shortcut, (DC x q) << 2 in 16 bits. Valid files
  give the same samples either way; held to PIL on blocks of extreme
  coefficients and 16-bit tables. A host on which libjpeg-turbo takes
  neither routine (no SSE2) is not modelled;
* "fancy" chroma upsampling (jdsample.c `h2v1_fancy_upsample`,
  `h1v2_fancy_upsample`, `h2v2_fancy_upsample`: the 3/4-1/4 triangle
  filter with its alternating rounding biases; the first and last real
  row and column of a component stand in for their missing neighbours,
  never the MCU padding; components two samples wide or narrower are
  replicated instead, as libjpeg-turbo does);
* the fixed-point YCbCr to RGB conversion of jdcolor.c (SCALEBITS 16);
* libjpeg's colour-space guess (jdapimin.c): three components are RGB
  under an Adobe marker with transform 0 and no JFIF marker, or with the
  component ids 'R', 'G', 'B', else YCbCr; four are CMYK (Adobe transform
  0 or no Adobe marker) or YCCK (turned into CMYK as 255 minus its YCbCr
  to RGB conversion); PIL reads four components as inverted CMYK
  ("CMYK;I") and converts them as (255 - C)(255 - K) / 255, rounded as
  Pillow's MULDIV255;
* block smoothing (jdcoefct.c `decompress_smooth_data`, libjpeg-turbo
  3.1): a progressive file whose scans leave some of the first ten
  zig-zag coefficients of a component not fully known has each zero one
  estimated from the 5x5 neighbourhood of DC values (and, where no AC
  coefficient was sent at all, the DC smoothed too), with libjpeg's
  clamping at the image's edges and its reading of the last iMCU row.

Damaged data is decoded as libjpeg decodes it where it only warns, and
raises ValueError where it (or Pillow) fails:

* a Huffman code longer than 16 bits is read as symbol 0 after 17 bits
  (JWRN_HUFF_BAD_CODE); an AC run past coefficient 63 lands on 63
  (jpeg_natural_order's 16 extra entries); a refinement symbol of a size
  other than 1 is read as size 1; coefficients are stored as 16-bit
  JCOEF, the DC prediction as an int;
* a sequential scan's Ss, Se, Ah and Al are ignored (JWRN_NOT_SEQUENTIAL);
  inconsistent progressive scans only warn (JWRN_BOGUS_PROGRESSION), an
  illegal one (JERR_BAD_PROGRESSION) fails;
* scan data ends at the first marker (0xFF followed by neither 0x00 nor
  0xFF; FF...FF 00 is one 0xFF data byte). Bits wanted past it are zeros
  (JWRN_HIT_MARKER): the MCU that wanted them is decoded from them, the
  rest of its restart interval is skipped (those blocks keep what they
  held, zero in a sequential scan). At a restart boundary libjpeg's
  `read_restart_marker` and `jpeg_resync_to_restart` decide: the
  expected RSTn is swallowed, other bytes before a marker are skipped
  (JWRN_EXTRANEOUS_DATA), and a wrong marker is discarded, scanned past
  or left in place by its distance from the expected one;
* scans, markers and tables follow jdmarker.c and jdinput.c: a file
  whose scans do not cover every component leaves the others grey, a
  sequential file of one scan is done once its rows are out (what
  follows up to EOI is read for its errors only; data that ends there is
  not an error), a file of several scans needs its EOI, and a
  sequential file's missing Huffman tables 0 and 1 are libjpeg-turbo's
  standard tables (a progressive file's fail);
* Pillow's source suspends at the end of the data, and a decode that
  needs bytes past it fails ("image file is truncated"), following
  libjpeg's bit buffer, which reads ahead to 57 bits whenever it runs
  short; libtiff's source (`tiff=True`, JPEG-compressed TIFF strips and
  tiles) hands over a fake EOI there instead (JWRN_JPEG_EOF), and libtiff
  takes a failure after a single scan's rows for success.

Decoded: baseline, extended sequential and progressive Huffman frames
(SOF0, SOF1, SOF2) of 8-bit samples, 8- and 16-bit quantisation tables,
restart intervals, one, three or four components with chroma sampled
1x1, 2x1, 1x2 or 2x2 against the largest factors, interleaved or one
scan per component, any width and height. Lossless, hierarchical and
arithmetic-coded files, 12-bit samples and other sampling ratios raise
NotImplementedError naming the mode.

The Huffman decode is sequential Python over a 16-bit lookahead table; the
IDCT, block smoothing, upsampling and colour conversion are numpy over all
blocks at once.
"""
from __future__ import annotations

import numpy as np

from . import bomb

# natural (row-major) index of the k-th coefficient in zig-zag order
ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)
# jpeg_natural_order with its 16 extra entries: a run past 63 lands on 63
_ZZX = ZIGZAG + (63,) * 16

# frame markers that start a mode the port does not decode
_MODES = {
    0xC3: "lossless",
    0xC5: "differential sequential (hierarchical)",
    0xC6: "differential progressive (hierarchical)",
    0xC7: "differential lossless (hierarchical)",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    0xCD: "differential arithmetic-coded sequential",
    0xCE: "differential arithmetic-coded progressive",
    0xCF: "differential arithmetic-coded lossless",
}

# libjpeg-turbo's standard Huffman tables (jstdhuff.c), installed where a
# file defines no table 0 or 1: (bits, values)
_STD = {
    ("dc", 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("dc", 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("ac", 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
                bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a8384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
        "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
        "f5f6f7f8f9fa")),
    ("ac", 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a8283848586"
        "8788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9ba"
        "c2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5"
        "f6f7f8f9fa")),
}

# jidctint.c's constants (CONST_BITS 13), as the SIMD routines pair them
_F = dict(F029=2446, F039=3196, F054=4433, F076=6270, F089=7373,
          F117=9633, F150=12299, F184=15137, F196=16069, F205=16819,
          F256=20995, F307=25172)


def _w16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _w32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_pass(x, shift: int) -> list:
    """One pass of jsimd_idct_islow over eight 16-bit inputs x[0..7]
    (arrays): the eight outputs descaled by `shift` bits, saturated to 16
    bits (packssdw)."""
    f = _F
    in0, in1, in2, in3, in4, in5, in6, in7 = x
    tmp0 = _w16(in0 + in4) << 13
    tmp1 = _w16(in0 - in4) << 13
    tmp3 = in2 * (f["F054"] + f["F076"]) + in6 * f["F054"]
    tmp2 = in2 * f["F054"] + in6 * (f["F054"] - f["F184"])
    tmp10, tmp13 = _w32(tmp0 + tmp3), _w32(tmp0 - tmp3)
    tmp11, tmp12 = _w32(tmp1 + tmp2), _w32(tmp1 - tmp2)
    z3 = _w16(in3 + in7)
    z4 = _w16(in1 + in5)
    z3, z4 = (z3 * (f["F117"] - f["F196"]) + z4 * f["F117"],
              z3 * f["F117"] + z4 * (f["F117"] - f["F039"]))
    t0 = _w32(in7 * (f["F029"] - f["F089"]) - in1 * f["F089"] + z3)
    t3 = _w32(-in7 * f["F089"] + in1 * (f["F150"] - f["F089"]) + z4)
    t1 = _w32(in5 * (f["F205"] - f["F256"]) - in3 * f["F256"] + z4)
    t2 = _w32(-in5 * f["F256"] + in3 * (f["F307"] - f["F256"]) + z3)
    half = 1 << (shift - 1)
    return [np.clip(_w32(v + half) >> shift, -32768, 32767) for v in (
        _w32(tmp10 + t3), _w32(tmp11 + t2), _w32(tmp12 + t1),
        _w32(tmp13 + t0), _w32(tmp13 - t0), _w32(tmp12 - t1),
        _w32(tmp11 - t2), _w32(tmp10 - t3))]


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's SSE2/AVX2 jsimd_idct_islow of (N, 64) natural-order
    16-bit coefficients under the natural-order quantisation table qt
    (64,): (N, 8, 8) uint8 samples."""
    coef = _w16(np.asarray(coef, np.int64).reshape(-1, 64))
    blk = _w16(coef * _w16(np.asarray(qt, np.int64))).reshape(-1, 8, 8)
    # pass 1: columns (the vertical frequencies of each column)
    ws = np.stack(_idct_pass([blk[:, k, :] for k in range(8)], 11), axis=1)
    dc_only = ~coef[:, 8:].any(axis=1)
    ws = np.where(dc_only[:, None, None], _w16(blk[:, :1, :] << 2), ws)
    # pass 2: rows, then packsswb and +128
    out = np.stack(_idct_pass([ws[:, :, k] for k in range(8)], 18), axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _dup_edges(a: np.ndarray, axis: int):
    """(previous, next) neighbours of every sample of `a` along `axis`, the
    first and last sample standing in for the missing ones."""
    n = a.shape[axis]
    idx = np.arange(n)
    prev = np.take(a, np.maximum(idx - 1, 0), axis=axis)
    nxt = np.take(a, np.minimum(idx + 1, n - 1), axis=axis)
    return prev, nxt


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([even, odd], axis=axis + 1).reshape(
        *even.shape[:axis], 2 * even.shape[axis], *even.shape[axis + 1:])


def upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """jdsample.c's upsampling of a component's real samples (h, w) uint8
    by rh horizontally and rv vertically (each 1 or 2): (rv h, rh w)."""
    a = plane.astype(np.int32)
    w = a.shape[1]
    if rv == 2 and rh == 1:                      # h1v2_fancy_upsample
        up, down = _dup_edges(a, 0)
        a = _interleave((3 * a + up + 1) >> 2, (3 * a + down + 2) >> 2, 0)
    elif rv == 2 and w > 2:                      # h2v2_fancy_upsample
        up, down = _dup_edges(a, 0)
        cs = _interleave(3 * a + up, 3 * a + down, 0)
        left, right = _dup_edges(cs, 1)
        a = _interleave((3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4,
                        1)
    elif rh == 2 and w > 2:                      # h2v1_fancy_upsample
        left, right = _dup_edges(a, 1)
        a = _interleave((3 * a + left + 1) >> 2, (3 * a + right + 2) >> 2, 1)
    else:                                        # replication
        a = np.repeat(np.repeat(a, rv, axis=0), rh, axis=1)
    return a.astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert of three uint8 planes: (h, w, 3) uint8."""
    scale = 16
    half = 1 << (scale - 1)

    def fix(v):
        return int(v * (1 << scale) + 0.5)

    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((fix(1.40200) * cr + half) >> scale)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> scale)
    b = y + ((fix(1.77200) * cb + half) >> scale)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _huffman_lut(counts, symbols, dc: bool) -> list:
    """jpeg_make_d_derived_tbl as a 16-bit lookahead table: for every
    16-bit window, (check << 16) | (length << 8) | symbol of its code,
    where `check` is how far libjpeg's bit buffer must reach to decode it
    (its 8-bit lookahead, or the code). A window no code starts is a code
    of 17 bits and symbol 0 (JWRN_HUFF_BAD_CODE)."""
    lut = np.full(1 << 16, (17 << 16) | (17 << 8), np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (
                max(8, length) << 16 | length << 8 | symbols[k])
            code += 1
            k += 1
        # no code may be all ones (checked up to the longest length used)
        if code >= 1 << length and any(counts[length - 1:]):
            raise ValueError("JPEG Huffman table with too many codes")
        code <<= 1
    if dc and any(s > 15 for s in symbols[:k]):
        raise ValueError("JPEG DC Huffman table with a symbol past 15")
    return lut.tolist()


class _Component:
    def __init__(self, index: int, cid: int, h: int, v: int, tq: int):
        self.index, self.cid, self.h, self.v, self.tq = index, cid, h, v, tq
        self.qt = None        # latched at the component's first scan
        self.coef = None      # flat list of (rows * cols * 64) coefficients
        self.rows = self.cols = 0     # block grid, MCU-padded
        self.brows = self.bcols = 0   # real blocks
        self.height = self.width = 0  # real samples
        # progressive: the approximation bit each zig-zag coefficient was
        # last sent at, -1 before its first scan (libjpeg's coef_bits),
        # and the same before the component's latest scan
        self.bits = [-1] * 64
        self.prev = [-1] * 64


class _Suspend(ValueError):
    """The decode needs bytes past the end of the data: Pillow's source
    suspends there, and PIL fails the image as truncated."""

    def __init__(self):
        super().__init__("JPEG data ends before the decoder is done (PIL: "
                         "image file is truncated)")


class _Reader:
    """libjpeg's data source over a stream's bytes: Pillow's, which
    suspends at their end, or libtiff's (`tiff`), which hands over a fake
    EOI there."""

    def __init__(self, data: bytes, tiff: bool):
        self.n = len(data)
        self.data = data + b"\xff\xd9" * 64 if tiff else data
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Suspend()
        self.pos += 1
        return self.data[self.pos - 1]

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Suspend()
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u16(self) -> int:
        b = self.read(2)
        return b[0] << 8 | b[1]

    def skip(self, n: int) -> None:
        if n <= 0:
            return
        if self.pos + n > self.n and len(self.data) > self.n:
            self.pos = max(self.pos, self.n)      # libtiff: a fake EOI
        elif self.pos + n > len(self.data):
            raise _Suspend()
        else:
            self.pos += n

    def next_marker(self) -> int:
        """jdmarker.c next_marker: skip to the next marker (past other
        bytes and FF 00 pairs) and read its code."""
        while True:
            c = self.byte()
            while c != 0xFF:
                c = self.byte()
            c = self.byte()
            while c == 0xFF:
                c = self.byte()
            if c:
                return c

    def segment(self):
        """The entropy-coded bytes from here to the next marker, unstuffed
        (FF..FF 00 is one 0xFF), and that marker's code, the reader left
        after it; (bytes, None) where the data ends first (a trailing run
        of 0xFF is not a byte yet)."""
        d, out, i = self.data, [], self.pos
        start = i
        while True:
            i = d.find(b"\xff", i)
            if i < 0:
                out.append(d[start:])
                self.pos = len(d)
                return b"".join(out), None
            j = i + 1
            while j < len(d) and d[j] == 0xFF:
                j += 1
            if j >= len(d):
                out.append(d[start:i])
                self.pos = len(d)
                return b"".join(out), None
            if d[j] == 0:
                out.append(d[start:i + 1])
                i = start = j + 1
                continue
            out.append(d[start:i])
            self.pos = j + 1
            return b"".join(out), d[j]


def _windows(raw: bytes, pad: int) -> list:
    """The 32 bits from every byte of `raw` on (zeros past its end, for
    `pad` bytes): the bits from bit position p are read as win[p >> 3] <<
    (p & 7)."""
    buf = np.frombuffer(raw + bytes(pad + 8), np.uint8).astype(np.int64)
    return (buf[:-3] << 24 | buf[1:-2] << 16 | buf[2:-1] << 8
            | buf[3:]).tolist()


# The entropy decoders run over one restart interval: `units` lists its
# MCUs, each a list of (component slot, coefficient offset) of its blocks
# in stream order, and the data holds `end` bits. Each returns (number of
# MCUs decoded, bit position reached); it stops after the MCU that read
# past `end` (libjpeg's insufficient_data: that MCU is decoded from zero
# bits, the rest of the interval is skipped).

def _sequential(win, end, units, dc_luts, ac_luts, outs):
    """jdhuff.c decode_mcu: a DC difference and the AC coefficients of
    every block, written in natural order (nonzero ones only: the blocks
    start zero)."""
    zz = _ZZX
    pred = [0] * len(outs)
    p = 0
    for n, unit in enumerate(units):
        for slot, base in unit:
            out, dc, ac = outs[slot], dc_luts[slot], ac_luts[slot]
            e = dc[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += (e >> 8) & 31
            s = e & 0xFF
            if s:
                x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if x < 1 << (s - 1):
                    x += 1 - (1 << s)
                pred[slot] += x
            out[base] = ((pred[slot] + 32768) & 0xFFFF) - 32768
            k = 1
            while k < 64:
                e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += (e >> 8) & 31
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if x < 1 << (s - 1):
                        x += 1 - (1 << s)
                    out[base + zz[k]] = x
                    k += 1
                elif (e & 0xF0) == 0xF0:
                    k += 16
                else:
                    break
        if p > end:
            return n + 1, p
    return len(units), p


def _fill_reaches_end(win, m, units, dc_luts, ac_luts) -> bool:
    """Whether libjpeg's bit buffer, decoding the sequential `units` from
    data of `m` whole bytes that end the file with no marker, tries to
    read past them (Pillow's source then suspends). jpeg_fill_bit_buffer
    reads ahead until it holds 57 bits whenever a request finds fewer bits
    than it wants: the 8-bit Huffman lookahead, then 9 bits and one more
    at a time for a longer code, then the value bits."""
    loaded = p = 0

    def fill(q: int) -> bool:
        nonlocal loaded
        loaded = (q + 64) // 8 * 8
        return loaded > 8 * m

    def code(lut) -> int:
        nonlocal p
        e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        n = (e >> 8) & 31
        if p + 8 > loaded or (n > 8 and p + 9 > loaded):
            q = p
        elif p + n > loaded:
            q = loaded
        else:
            q = None
        if q is not None and fill(q):
            raise _Suspend()
        p += n
        return e

    def value(s: int) -> None:
        nonlocal p
        if s and p + s > loaded and fill(p):
            raise _Suspend()
        p += s

    try:
        for unit in units:
            for slot, _ in unit:
                value(code(dc_luts[slot]) & 0xFF)
                k = 1
                while k < 64:
                    e = code(ac_luts[slot])
                    if e & 15:
                        value(e & 15)
                        k += ((e >> 4) & 15) + 1
                    elif (e & 0xF0) == 0xF0:
                        k += 16
                    else:
                        break
    except _Suspend:
        return True
    return False


def _dc_first(win, end, units, dc_luts, outs, al):
    """A progressive scan's first DC bits (jdphuff.c decode_mcu_DC_first):
    each block's DC difference, its running sum shifted up by `al`."""
    pred = [0] * len(outs)
    p = 0
    for n, unit in enumerate(units):
        for slot, base in unit:
            e = dc_luts[slot][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += (e >> 8) & 31
            s = e & 0xFF
            if s:
                x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if x < 1 << (s - 1):
                    x += 1 - (1 << s)
                pred[slot] += x
            outs[slot][base] = (((pred[slot] << al) + 32768) & 0xFFFF) - 32768
        if p > end:
            return n + 1, p
    return len(units), p


def _dc_refine(win, end, units, outs, al):
    """A DC refinement scan (decode_mcu_DC_refine): one bit a block, or'ed
    in at bit `al` (bits past the data are zeros and change nothing)."""
    one = 1 << al
    p = 0
    for unit in units:
        for slot, base in unit:
            if p < end and (win[p >> 3] >> (31 - (p & 7))) & 1:
                outs[slot][base] |= one
            p += 1
    return len(units), p


def _ac_first(win, end, units, ac, out, ss, se, al):
    """A progressive scan's first bits of AC coefficients ss..se of one
    component (decode_mcu_AC_first), with end-of-band runs that span
    blocks."""
    zz = _ZZX
    p = 0
    eobrun = 0
    for n, unit in enumerate(units):
        if eobrun:
            eobrun -= 1
            continue
        base = unit[0][1]
        k = ss
        while k <= se:
            e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += (e >> 8) & 31
            s = e & 15
            r = (e >> 4) & 15
            if s:
                k += r
                x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if x < 1 << (s - 1):
                    x += 1 - (1 << s)
                out[base + zz[k]] = (((x << al) + 32768) & 0xFFFF) - 32768
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & (
                        (1 << r) - 1)
                    p += r
                eobrun -= 1
                break
        if p > end:
            return n + 1, p
    return len(units), p


def _ac_refine(win, end, units, ac, out, ss, se, al):
    """An AC refinement scan of one component (decode_mcu_AC_refine): a
    correction bit for every coefficient of ss..se already nonzero, read
    as the walk passes it, and the coefficients that become nonzero at
    bit `al`, each placed after a run of still-zero ones (one that runs
    off the band lands on coefficient 63)."""
    zz = _ZZX
    p1, m1 = 1 << al, -1 << al
    p = 0
    eobrun = 0
    for n, unit in enumerate(units):
        base = unit[0][1]
        k = ss
        if not eobrun:
            while k <= se:
                e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += (e >> 8) & 31
                s = e & 15
                r = (e >> 4) & 15
                if s:                  # a size other than 1 only warns
                    s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & (
                            (1 << r) - 1)
                        p += r
                    break
                # pass the nonzero coefficients (a correction bit each)
                # and r zero ones; stop on the zero that s lands on
                while k <= se:
                    i = base + zz[k]
                    c = out[i]
                    if c:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                            c += p1 if c >= 0 else m1
                            out[i] = ((c + 32768) & 0xFFFF) - 32768
                        p += 1
                    elif r:
                        r -= 1
                    else:
                        break
                    k += 1
                if s:
                    out[base + zz[k]] = s
                k += 1
        if eobrun:
            # the rest of the band: correction bits only
            while k <= se:
                i = base + zz[k]
                c = out[i]
                if c:
                    if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                        c += p1 if c >= 0 else m1
                        out[i] = ((c + 32768) & 0xFFFF) - 32768
                    p += 1
                k += 1
            eobrun -= 1
        if p > end:
            return n + 1, p
    return len(units), p


def _resync(rd: _Reader, st, desired: int) -> None:
    """jdmarker.c jpeg_resync_to_restart, where the marker found at a
    restart boundary (st.unread) is not the RSTn expected."""
    m = st.unread
    while True:
        if m < 0xC0:                       # not a valid marker: scan on
            action = 2
        elif not 0xD0 <= m <= 0xD7:        # a valid marker other than RSTn
            action = 3
        elif m in (0xD0 + ((desired + 1) & 7), 0xD0 + ((desired + 2) & 7)):
            action = 3                     # one of the next two restarts
        elif m in (0xD0 + ((desired - 1) & 7), 0xD0 + ((desired - 2) & 7)):
            action = 2                     # a restart before it
        else:
            action = 1                     # take it as the one expected
        if action == 1:
            st.unread = None
            return
        if action == 3:                    # left in place: empty segments
            st.unread = m
            return
        m = rd.next_marker()


def _scan_setup(st, seg: tuple) -> tuple:
    """jdinput.c start_input_pass and the entropy decoder's start_pass for
    the scan whose header fields are `seg` (component entries, Ss, Se,
    Ah, Al): the components and their tables, checked as libjpeg checks
    them."""
    entries, ss, se, ah, al = seg
    chosen = []
    for cid, tables in entries:
        comp = next((c for c in st.comps if c.cid == cid), None)
        if comp is None or any(c is comp for c, _, _ in chosen):
            raise ValueError(f"JPEG scan names component {cid} wrongly")
        chosen.append((comp, tables >> 4, tables & 15))
    if len(chosen) > 1 and sum(c.h * c.v for c, _, _ in chosen) > 10:
        raise ValueError("JPEG scan with more than 10 blocks an MCU")
    for comp, _, _ in chosen:
        if comp.qt is None:
            if comp.tq not in st.qts:
                raise ValueError("JPEG component uses an undefined "
                                 "quantisation table")
            comp.qt = st.qts[comp.tq]
    if st.progressive:
        bad = se != 0 if ss == 0 else (ss > se or se > 63 or len(chosen) != 1)
        if bad or (ah and al != ah - 1) or al > 13:
            raise ValueError(f"JPEG progression of a scan with spectral "
                             f"selection {ss}-{se}, approximation {ah}/{al}")
        for comp, _, _ in chosen:
            for k in range(min(ss, 1), max(se, 9) + 1):
                comp.prev[k] = comp.bits[k] if st.scans > 1 else 0
            for k in range(ss, se + 1):
                comp.bits[k] = al
        need = [] if ss == 0 and ah else ["dc" if ss == 0 else "ac"]
    else:
        need = ["dc", "ac"]
    luts = []
    for comp, td, ta in chosen:
        row = []
        for kind in need:
            key = (kind, td if kind == "dc" else ta)
            if key not in st.huff:
                raise ValueError("JPEG scan uses an undefined Huffman table")
            row.append(st.lut(key))
        luts.append(row)
    return chosen, luts


def _scan(rd: _Reader, st, seg: tuple, single: bool) -> None:
    """Decode the scan whose header is `seg` from the reader's position,
    as libjpeg's entropy decoder reads it; `single` where it is the only
    scan of a sequential file (its rows are out when it ends, so data
    that ends the file after its last interval is not an error where the
    bit buffer never reads past it)."""
    chosen, luts = _scan_setup(st, seg)
    _, ss, se, ah, al = seg
    outs = [c.coef for c, _, _ in chosen]
    # every MCU of the scan in stream order, and its iMCU row
    units, rows = [], []
    if len(chosen) == 1:   # non-interleaved: the component's real blocks
        comp = chosen[0][0]
        for by in range(comp.brows):
            for bx in range(comp.bcols):
                units.append([(0, (by * comp.cols + bx) * 64)])
                rows.append(by // comp.v)
    else:
        my_n, mx_n = st.mcus
        offs = [[(slot, (by * c.cols + bx) * 64) for by in range(c.v)
                 for bx in range(c.h)]
                for slot, (c, _, _) in enumerate(chosen)]
        for my in range(my_n):
            for mx in range(mx_n):
                unit = []
                for slot, (c, _, _) in enumerate(chosen):
                    base = (my * c.v * c.cols + mx * c.h) * 64
                    unit += [(s, base + o) for s, o in offs[slot]]
                units.append(unit)
                rows.append(my)

    if not st.progressive:
        def run(win, end, part):
            return _sequential(win, end, part, [t[0] for t in luts],
                               [t[1] for t in luts], outs)
    elif ss == 0 and ah == 0:
        def run(win, end, part):
            return _dc_first(win, end, part, [t[0] for t in luts], outs, al)
    elif ss == 0:
        def run(win, end, part):
            return _dc_refine(win, end, part, outs, al)
    else:
        decode = _ac_refine if ah else _ac_first

        def run(win, end, part):
            return decode(win, end, part, luts[0][0], outs[0], ss, se, al)

    per = st.restart or len(units)
    pad = 256 * max(len(u) for u in units)
    count = -(-len(units) // per)
    insufficient, next_rst = False, 0
    for i in range(count):
        if i:                                   # process_restart
            if st.unread is None:
                st.unread = rd.next_marker()
            if st.unread == 0xD0 + next_rst:
                st.unread = None
            else:
                _resync(rd, st, next_rst)
            next_rst = (next_rst + 1) & 7
            if st.unread is None:
                insufficient = False
        part = units[i * per:(i + 1) * per]
        if insufficient:
            continue
        if st.unread is not None:               # up against a marker
            raw = b""
        else:
            raw, st.unread = rd.segment()
            if st.unread is None and not (single and i == count - 1):
                raise _Suspend()
        win = _windows(raw, pad)
        end = 8 * len(raw)
        done, p = run(win, end, part)
        st.last_good = rows[i * per + done - 1]
        insufficient = p > end
        if st.unread is None and (insufficient or (
                p + 57 > end and _fill_reaches_end(
                    win, len(raw), part, [t[0] for t in luts],
                    [t[1] for t in luts]))):
            raise _Suspend()


def muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b / 255 rounded as Pillow's MULDIV255 rounds it."""
    t = a.astype(np.int32) * b.astype(np.int32) + 128
    return ((t >> 8) + t) >> 8


def _colour(planes: list, jfif: bool, adobe,
            ycck: bool = True) -> np.ndarray:
    """(h, w, 3) uint8 of the component planes, converted as libjpeg's
    colour-space guess (jdapimin.c default_decompress_parms) and PIL's
    mode for the component count convert them. Where `ycck` is False,
    four components are CMYK whatever the Adobe marker says (PIL's BLP
    plugin asks libjpeg for a CMYK stream)."""
    if len(planes) == 1:
        return np.repeat(planes[0][0][..., None], 3, axis=2)
    if len(planes) == 3:
        cids = [p[1] for p in planes]
        rgb = not jfif and (adobe == 0 or (adobe is None
                                           and cids == [82, 71, 66]))
        planes = [p[0] for p in planes]
        return np.stack(planes, -1) if rgb else ycc_to_rgb(*planes)
    # four components: CMYK (Adobe transform 0, or no Adobe marker) or
    # YCCK (any other transform), which libjpeg turns into CMYK as
    # 255 - its YCbCr to RGB conversion, K passed on; PIL reads the
    # samples as inverted ("CMYK;I") and converts CMYK to RGB as
    # (255 - C)(255 - K) / 255, so each channel is sample * K / 255
    c, m, y, k = (p[0] for p in planes)
    if adobe not in (None, 0) and ycck:
        c, m, y = np.moveaxis(255 - ycc_to_rgb(c, m, y).astype(np.int32),
                              -1, 0)
    return np.stack([muldiv255(v, k) for v in (c, m, y)],
                    -1).astype(np.uint8)


class _Stream:
    """What the markers of a JPEG stream (and of the tables stream before
    it, where there is one) have set, and libjpeg's reading state."""

    def __init__(self):
        self.qts, self.huff, self.restart = {}, {}, 0
        self.comps = self.size = self.mcus = None
        self.progressive, self.jfif, self.adobe = False, False, None
        self.saw_soi = self.saw_sof = False
        self.unread = None      # a marker read and not yet processed
        self.scans = 0          # libjpeg's input_scan_number
        self.last_good = 0      # last_good_iMCU_row
        self._luts = {}

    def lut(self, key) -> list:
        """The derived table of Huffman table `key` as it stands now."""
        counts, symbols = self.huff[key]
        k = (key[0], counts, symbols)
        if k not in self._luts:
            self._luts[k] = _huffman_lut(counts, symbols, key[0] == "dc")
        return self._luts[k]


def _frame(rd: _Reader, st, m: int) -> None:
    """jdmarker.c get_sof, and the port's limits."""
    if st.saw_sof:
        raise ValueError("JPEG stream with a second frame header")
    length = rd.u16()
    bits, h, w, nf = rd.byte(), rd.u16(), rd.u16(), rd.byte()
    if m in _MODES:
        raise NotImplementedError(
            f"{_MODES[m]} JPEG is not decoded by the port (Huffman-"
            f"coded sequential and progressive only)")
    if bits != 8:
        raise NotImplementedError(
            f"JPEG with {bits}-bit samples is not decoded by the port "
            f"(8-bit only)")
    if h == 0 or w == 0 or nf == 0:
        raise ValueError(f"JPEG frame of {w}x{h} samples")
    if length - 8 != 3 * nf:
        raise ValueError("JPEG frame header of a wrong length")
    if nf not in (1, 2, 3, 4):
        raise NotImplementedError(
            f"{nf}-component JPEG is not decoded by the port (1, 3 or 4 "
            f"components)")
    seg = rd.read(3 * nf)
    bomb.check("JPEG", w, h)
    st.progressive = m == 0xC2
    comps = [_Component(j, seg[3 * j], seg[3 * j + 1] >> 4,
                        seg[3 * j + 1] & 15, seg[3 * j + 2])
             for j in range(nf)]
    if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 for c in comps):
        raise ValueError("JPEG sampling factors outside 1-4")
    if nf == 1:          # one component: its MCU is one block
        comps[0].h = comps[0].v = 1
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    st.mcus = (-(-h // (8 * vmax)), -(-w // (8 * hmax)))
    for c in comps:
        if hmax % c.h or vmax % c.v or hmax // c.h > 2 or vmax // c.v > 2:
            raise NotImplementedError(
                f"JPEG chroma sampling {c.h}x{c.v} against {hmax}x{vmax} "
                f"is not decoded by the port")
        c.rows, c.cols = st.mcus[0] * c.v, st.mcus[1] * c.h
        c.height = -(-h * c.v // vmax)
        c.width = -(-w * c.h // hmax)
        c.brows, c.bcols = -(-c.height // 8), -(-c.width // 8)
        c.coef = [0] * (c.rows * c.cols * 64)
    st.comps, st.size, st.saw_sof = comps, (h, w), True


def _tables(rd: _Reader, st, m: int) -> None:
    """jdmarker.c get_dqt, get_dht, get_dri and get_dac."""
    length = rd.u16() - 2
    if m == 0xDB:                                   # DQT
        while length > 0:
            n = rd.byte()
            if n & 15 > 3:
                raise ValueError("JPEG quantisation table index past 3")
            wide = n >> 4
            vals = np.frombuffer(rd.read(128 if wide else 64),
                                 ">u2" if wide else np.uint8)
            qt = np.zeros(64, np.int64)
            qt[list(ZIGZAG)] = vals
            st.qts[n & 15] = qt
            length -= 129 if wide else 65
    elif m == 0xC4:                                 # DHT
        while length > 16:
            index = rd.byte()
            counts = tuple(rd.read(16))
            length -= 17
            if sum(counts) > 256 or sum(counts) > length:
                raise ValueError("JPEG Huffman table with too many codes")
            symbols = rd.read(sum(counts))
            length -= len(symbols)
            kind = "ac" if index & 0x10 else "dc"
            index &= ~0x10
            if index > 3:
                raise ValueError("JPEG Huffman table index past 3")
            st.huff[(kind, index)] = (counts, symbols)
    elif m == 0xDD:                                 # DRI
        if length != 2:
            raise ValueError("JPEG restart interval of a wrong length")
        st.restart = rd.u16()
        return
    else:                                           # DAC
        while length > 0:
            index, val = rd.byte(), rd.byte()
            length -= 2
            if index > 31 or (index < 16 and val & 15 > val >> 4):
                raise ValueError("JPEG arithmetic-coding table out of "
                                 "range")
    if length != 0:
        raise ValueError("JPEG table segment of a wrong length")


def _markers(rd: _Reader, st) -> tuple:
    """jdmarker.c read_markers: read markers (the SOI first) up to the
    next SOS, returned as ("sos", its header fields), or EOI, ("eoi",
    None)."""
    while True:
        if st.unread is None:
            if not st.saw_soi:
                if rd.byte() != 0xFF or rd.byte() != 0xD8:
                    raise ValueError("not a JPEG stream")
                st.unread = 0xD8
            else:
                st.unread = rd.next_marker()
        m = st.unread
        if m == 0xD8:                                   # SOI
            if st.saw_soi:
                raise ValueError("JPEG stream with a second SOI")
            st.saw_soi = True
            st.restart, st.jfif, st.adobe = 0, False, None
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            _frame(rd, st, m)
        elif m == 0xC8 or 0xF0 <= m <= 0xFD or m == 0xDE or m == 0xDF \
                or 0x02 <= m <= 0xBF:
            raise ValueError(f"JPEG marker 0x{m:02X} libjpeg does not take")
        elif m == 0xDA:                                 # SOS
            if not st.saw_sof:
                raise ValueError("JPEG scan before its frame header")
            length, n = rd.u16(), rd.byte()
            if length != 2 * n + 6 or not 1 <= n <= 4:
                raise ValueError("JPEG scan header of a wrong length")
            b = rd.read(2 * n + 3)
            st.unread = None
            st.scans += 1
            return "sos", ([(b[2 * j], b[2 * j + 1]) for j in range(n)],
                           b[2 * n], b[2 * n + 1], b[2 * n + 2] >> 4,
                           b[2 * n + 2] & 15)
        elif m == 0xD9:                                 # EOI
            st.unread = None
            return "eoi", None
        elif m in (0xC4, 0xCC, 0xDB, 0xDD):
            _tables(rd, st, m)
        elif m in (0xE0, 0xEE):       # JFIF and Adobe (the first 14 bytes)
            length = rd.u16() - 2
            head = rd.read(min(max(length, 0), 14))
            if m == 0xE0 and length >= 14 and head.startswith(b"JFIF\0"):
                st.jfif = True
            if m == 0xEE and length >= 12 and head.startswith(b"Adobe"):
                st.adobe = head[11]
            rd.skip(length - len(head))
        elif 0xE0 <= m <= 0xEF or m in (0xFE, 0xDC):   # APPn, COM, DNL
            rd.skip(rd.u16() - 2)
        # RSTn and TEM have no parameters
        st.unread = None


def _smoothing_ok(comps) -> bool:
    """jdcoefct.c smoothing_ok: every component's quantisation values of
    the first ten zig-zag coefficients are nonzero and its DC is known,
    and some component's first ten are not fully known."""
    useful = False
    for c in comps:
        if c.qt is None or not all(c.qt[ZIGZAG[k]] for k in range(10)) \
                or c.bits[0] < 0:
            return False
        useful |= any(c.bits[1:10])
    return useful


# decompress_smooth_data's estimates, in the order it makes them: (the
# zig-zag index of the coefficient, the weights of the 5x5 DC values
# (rows above to below, columns left to right) when no AC coefficient of
# the component was sent, the weights otherwise (None: the estimate is
# made only in the first case))
def _w(*rows):
    return np.array(rows, np.int64)


_SMOOTH = (
    (1, _w((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3),
           (-3, 13, 0, -13, 3), (-1, -1, 0, 1, 1)),
     _w((0,) * 5, (0,) * 5, (-7, 50, 0, -50, 7), (0,) * 5, (0,) * 5)),
    (2, _w((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), (0,) * 5,
           (1, -13, -38, -13, 1), (1, 3, 3, 3, 1)),
     _w((0, 0, -7, 0, 0), (0, 0, 50, 0, 0), (0,) * 5, (0, 0, -50, 0, 0),
        (0, 0, 7, 0, 0))),
    (3, _w((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0),
           (0, 2, 7, 2, 0), (0, 0, 1, 0, 0)),
     _w((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0),
        (0, 0, 13, 0, 0), (0, 0, -1, 0, 0))),
    (4, _w((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), (0,) * 5, (0, -9, 0, 9, 0),
           (1, 0, 0, 0, -1)),
     _w((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), (0,) * 5, (1, -10, 0, 10, -1),
        (0, 1, 0, -1, 0))),
    (5, _w((0,) * 5, (0, 2, -5, 2, 0), (1, 7, -14, 7, 1), (0, 2, -5, 2, 0),
           (0,) * 5),
     _w((0,) * 5, (0,) * 5, (-1, 13, -24, 13, -1), (0,) * 5, (0,) * 5)),
    (6, _w((0,) * 5, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0),
           (0,) * 5), None),
    (7, _w((0,) * 5, (0, 1, -3, 1, 0), (0,) * 5, (0, -1, 3, -1, 0),
           (0,) * 5), None),
    (8, _w((0,) * 5, (0, 1, 0, -1, 0), (0, -3, 0, 3, 0), (0, 1, 0, -1, 0),
           (0,) * 5), None),
    (9, _w((0,) * 5, (0, 1, 2, 1, 0), (0,) * 5, (0, -1, -2, -1, 0),
           (0,) * 5), None),
)
# the smoothed DC when no AC coefficient was sent: weights summing to 256
_SMOOTH_DC = _w((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6),
                (-8, 42, 152, 42, -8), (-6, 6, 42, 6, -6),
                (-2, -6, -8, -6, -2))


def _smooth(c, coef: np.ndarray, total: int, last_good: int,
            scans: int) -> np.ndarray:
    """libjpeg-turbo's decompress_smooth_data on the real blocks of
    component c ((brows, bcols, 64) of its coefficient array `coef`, which
    holds the MCU padding too): a copy with its missing low coefficients
    estimated. The row above and below each block row are read as libjpeg
    reads them: clamped to the image in the first iMCU rows, while in the
    last iMCU row a component of fewer real block rows than its sampling
    factor counts rows as if each iMCU row held that many, and the row
    after a block row of the iMCU row before it may be MCU padding."""
    H, W, v = c.brows, c.bcols, c.v
    r = np.arange(H)
    big = r // v < total - 1
    k = H % v or v
    ibr = np.where(big, r, (r // v) * k + r % v)
    ibrs = np.where(big, v * total, k * total)
    prev = np.where(ibr > 0, r - 1, r)
    pp = np.where(ibr > 1, r - 2, prev)
    nxt = np.where(ibr < ibrs - 1, r + 1, r)
    nn = np.where(ibr < ibrs - 2, r + 2, nxt)
    cols = np.arange(W)
    dc = coef[:, :, 0]
    grid = [[dc[rr][:, np.clip(cols + d, 0, W - 1)] for d in (-2, -1, 0, 1, 2)]
            for rr in (pp, prev, r, nxt, nn)]
    grid = np.stack([np.stack(g) for g in grid])           # (5, 5, H, W)
    cur = np.array(c.bits[:10])
    old = np.array(c.prev[:10]) if scans > 1 else np.full(10, -1)
    bits = np.where((r // v > last_good)[:, None], old, cur)   # (H, 10)
    change_dc = (bits[:, 1:] == -1).all(axis=1)[:, None]
    q = [int(c.qt[ZIGZAG[i]]) for i in range(10)]
    ws = coef[:H, :W].copy()

    def estimate(weights, qk, al, limit):
        num = q[0] * np.einsum("ab,abhw->hw", weights, grid)
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if limit:
            pred = np.where((al > 0) & (pred >= (1 << np.maximum(al, 0))),
                            (1 << np.maximum(al, 0)) - 1, pred)
        return np.where(num >= 0, pred, -pred)

    for i, both, own in _SMOOTH:
        pos = ZIGZAG[i]
        al = bits[:, i][:, None]
        pred = estimate(both, q[i], al, True)
        if own is not None:
            pred = np.where(change_dc, pred, estimate(own, q[i], al, True))
        use = (al != 0) & (ws[:, :, pos] == 0)
        if own is None:
            use &= change_dc
        ws[:, :, pos] = np.where(use, _w16(pred), ws[:, :, pos])
    ws[:, :, 0] = np.where(change_dc, _w16(estimate(_SMOOTH_DC, q[0], 0,
                                                     False)), ws[:, :, 0])
    return ws


def decode_planes(data: bytes, tables: bytes = b"", tiff: bool = False
                  ) -> tuple:
    """The decoded component planes of a JPEG stream, before any colour
    conversion: ([((H, W) int array, component id), ...], JFIF marker seen,
    Adobe transform or None). Each plane is upsampled to the frame's size
    as libjpeg upsamples it. `tables` is a stream of tables only (the
    JPEGTables of a JPEG-compressed TIFF), read before `data`, which may
    then be an abbreviated stream; `tiff` reads the data as libtiff's
    source hands it to libjpeg (a fake EOI past its end)."""
    st = _Stream()
    if tables:
        if _markers(_Reader(tables, tiff), st)[0] != "eoi":
            raise ValueError("JPEG tables stream holding a scan")
        if st.saw_sof:
            raise ValueError("JPEG tables stream holding a frame header")
        st.saw_soi = False
    rd = _Reader(data, tiff)
    kind, seg = _markers(rd, st)
    if kind == "eoi":
        raise ValueError("JPEG stream without an image")
    if not st.progressive:          # jinit_huff_decoder's std_huff_tables
        for key, table in _STD.items():
            st.huff.setdefault(key, table)
    comps = st.comps
    multi = st.progressive or len(seg[0]) < len(comps)
    _scan(rd, st, seg, not multi)
    try:
        while True:
            kind, seg = _markers(rd, st)
            if kind == "eoi":
                break
            if not multi:
                raise ValueError("JPEG sequential stream with a second scan "
                                 "after its image")
            _scan(rd, st, seg, False)
    except ValueError as e:
        # a single scan's rows are out: Pillow's decoder stops where its
        # data ends, and libtiff's TIFFjpeg_finish_decompress takes any
        # failure of jpeg_finish_decompress for success
        if multi or not (tiff or isinstance(e, _Suspend)):
            raise

    h, w = st.size
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    smooth = st.progressive and _smoothing_ok(comps)
    planes = []
    for c in comps:
        coef = np.asarray(c.coef, np.int64).reshape(c.rows, c.cols, 64)
        if smooth:
            blocks = _smooth(c, coef, st.mcus[0], st.last_good, st.scans)
        else:
            blocks = coef[:c.brows, :c.bcols]
        qt = c.qt if c.qt is not None else np.zeros(64, np.int64)
        px = idct_islow(blocks.reshape(-1, 64), qt)
        plane = px.reshape(c.brows, c.bcols, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.brows * 8, c.bcols * 8)[:c.height, :c.width]
        planes.append((upsample(plane, hmax // c.h, vmax // c.v)[:h, :w],
                       c.cid))
    return planes, st.jfif, st.adobe


def decode_jpeg(data: bytes, ycck: bool = True) -> np.ndarray:
    """(H, W, 3) uint8 of a Huffman-coded JPEG (sequential or
    progressive), PIL's `convert("RGB")` of it byte for byte (four
    components taken as CMYK whatever the Adobe marker says where `ycck`
    is False)."""
    planes, jfif, adobe = decode_planes(data)
    if len(planes) == 2:
        raise NotImplementedError("2-component JPEG is not decoded by the "
                                  "port (1, 3 or 4 components)")
    return _colour(planes, jfif, adobe, ycck)
