"""Huffman-coded JPEG decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with PIL (rlshaders_tpu/scene/texture.py);
the card's image has no PIL, so the port decodes JPEG itself. It follows
what PIL asks of libjpeg-turbo by default, so that `decode_jpeg` returns
the bytes of `np.asarray(Image.open(path).convert("RGB"))`:

* the integer IDCT of jidctint.c (`JDCT_ISLOW`: CONST_BITS 13, PASS1_BITS
  2, its range-limit table);
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
  Pillow's MULDIV255.

Decoded: baseline, extended sequential and progressive Huffman frames
(SOF0, SOF1, SOF2) of 8-bit samples, 8- and 16-bit quantisation tables,
restart intervals, one, three or four components with chroma sampled
1x1, 2x1, 1x2 or 2x2 against the largest factors, interleaved or one
scan per component, any width and height. A progressive file keeps
whole-image coefficient planes across its scans (jdphuff.c: DC first, DC
refinement, AC first with end-of-band runs, AC refinement with its
correction bits; each scan reads its own Huffman tables, a component's
quantisation table is latched at its first scan). Lossless, hierarchical
and arithmetic-coded files, 12-bit samples, and progressive files whose
scans leave the low AC coefficients unrefined (libjpeg then smooths the
blocks, `do_block_smoothing`) raise NotImplementedError naming the mode;
malformed data raises ValueError.

The Huffman decode is sequential Python over a 16-bit lookahead table; the
IDCT, upsampling and colour conversion are numpy over all blocks at once.
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

# frame markers that start a mode the port does not decode
_MODES = {
    0xC3: "lossless",
    0xC5: "differential sequential (hierarchical)",
    0xC6: "differential progressive (hierarchical)",
    0xC7: "differential lossless (hierarchical)",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCC: "arithmetic-coded (DAC)",
    0xCD: "differential arithmetic-coded sequential",
    0xCE: "differential arithmetic-coded progressive",
    0xCF: "differential arithmetic-coded lossless",
}

# jidctint.c
CONST_BITS = 13
PASS1_BITS = 2
_FIX = {name: int(v * (1 << CONST_BITS) + 0.5) for name, v in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644),
    ("0_541196100", 0.541196100), ("0_765366865", 0.765366865),
    ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065),
    ("1_961570560", 1.961570560), ("2_053119869", 2.053119869),
    ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}


def _idct_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT range limit, indexed by (x & 1023) for a
    centred IDCT output x: x + 128 clamped to [0, 255] for |x| < 512."""
    x = np.arange(1024)
    x = np.where(x < 512, x, x - 1024)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_LIMIT = _idct_limit()


def _idct_1d(x, shift: int):
    """One jidctint.c pass over the eight inputs x[0..7] (arrays); returns
    the eight outputs descaled by `shift` bits."""
    f = _FIX
    z1 = (x[2] + x[6]) * f["0_541196100"]
    tmp2 = z1 - x[6] * f["1_847759065"]
    tmp3 = z1 + x[2] * f["0_765366865"]
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow of (N, 64) natural-order coefficients under the
    natural-order quantisation table qt (64,): (N, 8, 8) uint8 samples."""
    blk = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (the vertical frequencies of each column)
    ws = np.stack(_idct_1d([blk[:, k, :] for k in range(8)],
                           CONST_BITS - PASS1_BITS), axis=1)
    # pass 2: rows
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            CONST_BITS + PASS1_BITS + 3), axis=2)
    return _LIMIT[out & 1023]


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


def _huffman_lut(counts, symbols) -> list:
    """A 16-bit lookahead table: entry (length << 8) | symbol for every
    16-bit window whose leading bits are a code; 0 where none is."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG Huffman table with too many codes")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None        # latched at the component's first scan
        self.coef = None      # flat list of (rows * cols * 64) coefficients
        self.rows = self.cols = 0     # block grid, MCU-padded
        self.height = self.width = 0  # real samples
        # progressive: the approximation bit each zig-zag coefficient was
        # last sent at, -1 before its first scan (libjpeg's coef_bits)
        self.bits = [-1] * 64


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded data from `pos`, split at its restart markers:
    (segments, position of the marker that ends the scan)."""
    segs, start, i = [], pos, pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("JPEG scan runs past the end of the file")
        m = data[i + 1]
        if m == 0x00 or m == 0xFF:
            i += 1 if m == 0xFF else 2
            continue
        end = i
        while end > start and data[end - 1] == 0xFF:   # fill bytes
            end -= 1
        segs.append(data[start:end].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            start = i = i + 2
            continue
        return segs, i


def _windows(raw: bytes) -> list:
    """The 32 bits from every byte of `raw` on (zeros past its end): the
    bits from bit position p are read as win[p >> 3] << (p & 7)."""
    buf = np.frombuffer(raw + bytes(8), np.uint8).astype(np.int64)
    return (buf[:-3] << 24 | buf[1:-2] << 16 | buf[2:-1] << 8
            | buf[3:]).tolist()


def _bad_code():
    return ValueError("JPEG data holds an invalid Huffman code")


def _sequential(raw: bytes, blocks, dc_luts, ac_luts, outs) -> int:
    """Huffman-decode one restart interval of a sequential scan: `blocks`
    lists, in stream order, (component slot, coefficient offset) of every
    block; coefficients are written in natural order into outs[slot].
    Returns the bits read."""
    win = _windows(raw)
    zz = ZIGZAG
    pred = [0] * len(outs)
    p = 0
    for slot, base in blocks:
        out, dc, ac = outs[slot], dc_luts[slot], ac_luts[slot]
        e = dc[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if not e:
            raise _bad_code()
        p += e >> 8
        s = e & 0xFF
        if s:
            x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if x < 1 << (s - 1):
                x += 1 - (1 << s)
            pred[slot] += x
        out[base] = pred[slot]
        k = 1
        while k < 64:
            e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise _bad_code()
            p += e >> 8
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
        if k > 64:
            raise ValueError("JPEG block with more than 64 coefficients")
    return p


def _dc_first(raw: bytes, blocks, dc_luts, outs, al: int) -> int:
    """A progressive scan's first DC bits (jdphuff.c decode_mcu_DC_first):
    each block's DC difference, its running sum shifted up by `al`."""
    win = _windows(raw)
    pred = [0] * len(outs)
    p = 0
    for slot, base in blocks:
        e = dc_luts[slot][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if not e:
            raise _bad_code()
        p += e >> 8
        s = e & 0xFF
        if s:
            x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if x < 1 << (s - 1):
                x += 1 - (1 << s)
            pred[slot] += x
        outs[slot][base] = pred[slot] << al
    return p


def _dc_refine(raw: bytes, blocks, outs, al: int) -> int:
    """A DC refinement scan (decode_mcu_DC_refine): one raw bit a block,
    or'ed in at bit `al`."""
    bits = np.unpackbits(np.frombuffer(raw, np.uint8)).tolist()
    if len(blocks) > len(bits):
        raise ValueError("JPEG scan data ends early")
    one = 1 << al
    for (slot, base), b in zip(blocks, bits):
        if b:
            outs[slot][base] |= one
    return len(blocks)


def _ac_first(raw: bytes, blocks, ac, out, ss: int, se: int,
              al: int) -> int:
    """A progressive scan's first bits of AC coefficients ss..se of one
    component (decode_mcu_AC_first), with end-of-band runs that span
    blocks."""
    win = _windows(raw)
    zz = ZIGZAG
    p = 0
    eobrun = 0
    for _, base in blocks:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise _bad_code()
            p += e >> 8
            s = e & 15
            r = (e >> 4) & 15
            if s:
                k += r
                x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if x < 1 << (s - 1):
                    x += 1 - (1 << s)
                out[base + zz[k]] = x << al
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
    return p


def _ac_refine(raw: bytes, blocks, ac, out, ss: int, se: int,
               al: int) -> int:
    """An AC refinement scan of one component (decode_mcu_AC_refine): a
    correction bit for every coefficient of ss..se already nonzero, read
    as the walk passes it, and the coefficients that become nonzero at
    bit `al`, each placed after a run of still-zero ones."""
    win = _windows(raw)
    zz = ZIGZAG
    p1, m1 = 1 << al, -1 << al
    p = 0
    eobrun = 0
    for _, base in blocks:
        k = ss
        if not eobrun:
            while k <= se:
                e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise _bad_code()
                p += e >> 8
                s = e & 15
                r = (e >> 4) & 15
                if s:
                    if s != 1:
                        raise ValueError("JPEG refinement of a new "
                                         "coefficient by more than one bit")
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
                            out[i] = c + p1 if c >= 0 else c + m1
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
                        out[i] = c + p1 if c >= 0 else c + m1
                    p += 1
                k += 1
            eobrun -= 1
    return p


def _scan(data: bytes, pos: int, seg: bytes, comps, huff, restart: int,
          mcus: tuple, progressive: bool) -> int:
    """Decode the scan whose header is `seg`; returns the position after
    its entropy-coded data."""
    ns = seg[0]
    chosen = []
    for j in range(ns):
        cid, tables = seg[1 + 2 * j], seg[2 + 2 * j]
        comp = next((c for c in comps if c.cid == cid), None)
        if comp is None:
            raise ValueError(f"JPEG scan names unknown component {cid}")
        chosen.append((comp, tables >> 4, tables & 15))
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if not progressive and (ss, se, a) != (0, 63, 0):
        raise ValueError(f"sequential JPEG scan with spectral selection "
                         f"{ss}-{se} and approximation {a}")
    if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                        or (ss and ns != 1) or al > 13):
        raise ValueError(f"progressive JPEG scan of {ns} components with "
                         f"spectral selection {ss}-{se}, approximation "
                         f"{ah}/{al}")
    outs, luts = [], []
    for comp, td, ta in chosen:
        if not progressive:
            need = [("dc", td), ("ac", ta)]
        elif ss:
            need = [("ac", ta)]
        else:                   # a DC refinement reads no Huffman code
            need = [] if ah else [("dc", td)]
        if any(t not in huff for t in need):
            raise ValueError("JPEG scan uses an undefined Huffman table")
        luts.append([huff[t] for t in need])
        outs.append(comp.coef)
        for k in range(ss, se + 1):
            comp.bits[k] = al

    # every block of the scan in stream order, grouped by MCU
    units = []
    if ns == 1:      # non-interleaved: the component's real blocks in rows
        comp = chosen[0][0]
        for by in range(-(-comp.height // 8)):
            for bx in range(-(-comp.width // 8)):
                units.append([(0, (by * comp.cols + bx) * 64)])
    else:
        my_n, mx_n = mcus
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

    if not progressive:
        def run(raw, blocks):
            return _sequential(raw, blocks, [t[0] for t in luts],
                               [t[1] for t in luts], outs)
    elif ss == 0 and ah == 0:
        def run(raw, blocks):
            return _dc_first(raw, blocks, [t[0] for t in luts], outs, al)
    elif ss == 0:
        def run(raw, blocks):
            return _dc_refine(raw, blocks, outs, al)
    else:
        decode = _ac_refine if ah else _ac_first

        def run(raw, blocks):
            return decode(raw, blocks, luts[0][0], outs[0], ss, se, al)

    segments, end = _scan_segments(data, pos)
    per = restart or len(units)
    if len(segments) < -(-len(units) // per):
        raise ValueError("JPEG scan holds fewer restart intervals than "
                         "its MCUs need")
    for i, raw in enumerate(segments[:-(-len(units) // per)]):
        blocks = [b for unit in units[i * per:(i + 1) * per] for b in unit]
        if run(raw, blocks) > 8 * len(raw):
            raise ValueError("JPEG scan data ends early")
    return end


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
    it, where there is one) have set."""

    def __init__(self):
        self.qts, self.huff, self.restart = {}, {}, 0
        self.comps = self.size = self.mcus = None
        self.progressive, self.jfif, self.adobe = False, False, None


def _markers(data: bytes, st: _Stream) -> None:
    """Read the markers of one stream (SOI to EOI) into `st`, decoding its
    scans."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    pos = 2
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError("JPEG file ends before its EOI marker")
        m = data[pos]
        pos += 1
        if m == 0xD9:
            return
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise ValueError("JPEG file ends inside a marker")
        length = data[pos] << 8 | data[pos + 1]
        seg = data[pos + 2:pos + length]
        pos += length
        if m in _MODES:
            raise NotImplementedError(
                f"{_MODES[m]} JPEG is not decoded by the port (Huffman-"
                f"coded sequential and progressive only)")
        if m == 0xDB:                                   # DQT
            i = 0
            while i < len(seg):
                wide, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if wide else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n],
                                     ">u2" if wide else np.uint8)
                qt = np.zeros(64, np.int64)
                qt[list(ZIGZAG)] = vals
                st.qts[tq] = qt
                i += 1 + n
        elif m == 0xC4:                                 # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                n = sum(counts)
                st.huff[("ac" if tc else "dc", th)] = _huffman_lut(
                    counts, seg[i + 17:i + 17 + n])
                i += 17 + n
        elif m == 0xDD:                                 # DRI
            st.restart = seg[0] << 8 | seg[1]
        elif m in (0xC0, 0xC1, 0xC2):                   # SOF0, SOF1, SOF2
            bits, h, w, nf = seg[0], seg[1] << 8 | seg[2], \
                seg[3] << 8 | seg[4], seg[5]
            if bits != 8:
                raise NotImplementedError(
                    f"JPEG with {bits}-bit samples is not decoded by the "
                    f"port (8-bit only)")
            if nf not in (1, 2, 3, 4):
                raise NotImplementedError(
                    f"{nf}-component JPEG is not decoded by the port (1, 3 "
                    f"or 4 components)")
            if h == 0 or w == 0:
                raise ValueError(f"JPEG frame of {w}x{h} samples")
            bomb.check("JPEG", w, h)
            st.progressive = m == 0xC2
            comps = [_Component(seg[6 + 3 * j], seg[7 + 3 * j] >> 4,
                                seg[7 + 3 * j] & 15, seg[8 + 3 * j])
                     for j in range(nf)]
            if nf == 1:      # one component: its MCU is one block
                comps[0].h = comps[0].v = 1
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            st.mcus = (-(-h // (8 * vmax)), -(-w // (8 * hmax)))
            for c in comps:
                if hmax % c.h or vmax % c.v or hmax // c.h > 2 \
                        or vmax // c.v > 2:
                    raise NotImplementedError(
                        f"JPEG chroma sampling {c.h}x{c.v} against "
                        f"{hmax}x{vmax} is not decoded by the port")
                c.rows, c.cols = st.mcus[0] * c.v, st.mcus[1] * c.h
                c.height = -(-h * c.v // vmax)
                c.width = -(-w * c.h // hmax)
                c.coef = [0] * (c.rows * c.cols * 64)
            st.comps, st.size = comps, (h, w)
        elif m == 0xDA:                                 # SOS
            if st.comps is None:
                raise ValueError("JPEG scan before its frame header")
            for j in range(seg[0]):
                c = next((c for c in st.comps if c.cid == seg[1 + 2 * j]),
                         None)
                if c is not None and c.qt is None:
                    if c.tq not in st.qts:
                        raise ValueError("JPEG component uses an undefined "
                                         "quantisation table")
                    c.qt = st.qts[c.tq]
            try:
                pos = _scan(data, pos, seg, st.comps, st.huff, st.restart,
                            st.mcus, st.progressive)
            except IndexError as e:
                raise ValueError("corrupt JPEG scan data") from e
        elif m == 0xE0 and seg.startswith(b"JFIF\x00"):
            st.jfif = True
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            st.adobe = seg[11]


def decode_planes(data: bytes, tables: bytes = b"") -> tuple:
    """The decoded component planes of a JPEG stream, before any colour
    conversion: ([((H, W) int array, component id), ...], JFIF marker seen,
    Adobe transform or None). Each plane is upsampled to the frame's size
    as libjpeg upsamples it. `tables` is a stream of tables only (the
    JPEGTables of a JPEG-compressed TIFF), read before `data`, which may
    then be an abbreviated stream."""
    st = _Stream()
    if tables:
        _markers(tables, st)
    _markers(data, st)
    comps = st.comps
    if comps is None:
        raise ValueError("JPEG without a frame header")
    if any(c.qt is None for c in comps):
        raise ValueError("JPEG component without a scan")
    if st.progressive and all(c.bits[0] >= 0 for c in comps) and any(
            b != 0 for c in comps for b in c.bits[1:10]):
        # libjpeg's default do_block_smoothing (jdcoefct.c smoothing_ok)
        # then estimates the missing low AC coefficients from the
        # neighbouring blocks' DC values
        raise NotImplementedError(
            "progressive JPEG whose scans leave low AC coefficients "
            "unrefined (decoded with libjpeg's block smoothing) is not "
            "decoded by the port")

    h, w = st.size
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        blocks = idct_islow(np.asarray(c.coef, np.int64).reshape(-1, 64),
                            c.qt)
        plane = blocks.reshape(c.rows, c.cols, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.rows * 8, c.cols * 8)[:c.height, :c.width]
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
