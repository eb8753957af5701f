"""WebP lossless (VP8L) decoding, equal to libwebp's decode.

The WebP Lossless Bitstream Specification (RFC 9649, section 3), as
libwebp reads it: a 5-byte header (the signature 0x2f, 14 bits each of
width - 1 and height - 1, the alpha hint and a 3-bit version, 0), then
the transforms, each at most once:

* predictor: a sub-image of one mode a tile (its green & 15); 14 modes
  over L, T, TL and TR (the current row's first pixel for the last
  column; libwebp's modes 14 and 15 are mode 0), pixel 0 predicted by
  0xff000000, the rest of the top row by L and the left column by T;
  Select keeps T where the Manhattan distances tie, and
  ClampAddSubtractHalf halves by C's division, toward zero;
* cross-colour: a sub-image of three signed 8-bit multipliers a tile
  (green to red, green to blue, red to blue), each delta the product
  `>> 5`;
* subtract-green: red and blue hold their difference from green;
* colour indexing: a palette of 1 to 256 colours, delta coded, whose
  indices pack 8, 4 or 2 to a byte where it has 2, 4 or 16 colours at
  most; an index past the palette is transparent black.

Each image (the main one and every sub-image) is an optional colour
cache (1 to 11 bits, hash multiplier 0x1e35a7bd), for the main image an
optional entropy image of meta prefix codes, and a group of five
canonical prefix codes a meta code (green with the 24 length codes and
the cache, red, blue, alpha, distance). A code is the simple form (one
or two symbols of 1 or 8 bits; one symbol reads no bits) or the normal
one: up to 19 code-length-code lengths in a fixed order, an optional
max_symbol, then lengths with repeat codes 16 (the last non-zero length,
8 at first), 17 and 18 (zeros). A code must be complete unless it holds
one symbol. LZ77 back-references take a distance through the 120-entry
map of short 2D offsets.

`decode_alpha` reads the same stream, without its 5-byte header, from a
WebP file's lossless ALPH chunk; libwebp decodes a plane whose only
transform is colour indexing, with no colour cache, a byte a pixel, and
there lets the last pixel's read run past the end.

The literal and back-reference stream is decoded in a Python loop (the
bits read through a table of 64-bit windows, each code through one
table of its longest length); the transforms run in numpy, but the
predictor, whose L makes each pixel wait for its left neighbour, runs a
pixel at a time on packed ARGB. Malformed data raises ValueError.
"""
from __future__ import annotations

import numpy as np

SIGNATURE = 0x2F
NUM_LITERALS = 256
NUM_LENGTHS = 24
NUM_DISTANCES = 40
# the order in which code-length-code lengths are read
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)
# distance codes 1..120: (dx, dy) of the pixel copied from, as x + y * width
DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
CACHE_MULT = 0x1E35A7BD
MAX_CACHE_BITS = 11
MAX_CODE_LENGTH = 15


class _Bits:
    """LSB-first bits of a stream: win[byte] is the 64 bits from that byte
    on (zeros past the end, for 16 windows: more than one symbol or one
    read takes). libwebp fails a stream as soon as its reads pass the
    end, and so does `check`."""

    def __init__(self, data: bytes):
        n = len(data)
        a = np.frombuffer(bytes(data) + bytes(24), np.uint8).astype(
            np.uint64)
        w = np.zeros(n + 16, np.uint64)
        for k in range(8):
            w |= a[k:k + n + 16] << np.uint64(8 * k)
        self.win = w.tolist()
        self.end = 8 * n
        self.pos = 0

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        self.check()
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.pos > self.end:
            raise ValueError("VP8L data ends early")


def _table(lengths) -> tuple:
    """(entries, mask) of a canonical prefix code: entry[the next bits &
    mask] is symbol << 4 | its length. A code of one symbol reads no
    bits; any other must be complete."""
    lengths = np.asarray(lengths, np.int64)
    syms = np.flatnonzero(lengths)
    if len(syms) == 0:
        raise ValueError("VP8L prefix code has no symbols")
    if len(syms) == 1:
        return [int(syms[0]) << 4], 0
    count = np.bincount(lengths[syms], minlength=MAX_CODE_LENGTH + 1)
    left = 1
    for n in range(1, MAX_CODE_LENGTH + 1):
        left = 2 * left - int(count[n])
        if left < 0:
            raise ValueError("VP8L prefix code is over-subscribed")
    if left:
        raise ValueError("VP8L prefix code is incomplete")
    top = int(lengths.max())
    order = syms[np.lexsort((syms, lengths[syms]))]
    table = np.zeros(1 << top, np.int64)
    code = 0
    prev = int(lengths[order[0]])
    for s in order.tolist():
        n = int(lengths[s])
        code <<= n - prev
        prev = n
        rev = int(f"{code:0{n}b}"[::-1], 2)
        table[rev::1 << n] = s << 4 | n
        code += 1
    return table.tolist(), (1 << top) - 1


def _read_code(br: _Bits, size: int) -> tuple:
    """One prefix code of an alphabet of `size` symbols."""
    lengths = [0] * max(size, 256)
    if br.read(1):                                   # simple
        two = br.read(1)
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if two:
            lengths[br.read(8)] = 1
        br.check()
        return _table(lengths[:size])
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[CODE_LENGTH_ORDER[i]] = br.read(3)
    ctab, cmask = _table(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > size:
            raise ValueError("VP8L max_symbol exceeds the alphabet")
    else:
        max_symbol = size
    lengths = [0] * size
    s, prev = 0, 8
    win = br.win
    while s < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        br.check()
        p = br.pos
        e = ctab[(win[p >> 3] >> (p & 7)) & cmask]
        br.pos = p + (e & 15)
        v = e >> 4
        if v < 16:
            lengths[s] = v
            s += 1
            if v:
                prev = v
        else:
            extra, base = ((2, 3), (3, 3), (7, 11))[v - 16]
            rep = br.read(extra) + base
            if s + rep > size:
                raise ValueError("VP8L code lengths repeat past the "
                                 "alphabet")
            lengths[s:s + rep] = [prev if v == 16 else 0] * rep
            s += rep
    br.check()
    return _table(lengths)


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_image(br: _Bits, w: int, h: int, main: bool,
                  lax: bool = False) -> list:
    """The packed ARGB pixels (a list of w * h ints) of an entropy-coded
    image: a sub-image, or the main image with its meta prefix codes.
    `lax`: an alpha plane under colour indexing alone, which libwebp
    decodes a byte a pixel where it has no colour cache and red, blue
    and alpha read no bits, and then lets the last pixel's read run past
    the end."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= MAX_CACHE_BITS:
            raise ValueError(f"VP8L colour cache of {cache_bits} bits")
    meta, meta_bits, meta_w = None, 0, 1
    if main and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = _subsample(w, meta_bits)
        meta = [(p >> 8) & 0xFFFF for p in _decode_image(
            br, meta_w, _subsample(h, meta_bits), False)]
    n_groups = max(meta) + 1 if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    sizes = (NUM_LITERALS + NUM_LENGTHS + cache_size, NUM_LITERALS,
             NUM_LITERALS, NUM_LITERALS, NUM_DISTANCES)
    groups = [[c for s in sizes for c in _read_code(br, s)]
              for _ in range(n_groups)]
    lax = lax and not cache_bits and all(
        g[3] == g[5] == g[7] == 0 for g in groups)
    return _lz77(br, w, h, groups, meta, meta_bits, meta_w, cache_bits, lax)


def _extra(sym: int, br: _Bits) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if sym < 4:
        return sym + 1
    n = (sym - 2) >> 1
    return ((2 + (sym & 1)) << n) + br.read(n) + 1


def _lz77(br, w, h, groups, meta, meta_bits, meta_w, cache_bits,
          lax) -> list:
    total = w * h
    out = [0] * total
    win = br.win
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    dist_of = [dx + dy * w for dx, dy in DISTANCE_MAP]
    g = groups[0]
    i = x = y = 0
    end = br.end
    while i < total:
        if meta is not None:
            g = groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        p = br.pos
        if p > end:
            raise ValueError("VP8L data ends early")
        e = g[0][(win[p >> 3] >> (p & 7)) & g[1]]
        p += e & 15
        code = e >> 4
        if code < NUM_LITERALS:
            r = g[2][(win[p >> 3] >> (p & 7)) & g[3]]
            p += r & 15
            b = g[4][(win[p >> 3] >> (p & 7)) & g[5]]
            p += b & 15
            a = g[6][(win[p >> 3] >> (p & 7)) & g[7]]
            br.pos = p + (a & 15)
            px = (a >> 4) << 24 | (r >> 4) << 16 | code << 8 | (b >> 4)
            out[i] = px
            if cache is not None:
                cache[((px * CACHE_MULT) & 0xFFFFFFFF) >> shift] = px
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
        elif code < NUM_LITERALS + NUM_LENGTHS:
            br.pos = p
            length = _extra(code - NUM_LITERALS, br)
            p = br.pos
            d = g[8][(win[p >> 3] >> (p & 7)) & g[9]]
            br.pos = p + (d & 15)
            dcode = _extra(d >> 4, br)
            dist = (max(dist_of[dcode - 1], 1) if dcode <= 120
                    else dcode - 120)
            if dist > i or length > total - i:
                raise ValueError("VP8L back-reference outside the image")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                out[i:i + length] = (out[i - dist:i]
                                     * (length // dist + 1))[:length]
            if cache is not None:
                for px in out[i:i + length]:
                    cache[((px * CACHE_MULT) & 0xFFFFFFFF) >> shift] = px
            i += length
            x += length
            while x >= w:
                x -= w
                y += 1
        else:
            br.pos = p
            px = cache[code - NUM_LITERALS - NUM_LENGTHS]
            out[i] = px
            cache[((px * CACHE_MULT) & 0xFFFFFFFF) >> shift] = px
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
    if not lax:
        br.check()
    return out


# ---------------------------------------------------------------------------
# the inverse transforms
# ---------------------------------------------------------------------------

def _add(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _select(t: int, left: int, tl: int) -> int:
    d = 0
    for s in (24, 16, 8, 0):
        c = (tl >> s) & 0xFF
        d += abs(((left >> s) & 0xFF) - c) - abs(((t >> s) & 0xFF) - c)
    return t if d <= 0 else left


def _full(left: int, t: int, tl: int) -> int:
    return sum(_clip(((left >> s) & 0xFF) + ((t >> s) & 0xFF)
                     - ((tl >> s) & 0xFF)) << s for s in (24, 16, 8, 0))


def _half(a: int, b: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        ca = (a >> s) & 0xFF
        d = ca - ((b >> s) & 0xFF)
        out |= _clip(ca + (d // 2 if d >= 0 else -(-d // 2))) << s
    return out


def _unpredict(res: list, w: int, h: int, bits: int, modes: list) -> list:
    """Undo the predictor transform on packed ARGB residuals."""
    out = [0] * (w * h)
    prev = 0xFF000000
    for x in range(w):
        prev = out[x] = _add(res[x], prev)
    tw = _subsample(w, bits)
    for y in range(1, h):
        base = y * w
        row = modes[(y >> bits) * tw:(y >> bits) * tw + tw]
        left = out[base] = _add(res[base], out[base - w])
        for x in range(1, w):
            i = base + x
            m = row[x >> bits]
            t = out[i - w]
            if m == 1:
                pred = left
            elif m == 2:
                pred = t
            elif m == 3:
                pred = out[i - w + 1]
            elif m == 4:
                pred = out[i - w - 1]
            elif m == 5:
                pred = _avg(_avg(left, out[i - w + 1]), t)
            elif m == 6:
                pred = _avg(left, out[i - w - 1])
            elif m == 7:
                pred = _avg(left, t)
            elif m == 8:
                pred = _avg(out[i - w - 1], t)
            elif m == 9:
                pred = _avg(t, out[i - w + 1])
            elif m == 10:
                pred = _avg(_avg(left, out[i - w - 1]),
                            _avg(t, out[i - w + 1]))
            elif m == 11:
                pred = _select(t, left, out[i - w - 1])
            elif m == 12:
                pred = _full(left, t, out[i - w - 1])
            elif m == 13:
                pred = _half(_avg(left, t), out[i - w - 1])
            else:                                    # 0, and 14 and 15
                pred = 0xFF000000
            left = out[i] = _add(res[i], pred)
    return out


def _tiles(img: np.ndarray, sub: np.ndarray, bits: int) -> np.ndarray:
    """The sub-image's pixel over each pixel of img (its tile's)."""
    h, w = img.shape
    return np.repeat(np.repeat(sub, 1 << bits, 0), 1 << bits, 1)[:h, :w]


def _signed(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.int64) & 0xFF) ^ 0x80) - 0x80


def _uncross(img: np.ndarray, sub: np.ndarray, bits: int) -> np.ndarray:
    """Undo the cross-colour transform."""
    m = _tiles(img, sub, bits)
    g2r, g2b, r2b = _signed(m), _signed(m >> 8), _signed(m >> 16)
    green = _signed(img >> 8)
    red = ((img >> 16).astype(np.int64) + ((g2r * green) >> 5)) & 0xFF
    blue = (img.astype(np.int64) + ((g2b * green) >> 5)
            + ((r2b * _signed(red)) >> 5)) & 0xFF
    return ((img & np.uint32(0xFF00FF00)) | (red << 16).astype(np.uint32)
            | blue.astype(np.uint32))


def _add_green(img: np.ndarray) -> np.ndarray:
    """Undo the subtract-green transform."""
    g = (img >> 8) & 0xFF
    rb = ((img & np.uint32(0x00FF00FF)) + (g | (g << 16))) \
        & np.uint32(0x00FF00FF)
    return (img & np.uint32(0xFF00FF00)) | rb


def _unindex(img: np.ndarray, palette: np.ndarray, bits: int,
             w: int) -> np.ndarray:
    """Undo colour indexing: img's green bytes hold 1 << bits indices
    each, lowest bits first."""
    g = ((img >> 8) & 0xFF).astype(np.int64)
    if bits:
        per = 1 << bits
        depth = 8 >> bits
        shifts = np.arange(per) * depth
        g = ((g[..., None] >> shifts) & ((1 << depth) - 1)).reshape(
            img.shape[0], -1)[:, :w]
    table = np.zeros(256, np.uint32)
    table[:len(palette)] = palette
    return table[g]


def _palette(raw: list) -> np.ndarray:
    """The colours of a delta-coded palette (each channel of entry i is
    the sum of the entries up to i, modulo 256)."""
    b = np.array(raw, np.uint32).view(np.uint8).reshape(-1, 4)
    return np.cumsum(b, 0, dtype=np.uint64).astype(np.uint8).reshape(
        -1).view(np.uint32).copy()


def header(data: bytes) -> tuple:
    """(width, height) of a VP8L bitstream's header."""
    if len(data) < 5 or data[0] != SIGNATURE:
        raise ValueError("not a VP8L bitstream")
    v = int.from_bytes(data[1:5], "little")
    if v >> 29:
        raise ValueError(f"VP8L version {v >> 29}")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1


def decode_vp8l(data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a VP8L bitstream (the payload of a WebP
    file's VP8L chunk)."""
    w, h = header(data)
    br = _Bits(data)
    br.pos = 40
    argb = _stream(br, w, h, False)
    return np.stack([(argb >> s) & 0xFF for s in (16, 8, 0, 24)],
                    -1).astype(np.uint8)


def decode_alpha(data: bytes, w: int, h: int) -> np.ndarray:
    """(H, W) uint8 of a lossless ALPH chunk's stream (after its header
    byte): a VP8L image without the VP8L header, its green the alpha
    (before the chunk's filter and levels, which cannot fail)."""
    return ((_stream(_Bits(data), w, h, True) >> 8) & 0xFF).astype(
        np.uint8)


def _stream(br: _Bits, w: int, h: int, alpha: bool) -> np.ndarray:
    """(H, W) uint32 ARGB of the transforms and image from br's
    position."""
    transforms = []
    xs = w
    while br.read(1):
        kind = br.read(2)
        if any(k == kind for k, *_ in transforms):
            raise ValueError("VP8L transform repeated")
        if kind in (PREDICTOR, CROSS_COLOR):
            bits = br.read(3) + 2
            sub = _decode_image(br, _subsample(xs, bits),
                                _subsample(h, bits), False)
            transforms.append((kind, xs, bits, sub))
        elif kind == COLOR_INDEXING:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            transforms.append((kind, xs, bits, _palette(
                _decode_image(br, n, 1, False))))
            xs = _subsample(xs, bits)
        else:
            transforms.append((kind, xs, 0, None))
    px = _decode_image(br, xs, h, True, alpha and [
        k for k, *_ in transforms] == [COLOR_INDEXING])
    for kind, tw, bits, sub in reversed(transforms):
        if kind == PREDICTOR:
            px = _unpredict(px, tw, h, bits, [(m >> 8) & 0xF for m in sub])
            continue
        img = np.array(px, np.uint32).reshape(h, -1)
        if kind == CROSS_COLOR:
            img = _uncross(img, np.array(sub, np.uint32).reshape(
                _subsample(h, bits), -1), bits)
        elif kind == SUBTRACT_GREEN:
            img = _add_green(img)
        else:
            img = _unindex(img, sub, bits, tw)
        px = img.reshape(-1).tolist()
    return np.array(px, np.uint32).reshape(h, w)
