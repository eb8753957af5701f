"""Write scenes/data/modes/: the textured scene's images in the image modes
the port decodes, and one texture at a size users ship.

Most files re-encode scenes/data/grid.png (256x256 RGB) or logo.png
(300x200 RGBA), each of four colours, so a lossless mode (a palette PNG,
a GIF, a 4- or 8-bit BMP, a TIFF, a 16-bit PNG holding v * 257, an Adam7
PNG) holds exactly their pixels. The grey modes hold PIL's grey of them.
`texture_2048.jpg` is a 2048x2048 progressive JPEG (quality 90, 4:2:0)
made by numpy from SEED: a smooth gradient with the grid's lines tiled
over it and the logo stamped at seeded places.

PIL writes what it can (JPEG, GIF, the 1-, 8- and 24-bit BMPs, the
PIL-compressed TIFFs); the writers below write the rest by hand: PNG at
any colour type, depth and interlace (`png_bytes`), TIFF with strips or
tiles, either planar configuration and byte order, LZW, PackBits or
Deflate, predictor 2 and 16-bit samples (`tiff_bytes`), BMP with RLE4,
RLE8, 16-bit, bitfields, top-down rows and OS/2 headers (`bmp_bytes`),
and GIF with local tables, an offset frame and interlaced rows
(`gif_bytes`). The tests use the same writers on seeded small images.

The SHA-256 of PIL's `convert("RGB")` of every file is printed as
MODE_DIGESTS; tests/test_torch_gpu.py and chip_smoke.py pin it.

    python tools/make_image_modes.py
"""
from __future__ import annotations

import hashlib
import io
import lzma
import os
import struct
import zlib

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DATA = os.path.join(ROOT, "scenes", "data")
MODES = os.path.join(DATA, "modes")
SEED = 10
BIG = 2048
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


# ---------------------------------------------------------------------------
# bits and LZW
# ---------------------------------------------------------------------------

def pack_rows(samples: np.ndarray, bits: int,
              big_endian: bool = True) -> np.ndarray:
    """(h, n) sample values as rows of bytes: sub-byte samples packed most
    significant bits first, each row padded to a byte; 16- and 32-bit
    samples in the given byte order."""
    h, n = samples.shape
    if bits in (16, 32):
        t = f"{'>' if big_endian else '<'}u{bits // 8}"
        return (samples & ((1 << bits) - 1)).astype(t).view(
            np.uint8).reshape(h, bits // 8 * n)
    if bits == 8:
        return samples.astype(np.uint8)
    shifts = np.arange(bits - 1, -1, -1)
    flat = ((samples[..., None] >> shifts) & 1).reshape(h, n * bits)
    return np.packbits(flat.astype(np.uint8), axis=1)


def lzw_encode(data: bytes, min_bits: int, msb_first: bool,
               early: int) -> bytes:
    """LZW codes of `data` as GIF (min_bits the code size, LSB first,
    early 0) or TIFF (min_bits 8, MSB first, early 1: the width grows one
    code sooner) write them: a clear code first and whenever the table
    nears 4096 entries, the end code last."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    out, acc, nacc = bytearray(), 0, 0
    width = min_bits + 1
    table: dict = {}
    nxt = size = end + 1        # the encoder's and the decoder's next code
    first = True

    def emit(code):
        nonlocal acc, nacc, width, size, first
        if msb_first:
            acc = acc << width | code
        else:
            acc |= code << nacc
        nacc += width
        while nacc >= 8:
            if msb_first:
                out.append(acc >> (nacc - 8) & 0xFF)
            else:
                out.append(acc & 0xFF)
                acc >>= 8
            nacc -= 8
        if msb_first:
            acc &= (1 << nacc) - 1
        if code == clear:
            return
        if not first:
            size += 1
            if size + early >= 1 << width and width < 12:
                width += 1
        first = False

    def reset():
        nonlocal width, nxt, size, first, table
        emit(clear)
        width, nxt, size, first = min_bits + 1, end + 1, end + 1, True
        table = {bytes([i]): i for i in range(clear)}

    reset()
    cur = b""
    for b in data:
        nb = cur + bytes([b])
        if nb in table:
            cur = nb
            continue
        emit(table[cur])
        table[nb] = nxt
        nxt += 1
        cur = bytes([b])
        if nxt >= 4000:
            emit(table[cur])
            cur = b""
            reset()
    if cur:
        emit(table[cur])
    emit(end)
    if nacc:
        out.append((acc << (8 - nacc) if msb_first else acc) & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png_filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """The rows filtered, each with a filter type drawn from rng."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    zero = np.zeros(bpp, np.int32)
    for cur in rows.astype(np.int32):
        a = np.concatenate([zero, cur])[:len(cur)]
        c = np.concatenate([zero, prev])[:len(cur)]
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        f = int(rng.integers(0, 5))
        pred = (0 * a, a, prev, (a + prev) >> 1, paeth)[f]
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def png_bytes(px: np.ndarray, depth: int, ctype: int, plte: bytes = None,
              trns: bytes = None, interlace: bool = False, seed: int = 0,
              extra_chunks=()) -> bytes:
    """A PNG of px ((h, w, samples) sample values) at colour type `ctype`
    and bit depth `depth`, Adam7 if `interlace`, rows filtered at random."""
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h, w = px.shape[:2]
    px = px.reshape(h, w, ch)
    rng = np.random.default_rng(seed)
    raw = b""
    for y0, x0, dy, dx in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = px[y0::dy, x0::dx]
        if sub.size:
            rows = pack_rows(sub.reshape(sub.shape[0], -1), depth)
            raw += _png_filter(rows, max(1, ch * depth // 8), rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    for kind, body in extra_chunks:
        out += _chunk(kind, body)
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeats, the rest as
    literals, at most 128 bytes a record."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _fp_diff(rows: np.ndarray, stride: int) -> np.ndarray:
    """libtiff's fpDiff of rows of 32-bit samples: each row's bytes as four
    planes (most significant first), then each byte less the byte
    `stride` before it."""
    planes = rows.astype(">u4").view(np.uint8).reshape(
        len(rows), -1, 4).transpose(0, 2, 1).reshape(len(rows), -1)
    out = planes.astype(np.int64)
    out[:, stride:] -= planes[:, :-stride]
    return (out & 0xFF).astype(np.uint8)


_COMPRESS = {1: lambda b: b, 5: lambda b: lzw_encode(b, 8, True, 1),
             8: zlib.compress, 32946: zlib.compress, 32773: packbits,
             34925: lambda b: lzma.compress(b, lzma.FORMAT_XZ)}


def tiff_bytes(samples: np.ndarray, bits: int, photometric: int,
               order: str = "II", compression: int = 1, predictor: int = 1,
               planar: int = 1, tile=None, rows_per_strip=None,
               extra=(), colormap=None, tags=(), cell_bytes=None,
               compress=None) -> bytes:
    """A TIFF of `samples` ((h, w, spp) values at `bits` bits), in strips
    of rows_per_strip rows or tiles of tile = (width, length), chunky
    (planar 1) or one plane a sample (planar 2), each strip or tile
    compressed on its own; predictor 2 stores each row's differences,
    predictor 3 (libtiff's floating-point predictor, for 32-bit samples)
    each row's bytes as planes, most significant first, then their
    differences. Tags of type 5 (RATIONAL) take (numerator, denominator)
    pairs. `cell_bytes(x, y, width, length)`, where given, makes each
    strip's or tile's bytes before compression instead (the samples then
    give only the size). `compress`, where given, compresses each strip
    or tile in place of the coder of `compression`."""
    compress = compress or _COMPRESS[compression]
    h, w, spp = samples.shape
    big = order == "MM"
    e = ">" if big else "<"
    if tile:
        tw, th = tile
        cells = [(x, y, tw, th) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        cells = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
    planes = [list(range(spp))] if planar == 1 else [[s] for s in
                                                       range(spp)]
    chunks = []
    for chans in planes:
        for x, y, cw, chh in cells:
            if cell_bytes is not None:
                chunks.append(compress(cell_bytes(x, y, cw, chh)))
                continue
            sub = np.zeros((chh, cw, len(chans)), np.int64)
            part = samples[y:y + chh, x:x + cw][..., chans]
            sub[:part.shape[0], :part.shape[1]] = part
            if predictor == 2:
                sub = np.concatenate([sub[:, :1], np.diff(sub, axis=1)],
                                     axis=1) % (1 << bits)
            if predictor == 3:
                rows = _fp_diff(sub.reshape(chh, -1), len(chans))
            else:
                rows = pack_rows(sub.reshape(chh, -1), bits, big)
            chunks.append(compress(rows.tobytes()))

    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
               259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    for tag, typ, vals in tags:
        entries[tag] = (typ, list(vals))
    offs_tag, counts_tag = (324, 325) if tile else (273, 279)
    if tile:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        entries[278] = (4, [rps])
    data = bytearray(b"MM\x00*" if big else b"II*\x00") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\x00"
    entries[offs_tag] = (4, offsets)
    entries[counts_tag] = (4, [len(c) for c in chunks])
    ifd = len(data)
    struct.pack_into(e + "I", data, 4, ifd)
    tail = ifd + 2 + 12 * len(entries) + 4
    body, spill = bytearray(struct.pack(e + "H", len(entries))), bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        fmt = {3: "H", 4: "I", 1: "B", 5: "II"}[typ]
        if typ == 5:
            vals = [v for pair in vals for v in pair]
        raw = struct.pack(e + fmt * (len(vals) // len(fmt)), *vals)
        if len(raw) <= 4:
            body += struct.pack(e + "HHI", tag, typ,
                                len(vals) // len(fmt)) + raw.ljust(
                4, b"\x00")
        else:
            body += struct.pack(e + "HHII", tag, typ, len(vals) // len(fmt),
                                tail + len(spill))
            spill += raw + (b"\x00" if len(raw) % 2 else b"")
    return bytes(data + body + bytes(4) + spill)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

def _rle_rows(rows: np.ndarray, four: bool) -> bytes:
    """RLE8 (or RLE4 if `four`) of the rows, bottom row first: runs of 3
    or more equal pixels as encoded runs, stretches of other pixels as
    absolute runs (at least 3 pixels, for RLE4 an even count) padded to a
    word, what is left as encoded runs of one pixel; an end-of-line after
    each row, end-of-bitmap last."""
    out = bytearray()
    for row in rows[::-1]:
        row = [int(v) for v in row]
        i, n = 0, len(row)
        while i < n:
            j = i
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 3:
                out += bytes([j - i, row[i] * 17 if four else row[i]])
                i = j
                continue
            k = i
            while k < n and k - i < 254 and not (
                    k + 2 < n and row[k] == row[k + 1] == row[k + 2]):
                k += 1
            if four:
                k -= (k - i) % 2
            if k - i < (4 if four else 3):
                out += bytes([1, row[i] * 17 if four else row[i]])
                i += 1
                continue
            lit = row[i:k]
            body = bytes(lit[t] << 4 | lit[t + 1] for t in range(
                0, len(lit), 2)) if four else bytes(lit)
            out += bytes([0, len(lit)]) + body + bytes(len(body) % 2)
            i = k
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_bytes(px: np.ndarray, bits: int, palette=None, compression: int = 0,
              masks=None, top_down: bool = False, header: int = 40) -> bytes:
    """A BMP of px: (h, w) palette indices for 1, 4 and 8 bits, else
    (h, w, 3) RGB (16 bits: 5-5-5 unless masks say 5-6-5). compression 0
    (BI_RGB), 1 (RLE8), 2 (RLE4) or 3 (BITFIELDS, with `masks`); header
    12 (OS/2 1.x), 40, 108 (V4) or 124 (V5)."""
    h, w = px.shape[:2]
    if compression in (1, 2):
        pixels = _rle_rows(px, compression == 2)
    else:
        if bits <= 8:
            rows = pack_rows(px.astype(np.int64), bits)
        elif bits == 16:
            r, g, b = (px[..., i].astype(np.int64) for i in range(3))
            if masks and masks[1] == 0x7E0:
                v = (r >> 3) << 11 | (g >> 2) << 5 | b >> 3
            else:
                v = (r >> 3) << 10 | (g >> 3) << 5 | b >> 3
            rows = v.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        else:
            bgr = px[..., ::-1].astype(np.uint8)
            if bits == 32:
                if masks and masks[:3] == (0xFF, 0xFF00, 0xFF0000):
                    bgr = px.astype(np.uint8)
                bgr = np.concatenate([bgr, np.full((h, w, 1), 255,
                                                   np.uint8)], -1)
            rows = bgr.reshape(h, -1)
        stride = -(-rows.shape[1] // 4) * 4
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :rows.shape[1]] = rows
        pixels = (padded if top_down else padded[::-1]).tobytes()
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if header == 12 else b"\0")
                       for r, g, b in palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(pixels), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if header >= 52:
            info += struct.pack("<4I", *(tuple(masks or (0, 0, 0)) + (0,))[
                :4])
            info += bytes(header - len(info))
        elif compression == 3:
            info += struct.pack("<3I", *masks[:3])
    off = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + pal + pixels)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def _table(palette: np.ndarray):
    """A colour table padded to a power of two: (bytes, size field)."""
    bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
    pal = np.zeros((1 << bits, 3), np.uint8)
    pal[:len(palette)] = palette
    return pal.tobytes(), bits - 1


def gif_bytes(index: np.ndarray, palette: np.ndarray, screen=None,
              offset=(0, 0), local: bool = False, interlace: bool = False,
              transparency=None, version: bytes = b"GIF89a",
              min_code=None) -> bytes:
    """A one-frame GIF of `index` ((h, w) palette indices) placed at
    `offset` on a logical screen of `screen` = (w, h), its colour table
    global or local, rows interlaced if asked."""
    h, w = index.shape
    sw, sh = screen or (w, h)
    table, size = _table(palette)
    out = bytearray(version + struct.pack("<HH", sw, sh))
    out += bytes([(0 if local else 0x80) | 0x70 | size, 0, 0])
    if not local:
        out += table
    if transparency is not None:
        out += bytes([0x21, 0xF9, 4, 1, 0, 0, transparency, 0])
    out += b"," + struct.pack("<HHHH", offset[0], offset[1], w, h)
    out += bytes([(0x80 | size if local else 0) | (0x40 if interlace
                                                    else 0)])
    if local:
        out += table
    rows = index
    if interlace:
        order = [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                 for y in range(start, h, step)]
        rows = index[order]
    code = min_code or max(2, size + 1)
    data = lzw_encode(rows.astype(np.uint8).tobytes(), code, False, 0)
    out.append(code)
    for i in range(0, len(data), 255):
        out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    return bytes(out + b"\x00;")


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def _png_pixels(name: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(os.path.join(DATA, name)).convert("RGB"))


def _indexed(px: np.ndarray):
    """(palette (n, 3), (h, w) indices) of an image of few colours."""
    pal, idx = np.unique(px.reshape(-1, 3), axis=0, return_inverse=True)
    return pal.astype(np.uint8), idx.reshape(px.shape[:2])


def big_texture(seed: int = SEED) -> np.ndarray:
    """(BIG, BIG, 3) uint8: a smooth gradient of a few seeded waves, the
    grid's lines tiled over it, the logo stamped at seeded places."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:BIG, 0:BIG] / BIG
    base = np.zeros((BIG, BIG, 3))
    for c in range(3):
        fx, fy, ph = rng.uniform(0.5, 2.5, 3)
        base[..., c] = 0.5 + 0.35 * np.sin(2 * np.pi * (fx * x + fy * y)
                                            + 6.283 * ph)
    img = base * 255.0
    grid = _png_pixels("grid.png").astype(np.float64)
    lines = (grid.min(-1) < 96)[..., None]           # the grid's dark lines
    tiles = np.tile(lines, (BIG // 256, BIG // 256, 1))
    img = np.where(tiles, 0.3 * img, img)
    logo = _png_pixels("logo.png").astype(np.float64)
    for _ in range(6):
        oy, ox = rng.integers(0, BIG - 200), rng.integers(0, BIG - 300)
        img[oy:oy + 200, ox:ox + 300] = 0.25 * img[oy:oy + 200,
                                                   ox:ox + 300] + 0.75 * logo
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def _pil_save(px: np.ndarray, mode: str, fmt: str, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(px).convert(mode).save(buf, fmt, **kw)
    return buf.getvalue()


def files() -> dict:
    """{name in scenes/data/modes: bytes} of every committed file."""
    from PIL import Image
    grid, logo = _png_pixels("grid.png"), _png_pixels("logo.png")
    gpal, gidx = _indexed(grid)
    lpal, lidx = _indexed(logo)
    ggrey = np.asarray(Image.fromarray(grid).convert("L")).astype(np.int64)
    lrgba = np.asarray(Image.open(os.path.join(DATA, "logo.png")))
    out = {
        # PNG
        "logo_palette_adam7.png": png_bytes(lidx, 2, 3, plte=lpal.tobytes(),
                                            interlace=True, seed=1),
        "grid_rgb16.png": png_bytes(grid.astype(np.int64) * 257, 16, 2,
                                    seed=2),
        "logo_rgba16_adam7.png": png_bytes(lrgba.astype(np.int64) * 257, 16,
                                           6, interlace=True, seed=3),
        "grid_grey16.png": png_bytes(ggrey * 257, 16, 0, seed=4),
        "grid_grey4.png": png_bytes(ggrey >> 4, 4, 0, seed=5),
        "grid_grey1_adam7.png": png_bytes((ggrey > 128).astype(np.int64), 1,
                                          0, interlace=True, seed=6),
        "logo_greyalpha8.png": png_bytes(np.stack(
            [np.asarray(Image.fromarray(logo).convert("L")),
             lrgba[..., 3]], -1).astype(np.int64), 8, 4, seed=7),
        # JPEG
        "grid_progressive.jpg": _pil_save(grid, "RGB", "JPEG", quality=90,
                                          subsampling="4:2:0",
                                          progressive=True),
        "logo_progressive.jpg": _pil_save(logo, "RGB", "JPEG", quality=90,
                                          subsampling="4:2:0",
                                          progressive=True),
        "logo_cmyk.jpg": _pil_save(logo, "CMYK", "JPEG", quality=90),
        "grid_rgb.jpg": _pil_save(grid, "RGB", "JPEG", quality=90,
                                  keep_rgb=True),
        "texture_2048.jpg": _pil_save(big_texture(), "RGB", "JPEG",
                                      quality=90, subsampling="4:2:0",
                                      progressive=True),
        # TIFF
        "logo_lzw_pred2.tif": tiff_bytes(lrgba.astype(np.int64), 8, 2,
                                         compression=5, predictor=2,
                                         rows_per_strip=64, extra=(2,)),
        "grid_tiles_deflate_planar2_mm.tif": tiff_bytes(
            grid.astype(np.int64), 8, 2, order="MM", compression=8,
            predictor=2, planar=2, tile=(64, 48)),
        "grid_rgb16_lzw_pred2_mm.tif": tiff_bytes(
            grid.astype(np.int64) * 257, 16, 2, order="MM", compression=5,
            predictor=2, tile=(128, 96)),
        "grid_palette_packbits.tif": tiff_bytes(
            gidx[..., None], 8, 3, compression=32773, rows_per_strip=50,
            colormap=np.concatenate([np.pad(gpal[:, c].astype(np.int64)
                                            * 257, (0, 252))
                                     for c in range(3)])),
        "logo_cmyk_deflate.tif": _pil_save(logo, "CMYK", "TIFF",
                                           compression="tiff_adobe_deflate"),
        "grid_minwhite1.tif": tiff_bytes((ggrey[..., None] < 128).astype(
            np.int64), 1, 0, rows_per_strip=37),
        # BMP
        "logo_4bit.bmp": bmp_bytes(lidx, 4, palette=lpal),
        "grid_rle8.bmp": bmp_bytes(gidx, 8, palette=gpal, compression=1),
        "logo_rle4.bmp": bmp_bytes(lidx, 4, palette=lpal, compression=2),
        "grid_8bit_topdown_v5.bmp": bmp_bytes(gidx, 8, palette=gpal,
                                              top_down=True, header=124),
        "logo_565_bitfields.bmp": bmp_bytes(logo[::4, ::4], 16,
                                            compression=3,
                                            masks=(0xF800, 0x7E0, 0x1F),
                                            header=108),
        "grid_os2_1bit.bmp": bmp_bytes((ggrey > 128).astype(np.int64), 1,
                                       palette=[(20, 40, 60),
                                                (250, 200, 150)],
                                       header=12),
        # GIF
        "grid.gif": _pil_save(grid, "RGB", "GIF"),
        "logo_interlaced_local.gif": gif_bytes(lidx, lpal, local=True,
                                               interlace=True,
                                               transparency=1),
        "logo_offset87a.gif": gif_bytes(lidx[20:180, 30:250], lpal,
                                        screen=(300, 200), offset=(30, 20),
                                        version=b"GIF87a"),
    }
    return out


def digest(data: bytes) -> str:
    """SHA-256 of PIL's RGB decode of an image file's bytes."""
    from PIL import Image
    px = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return hashlib.sha256(px.tobytes()).hexdigest()


def main() -> None:
    os.makedirs(MODES, exist_ok=True)
    print("MODE_DIGESTS = {")
    for name, data in sorted(files().items()):
        with open(os.path.join(MODES, name), "wb") as f:
            f.write(data)
        print(f'    "scenes/data/modes/{name}":\n        "{digest(data)}",')
    print("}")


if __name__ == "__main__":
    main()
