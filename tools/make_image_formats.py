"""Write scenes/data/formats/: the textured scene's images in the texture
formats PIL writes beyond PNG, JPEG, GIF, BMP and plain TIFF, and one
texture at the size and format a game ships it.

Most files re-encode scenes/data/grid.png (256x256 RGB) or logo.png
(300x200 RGBA), each of four colours. `texture_2048_dxt1.dds` is the
2048x2048 texture of tools/make_image_modes.py (`big_texture`, made by
numpy from its SEED) in DXT1 blocks, about 2.1 MB; every other file is at
most 64 KB.

PIL 12.1.0 writes what it can: JPEG- and CCITT-compressed TIFF (libtiff;
Group 3 one- and two-dimensional, with fill bits, fill order 2 and
MinIsWhite; Group 4; modified Huffman), DIB, TGA (raw and run-length),
PBM, PGM and PPM (binary), PFM, DDS (uncompressed, DXT1, DXT3, DXT5,
BC5), SGI (verbatim), PCX and QOI. It is never asked for a mode "1" or
"P" image as a JPEG-compressed TIFF: libtiff refuses those and the
process then aborts on a corrupted heap. The writers below write the
rest by hand: plain (ASCII) PNM and binary PNM of any maxval
(`pnm_bytes`), PAM (`pam_bytes`, which PIL does not open), TGA of every
image type, depth, colour map and origin with literal packets that run
on across rows (`tga_bytes`), run-length SGI (`sgi_bytes`), PCX of 1-bit
planes (`pcx_planes_bytes`), tiled or striped JPEG-compressed TIFF with
shared JPEGTables and 4:2:0 YCbCr (`tiff_jpeg_bytes`) and DDS headers of
any pixel format (`dds_bytes`). The tests use the same writers on seeded
small images.

The SHA-256 of PIL's `convert("RGB")` of every file is printed as
FORMAT_DIGESTS; tests/test_torch_gpu.py and chip_smoke.py pin it.

    python tools/make_image_formats.py
"""
from __future__ import annotations

import io
import os
import struct
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tools import make_image_modes as modes  # noqa: E402

FORMATS = os.path.join(modes.DATA, "formats")


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

def _tga_pixels(px: np.ndarray, itype: int, depth: int) -> np.ndarray:
    """(h, w * bytes) uint8: the pixels' bytes in TGA order."""
    h, w = px.shape[:2]
    kind = itype & 7
    if depth == 1:
        return modes.pack_rows(px.reshape(h, w).astype(np.int64), 1,
                               True).reshape(h, -1)
    if kind in (1, 3):
        return px.reshape(h, -1).astype(np.uint8)
    if depth == 16:
        r, g, b = (px[..., c].astype(np.int64) >> 3 for c in range(3))
        a = (px[..., 3] > 127) if px.shape[-1] == 4 else np.ones((h, w))
        v = (r << 10) | (g << 5) | b | (a.astype(np.int64) << 15)
        return np.stack([v & 255, v >> 8], -1).reshape(h, -1).astype(
            np.uint8)
    order = [2, 1, 0, 3][:depth // 8]
    return px[..., order].reshape(h, -1).astype(np.uint8)


def _tga_rle(rows: np.ndarray, bpp: int, across: bool) -> bytes:
    """Run-length packets: repeats of 2 or more pixels as run packets and
    the rest as literal packets, each row on its own; or, `across`, the
    whole image as literal packets of 128 pixels that run on across rows
    (PIL reads literal packets across rows, not run packets)."""
    out = bytearray()
    if across:
        flat = rows.reshape(-1, bpp)
        for i in range(0, len(flat), 128):
            chunk = flat[i:i + 128]
            out += bytes([len(chunk) - 1]) + chunk.tobytes()
        return bytes(out)
    for row in rows:
        pix = [bytes(p) for p in row.reshape(-1, bpp)]
        i, n = 0, len(pix)
        while i < n:
            j = i
            while j < n and j - i < 128 and pix[j] == pix[i]:
                j += 1
            if j - i >= 2:
                out += bytes([0x80 | (j - i - 1)]) + pix[i]
                i = j
                continue
            j = i + 1
            while j < n and j - i < 128 and not (j + 1 < n
                                                  and pix[j] == pix[j + 1]):
                j += 1
            out += bytes([j - i - 1]) + b"".join(pix[i:j])
            i = j
    return bytes(out)


def tga_bytes(px: np.ndarray, itype: int, depth: int, cmap=None,
              cmap_depth: int = 24, cmap_start: int = 0, flags: int = 0,
              across: bool = False, ident: bytes = b"") -> bytes:
    """A Targa file of `px` (indices or grey (h, w), grey and alpha
    (h, w, 2), or RGB(A) (h, w, 3|4) uint8) as image type `itype` at
    `depth` bits a pixel: stored bottom-up unless flags has 0x20, each row
    right to left under 0x10; run-length coded for types 9-11 (literal
    packets across rows if `across`). `cmap` ((n, 3) RGB) is written at
    `cmap_depth` bits an entry, its first entry numbered `cmap_start`."""
    h, w = px.shape[:2]
    stored = px if flags & 0x20 else px[::-1]
    if flags & 0x10:
        stored = stored[:, ::-1]
    rows = _tga_pixels(np.ascontiguousarray(stored), itype, depth)
    head = bytearray(18)
    head[0], head[2], head[16], head[17] = len(ident), itype, depth, flags
    table = b""
    if cmap is not None:
        cmap = np.asarray(cmap, np.uint8)
        head[1], head[7] = 1, cmap_depth
        struct.pack_into("<HH", head, 3, cmap_start, len(cmap))
        if cmap_depth == 16:
            table = _tga_pixels(cmap[None], 2, 16).tobytes()
        else:
            full = np.concatenate([cmap, np.full((len(cmap), 1), 255,
                                                 np.uint8)], 1)
            table = _tga_pixels(full[None, :, :cmap_depth // 8], 2,
                                cmap_depth).tobytes()
    struct.pack_into("<HH", head, 12, w, h)
    if itype & 8:
        body = _tga_rle(rows, max(depth // 8, 1), across)
    else:
        body = rows.tobytes()
    return bytes(head) + ident + table + body


# ---------------------------------------------------------------------------
# PNM, PAM
# ---------------------------------------------------------------------------

def pnm_bytes(px: np.ndarray, magic: str, maxval: int = 255,
              comment: bool = True) -> bytes:
    """A PNM file: P1 (bits, 1 black) or P4, P2 or P5 (grey), P3 or P6
    (RGB) of integer samples up to `maxval` (two bytes, big-endian, a
    binary sample above 255). Plain files get a comment in the header and
    one inside the data, and short lines."""
    h, w = px.shape[:2]
    head = f"{magic}\n"
    if comment:
        head += "# written by tools/make_image_formats.py\n"
    head += f"{w} {h}\n"
    if magic not in ("P1", "P4"):
        head += f"{maxval}\n"
    flat = px.reshape(-1).astype(np.int64)
    if magic == "P4":
        body = modes.pack_rows(px.reshape(h, w).astype(np.int64), 1,
                               True).tobytes()
    elif magic in ("P5", "P6"):
        body = flat.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    else:
        sep = "" if magic == "P1" else " "
        toks = [str(v) for v in flat]
        lines = [sep.join(toks[i:i + 12]) for i in range(0, len(toks), 12)]
        if comment and len(lines) > 1:
            lines.insert(1, "# a comment inside the data")
        body = ("\n".join(lines) + "\n").encode()
    return head.encode() + body


def pam_bytes(px: np.ndarray, maxval: int = 255) -> bytes:
    """A PAM (P7) file of (h, w, depth) samples."""
    h, w, d = px.shape
    tupl = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB",
            4: "RGB_ALPHA"}[d]
    head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {d}\nMAXVAL {maxval}\n"
            f"TUPLTYPE {tupl}\nENDHDR\n").encode()
    return head + px.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# ---------------------------------------------------------------------------
# SGI, PCX
# ---------------------------------------------------------------------------

def _sgi_row(row: np.ndarray) -> list:
    """SGI run-length packets of one row: repeats of 3 or more as runs,
    the rest verbatim, at most 127 samples a packet, a 0 last."""
    out, i, n = [], 0, len(row)
    while i < n:
        j = i
        while j < n and j - i < 127 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += [j - i, int(row[i])]
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out += [0x80 | (j - i)] + [int(v) for v in row[i:j]]
        i = j
    return out + [0]


def sgi_bytes(px: np.ndarray, bpc: int = 1, rle: bool = True) -> bytes:
    """An SGI file of (h, w, z) samples (z 1, 3 or 4; up to 255, or 65535
    at two bytes a sample), rows from the bottom up."""
    h, w, z = px.shape
    dim = 3 if z > 1 else 2
    head = bytearray(512)
    struct.pack_into(">HBBHHHHII", head, 0, 474, int(rle), bpc, dim, w, h,
                     z, 0, 255 if bpc == 1 else 65535)
    dt = ">u2" if bpc == 2 else np.uint8
    planes = [px[::-1, :, c] for c in range(z)]
    if not rle:
        return bytes(head) + b"".join(p.astype(dt).tobytes() for p in planes)
    rows = [np.asarray(_sgi_row(r), dt).tobytes() for p in planes for r in p]
    starts, pos = [], 512 + 8 * h * z
    for r in rows:
        starts.append(pos)
        pos += len(r)
    tables = struct.pack(f">{h * z}I", *starts) + struct.pack(
        f">{h * z}I", *(len(r) for r in rows))
    return bytes(head) + tables + b"".join(rows)


def _pcx_rle(line: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(line)
    while i < n:
        j = i
        while j < n and j - i < 63 and line[j] == line[i]:
            j += 1
        if j - i > 1 or line[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), line[i]])
        else:
            out.append(line[i])
        i = j
    return bytes(out)


def pcx_planes_bytes(idx: np.ndarray, palette: np.ndarray,
                     planes: int) -> bytes:
    """A PCX of 1-bit planes (2 or 4) holding `idx` ((h, w) indices under
    1 << planes) through the 16-colour header palette `palette`."""
    h, w = idx.shape
    stride = (w + 7) // 8
    stride += stride % 2
    head = bytearray(128)
    head[0], head[1], head[2], head[3] = 10, 5, 1, 1
    struct.pack_into("<HHHH", head, 4, 0, 0, w - 1, h - 1)
    pal = np.zeros((16, 3), np.uint8)
    pal[:len(palette)] = palette[:16]
    head[16:64] = pal.tobytes()
    head[65] = planes
    struct.pack_into("<H", head, 66, stride)
    body = bytearray()
    for row in idx:
        line = b""
        for p in range(planes):
            bits = ((row >> p) & 1).astype(np.int64)[None]
            line += modes.pack_rows(bits, 1, True).tobytes().ljust(stride,
                                                                   b"\x00")
        body += _pcx_rle(line)
    return bytes(head) + bytes(body)


# ---------------------------------------------------------------------------
# TIFF with JPEG data, DDS
# ---------------------------------------------------------------------------

def _split_tables(jpeg: bytes):
    """(tables stream, abbreviated image stream) of a full JPEG stream:
    the DQT and DHT segments move to a stream of their own."""
    tables, image, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while True:
        m = jpeg[pos + 1]
        if m == 0xDA:
            image += jpeg[pos:]
            return bytes(tables + b"\xff\xd9"), bytes(image)
        length = struct.unpack_from(">H", jpeg, pos + 2)[0]
        seg = jpeg[pos:pos + 2 + length]
        if m in (0xDB, 0xC4):
            tables += seg
        elif m != 0xE0:                     # drop the JFIF marker
            image += seg
        pos += 2 + length


def tiff_jpeg_bytes(rgb: np.ndarray, tile=None, rows_per_strip=None,
                    subsampling: str = "4:2:0", quality: int = 90) -> bytes:
    """A YCbCr TIFF of `rgb` ((h, w, 3) uint8) with JPEG compression: each
    strip or tile (edge tiles padded by repeating the last row and
    column) a JPEG stream of PIL's, its tables moved to the shared
    JPEGTables tag."""
    from PIL import Image

    h, w = rgb.shape[:2]
    if tile:
        tw, th = tile
        cells = [(x, y, tw, th) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        cells = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
    tables, chunks = None, []
    for x, y, cw, ch in cells:
        part = rgb[y:y + ch, x:x + cw]
        part = np.pad(part, ((0, ch - part.shape[0]),
                             (0, cw - part.shape[1]), (0, 0)), mode="edge")
        buf = io.BytesIO()
        Image.fromarray(part).save(buf, "JPEG", quality=quality,
                                   subsampling=subsampling)
        t, img = _split_tables(buf.getvalue())
        assert tables in (None, t)
        tables = t
        chunks.append(img)
    sub = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1)}[subsampling]
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
               259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
               284: (3, [1]), 347: (7, tables), 530: (3, list(sub))}
    if tile:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        entries[278] = (4, [rps])
    return _tiff_file(entries, chunks, bool(tile))


def _tiff_file(entries: dict, chunks: list, tiled: bool) -> bytes:
    """A little-endian TIFF of one IFD over the strips or tiles
    `chunks`."""
    data = bytearray(b"II*\x00") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c + (b"\x00" if len(c) % 2 else b"")
    entries[324 if tiled else 273] = (4, offsets)
    entries[325 if tiled else 279] = (4, [len(c) for c in chunks])
    ifd = len(data)
    struct.pack_into("<I", data, 4, ifd)
    tail = ifd + 2 + 12 * len(entries) + 4
    body, spill = bytearray(struct.pack("<H", len(entries))), bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        raw = (bytes(vals) if typ == 7 else
               struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals))
        if len(raw) <= 4:
            body += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(
                4, b"\x00")
        else:
            body += struct.pack("<HHII", tag, typ, len(vals),
                                tail + len(spill))
            spill += raw + (b"\x00" if len(raw) % 2 else b"")
    return bytes(data + body + bytes(4) + spill)


def dds_bytes(w: int, h: int, body: bytes, pfflags: int, fourcc: bytes =
              b"\x00" * 4, bitcount: int = 0, masks=(0, 0, 0, 0),
              dxgi: int | None = None) -> bytes:
    """A DDS file: the 128-byte header of the pixel format given (and a
    DX10 header of DXGI format `dxgi`), then `body`."""
    head = b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0)
    head += bytes(44) + struct.pack("<4I", 32, pfflags, 0, bitcount)
    head = head[:84] + fourcc + head[88:]
    head += struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0, 0,
                                                      0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 1)
    return head + body


# ---------------------------------------------------------------------------
# BC4, BC7 and BC6H blocks: bit packers over the D3D layouts (the port's
# tables in rlshaders_tpu_torch/scene/dds.py), not quality compressors:
# each subset's end points are its pixels' per-channel extremes and each
# pixel takes the nearest of the interpolated values
# ---------------------------------------------------------------------------

def texel_blocks(px: np.ndarray) -> np.ndarray:
    """(n, 16, c) of an (h, w, c) image's 4x4 blocks in row-major order,
    the edges padded by repeating the last row and column."""
    h, w, c = px.shape
    px = np.pad(px, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge")
    bh, bw = px.shape[0] // 4, px.shape[1] // 4
    return px.reshape(bh, 4, bw, 4, c).transpose(0, 2, 1, 3, 4).reshape(
        bh * bw, 16, c)


def _put(bits: np.ndarray, pos: int, vals, n: int) -> int:
    """Write the n low bits of `vals` ((k,) ints) at bit pos of each row
    of `bits`, least significant first; returns pos + n."""
    v = np.asarray(vals, np.int64)
    for j in range(n):
        bits[:, pos + j] = (v >> j) & 1
    return pos + n


def _put_indices(bits: np.ndarray, pos: int, idx: np.ndarray,
                 widths: np.ndarray) -> int:
    """Write (k, 16) indices at per-pixel widths from bit pos (the anchors
    one bit narrower); returns the end."""
    widths = np.broadcast_to(widths, idx.shape)
    starts = pos + np.cumsum(widths, 1) - widths
    rows = np.arange(len(idx))[:, None]
    for j in range(int(widths.max())):
        on = j < widths
        bits[np.broadcast_to(rows, idx.shape)[on], (starts + j)[on]] = (
            (idx >> j) & 1)[on]
    return pos + int(widths[0].sum())


def _nearest(px: np.ndarray, pal: np.ndarray) -> np.ndarray:
    """(k, 16) index of the nearest of pal ((k, 16, m, c)) to each of px
    ((k, 16, c))."""
    d = ((pal - px[:, :, None, :].astype(np.int64)) ** 2).sum(-1)
    return d.argmin(-1)


def _pack(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def bc4_blocks(grey: np.ndarray) -> bytes:
    """BC4 blocks of an (h, w) uint8 image: the block's extremes as the
    two end points (the eight-value mode) and the nearest value a pixel."""
    v = texel_blocks(grey[..., None])[..., 0].astype(np.int64)
    a0, a1 = v.max(1), v.min(1)
    k = np.arange(1, 7)
    pal = np.concatenate([a0[:, None], a1[:, None],
                          ((7 - k) * a0[:, None] + k * a1[:, None]) // 7], 1)
    idx = np.abs(v[:, :, None] - pal[:, None, :]).argmin(-1)
    bits = np.zeros((len(v), 64), np.uint8)
    _put(bits, 0, a0, 8)
    _put(bits, 8, a1, 8)
    for i in range(16):
        _put(bits, 16 + 3 * i, idx[:, i], 3)
    return _pack(bits).tobytes()


def _swap_for_anchors(ep, idx, subset, anchors, top):
    """Swap a subset's end points (ep (k, n_ep, c)) where its anchor's
    index has its top bit set, and invert that subset's indices."""
    for s in range(ep.shape[1] // 2):
        at = (subset == s) & anchors
        flip = ((idx >= (top + 1) // 2) & at).any(1)
        ep[flip, 2 * s], ep[flip, 2 * s + 1] = (ep[flip, 2 * s + 1].copy(),
                                                ep[flip, 2 * s].copy())
        inv = flip[:, None] & (subset == s)
        idx[inv] = top - idx[inv]
    return ep, idx


def _bc7_mode_blocks(px: np.ndarray, m: int, part: np.ndarray,
                     rotation: np.ndarray, selector: np.ndarray) -> np.ndarray:
    """(k, 128) bits of mode-m BC7 blocks of (k, 16, 4) RGBA texels."""
    from rlshaders_tpu_torch.scene import dds

    info = dds.BC7_MODES[m]
    k, ns = len(px), info.subsets
    px = px.astype(np.int64).copy()
    for r in (1, 2, 3):                  # the decoder swaps these back
        sw = rotation == r
        px[sw, :, r - 1], px[sw, :, 3] = px[sw, :, 3], px[sw, :, r - 1]
    subset = dds.subset_map(ns)[part]
    anchors = dds.anchor_map(ns)[part]
    n_ep = 2 * ns
    has_a = info.alpha_bits > 0
    pb = info.endpoint_pbits or info.shared_pbits
    # each subset's per-channel extremes, quantized to the stored bits
    big = np.where((subset[..., None] == np.arange(ns))[..., None],
                   px[:, :, None, :], -1)                   # (k, 16, ns, 4)
    small = np.where(big < 0, 256, big)
    hi, lo = big.max(1), small.min(1)                       # (k, ns, 4)
    lo = np.where(lo > 255, 0, lo)
    hi = np.where(hi < 0, 0, hi)
    ends = np.stack([lo, hi], 2).reshape(k, n_ep, 4)        # (k, n_ep, 4)
    cbits = [info.colour_bits] * 3 + [info.alpha_bits]
    total = [c + pb for c in cbits]
    q = np.zeros((k, n_ep, 4), np.int64)
    for c in range(4 if has_a else 3):
        top = (1 << total[c]) - 1
        q[..., c] = (ends[..., c] * top + 127) // 255
    if pb:                               # the p-bit from red's low bit
        p = q[..., 0] & 1
        if info.shared_pbits:
            p = np.repeat(p[:, ::2], 2, 1)
        for c in range(4 if has_a else 3):
            q[..., c] = (q[..., c] >> 1 << 1) | p
    ep = np.full((k, n_ep, 4), 255, np.int64)
    for c in range(4 if has_a else 3):
        ep[..., c] = dds._expand(q[..., c], total[c])

    def lerp(e, w):              # e (k, n_ep, c), w (m,) -> (k, 16, m, c)
        e0 = np.take_along_axis(e, (2 * subset)[..., None], 1)
        e1 = np.take_along_axis(e, (2 * subset + 1)[..., None], 1)
        w = np.asarray(w)[None, None, :, None]
        return ((64 - w) * e0[:, :, None] + w * e1[:, :, None] + 32) >> 6

    ib, ib2 = info.index_bits, info.index2_bits
    if ib2:
        # two index sets, each anchored at pixel 0: the ib-bit set drives
        # the colour (alpha where the selector is 1), the ib2-bit set the
        # other
        wa, wb = dds._WEIGHTS[ib], dds._WEIGHTS[ib2]
        sel = (selector == 1)[:, None]
        i0 = np.where(sel, _nearest(px[..., 3:], lerp(ep[..., 3:], wa)),
                      _nearest(px[..., :3], lerp(ep[..., :3], wa)))
        i1 = np.where(sel, _nearest(px[..., :3], lerp(ep[..., :3], wb)),
                      _nearest(px[..., 3:], lerp(ep[..., 3:], wb)))
        for idx, top, colour in ((i0, (1 << ib) - 1, selector == 0),
                                 (i1, (1 << ib2) - 1, selector == 1)):
            flip = idx[:, 0] > top // 2
            for chans, who in ((slice(0, 3), colour),
                               (slice(3, 4), ~colour)):
                f = flip & who
                q[f, :, chans] = q[f, ::-1, chans]
            idx[flip] = top - idx[flip]
    else:
        e = ep if has_a else ep[..., :3]
        i0 = _nearest(px if has_a else px[..., :3],
                      lerp(e, dds._WEIGHTS[ib]))
        q, i0 = _swap_for_anchors(q, i0, subset, anchors, (1 << ib) - 1)
    bits = np.zeros((k, 128), np.uint8)
    pos = _put(bits, 0, np.full(k, 1 << m), m + 1)
    pos = _put(bits, pos, part, info.partition_bits)
    pos = _put(bits, pos, rotation, info.rotation_bits)
    pos = _put(bits, pos, selector, info.selector_bits)
    for c in range(4 if has_a else 3):
        for e in range(n_ep):
            pos = _put(bits, pos, q[:, e, c] >> pb, cbits[c])
    if info.endpoint_pbits:
        for e in range(n_ep):
            pos = _put(bits, pos, q[:, e, 0] & 1, 1)
    elif info.shared_pbits:
        for s in range(ns):
            pos = _put(bits, pos, q[:, 2 * s, 0] & 1, 1)
    end = _put_indices(bits, pos, i0, ib - anchors)
    if ib2:
        first = np.zeros((1, 16), np.int64)
        first[0, 0] = 1
        _put_indices(bits, end, i1, ib2 - first)
    return bits


def bc7_blocks(rgba: np.ndarray, modes: np.ndarray, parts: np.ndarray,
               rotations: np.ndarray, selectors: np.ndarray) -> bytes:
    """BC7 blocks of an (h, w, 4) uint8 image, block i in mode modes[i]
    with partition parts[i] (taken modulo the mode's count), rotation and
    index selector (modes 4 and 5)."""
    from rlshaders_tpu_torch.scene import dds

    px = texel_blocks(rgba)
    out = np.zeros((len(px), 16), np.uint8)
    for m in range(8):
        sel = modes == m
        if not sel.any():
            continue
        info = dds.BC7_MODES[m]
        out[sel] = _pack(_bc7_mode_blocks(
            px[sel], m, parts[sel] % (1 << info.partition_bits),
            rotations[sel] % (1 << info.rotation_bits),
            selectors[sel] % (1 << info.selector_bits)))
    return out.tobytes()


def _bc6_target(rgb: np.ndarray, signed: bool) -> np.ndarray:
    """The interpolated value BcnDecode.c turns into each 8-bit sample's
    half float: half * 64 / 31 unsigned, half * 32 / 31 signed."""
    half = (rgb.astype(np.float32) / 255).astype(np.float16).view(
        np.uint16).astype(np.int64)
    return -(-half * (32 if signed else 64) // 31)


def _bc6_quantize(u: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    """The prec-bit end point nearest to unquantized value u (>= 0)."""
    if prec >= (16 if signed else 15):
        return np.minimum(u, 0x7FFF if signed else 0xFFFF)
    if signed:
        return np.minimum((u * (1 << (prec - 1)) + 16384) >> 15,
                          (1 << (prec - 1)) - 1)
    return np.minimum((u << prec) >> 16, (1 << prec) - 1)


def _bc6_mode_blocks(px: np.ndarray, m: int, part: np.ndarray,
                     signed: bool) -> np.ndarray:
    """(k, 128) bits of mode-m BC6H blocks of (k, 16, 3) RGB texels."""
    from rlshaders_tpu_torch.scene import dds

    info = dds.BC6_MODES[m]
    k, ns = len(px), info.subsets
    prec = info.endpoint_bits
    u = _bc6_target(px, signed)
    subset = dds.subset_map(ns, 32)[part]
    anchors = dds.anchor_map(ns, 32)[part]
    inside = (subset[..., None] == np.arange(ns))[..., None]
    hi = np.where(inside, u[:, :, None], -1).max(1)
    lo = np.where(inside, u[:, :, None], 1 << 20).min(1)
    ends = _bc6_quantize(np.stack([lo, hi], 2).reshape(k, 2 * ns, 3), prec,
                         signed)
    # each subset's low end first: an anchor's index is then mostly small
    # (and clamped below its top bit where not)
    e = ends.reshape(k, 6 * ns)
    stored = e.copy()
    mask = (1 << prec) - 1
    if info.transformed:
        deltas = np.tile(info.delta_bits, 2 * ns - 1)
        d = np.clip(e[:, 3:] - np.tile(e[:, :3], 2 * ns - 1),
                    -(1 << (deltas - 1)), (1 << (deltas - 1)) - 1)
        stored[:, 3:] = d & ((1 << deltas) - 1)
        e[:, 3:] = (np.tile(e[:, :3], 2 * ns - 1) + d) & mask
    stored[:, :3] &= mask
    ue = dds._bc6_unquantize(e, prec, signed).reshape(k, 2 * ns, 3)
    e0 = np.take_along_axis(ue, (2 * subset)[..., None], 1)
    e1 = np.take_along_axis(ue, (2 * subset + 1)[..., None], 1)
    ib = 3 if ns == 2 else 4
    w = np.asarray(dds._WEIGHTS[ib])
    pal = (e0[:, :, None] * (64 - w[:, None]) + e1[:, :, None] * w[:, None]
           ) >> 6
    idx = _nearest(u, pal)
    idx = np.where(anchors, np.minimum(idx, (1 << (ib - 1)) - 1), idx)
    bits = np.zeros((k, 128), np.uint8)
    mode = m if m < 2 else ((m - 2) << 2 | 2 if m < 10 else (m - 10) << 2 | 3)
    pos = _put(bits, 0, np.full(k, mode), 2 if m < 2 else 5)
    for i, (value, bit) in enumerate(dds.bc6_layout(info.layout)):
        bits[:, pos + i] = (stored[:, value] >> bit) & 1
    pos += len(dds.bc6_layout(info.layout))
    pos = _put(bits, pos, part, info.partition_bits)
    _put_indices(bits, pos, idx, ib - anchors)
    return bits


def bc6h_blocks(rgb: np.ndarray, modes: np.ndarray, parts: np.ndarray,
                signed: bool) -> bytes:
    """BC6H blocks of an (h, w, 3) uint8 image (its values over 255 as
    half floats), block i in mode modes[i] (0-13, BcnDecode.c's order)
    with partition parts[i] (modulo 32)."""
    px = texel_blocks(rgb)
    out = np.zeros((len(px), 16), np.uint8)
    for m in range(14):
        sel = modes == m
        if sel.any():
            out[sel] = _pack(_bc6_mode_blocks(px[sel], m, parts[sel] % 32,
                                              signed))
    return out.tobytes()


# ---------------------------------------------------------------------------
# BLP, ICO and CUR, ICNS, MSP
# ---------------------------------------------------------------------------

def blp_bytes(version: bytes, w: int, h: int, body: bytes, *,
              compression: int = 1, encoding: int = 1, alpha: int = 0,
              alpha_encoding: int = 0, palette=None,
              jpeg_header: bytes = b"") -> bytes:
    """A BLP1 or BLP2 file of one mip level, `body` its data: palette
    indices (BLP1 encoding 5, BLP2 encoding 1; `palette` (n, 4) RGBA),
    the JPEG stream after `jpeg_header` (BLP1 compression 0) or DXT
    blocks (BLP2 encoding 2, alpha encoding 0, 1 or 7)."""
    if version == b"BLP1":
        head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, w, h,
                                     encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding,
                                     alpha, alpha_encoding, 0, w, h)
    table_at = len(head)
    extra = b""
    if version == b"BLP1" and compression == 0:
        extra = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        pal = np.zeros((256, 4), np.uint8)
        if palette is not None:
            pal[:len(palette)] = np.asarray(palette, np.uint8)
        extra = pal[:, [2, 1, 0, 3]].tobytes()
    data_at = table_at + 128 + len(extra)
    table = struct.pack("<16I", data_at, *([0] * 15)) + struct.pack(
        "<16I", len(body), *([0] * 15))
    return head + table + extra + body


def blp_jpeg(rgb: np.ndarray, quality: int = 90, mode: str = "RGB") -> bytes:
    """A BLP1 file of JPEG data: PIL's JPEG of the image with red and blue
    swapped (BLP stores BGR), its stream split before the scan into the
    shared header and the level's data."""
    jpeg = _pil(np.ascontiguousarray(rgb[..., ::-1]), mode, "JPEG",
                quality=quality)
    sos = jpeg.index(b"\xff\xda")
    h, w = rgb.shape[:2]
    return blp_bytes(b"BLP1", w, h, jpeg[sos:], compression=0,
                     jpeg_header=jpeg[:sos])


def blp_dxt(rgba: np.ndarray, kind: str, alpha: int = 1) -> bytes:
    """A BLP2 file of DXT1, DXT3 or DXT5 blocks, taken from PIL's DDS
    writer."""
    dds = _pil(rgba, "RGBA", "DDS", pixel_format=kind)
    h, w = rgba.shape[:2]
    return blp_bytes(b"BLP2", w, h, dds[128:], encoding=2, alpha=alpha,
                     alpha_encoding={"DXT1": 0, "DXT3": 1, "DXT5": 7}[kind])


def icon_dib(px: np.ndarray, bits: int, palette=None,
             and_mask: bool = True) -> bytes:
    """An icon's bitmap: the DIB of make_image_modes.bmp_bytes with its
    height doubled, then (unless 32-bit) an all-zero AND mask."""
    h, w = px.shape[:2]
    bmp = modes.bmp_bytes(px, bits, palette)
    dib = bytearray(bmp[14:])
    struct.pack_into("<i", dib, 8, 2 * h)
    if and_mask:
        dib += bytes((w + 31) // 32 * 4 * h)
    return bytes(dib)


def icon_bytes(entries: list, cursor: bool = False) -> bytes:
    """An ICO (or CUR) file of `entries`: (width, height, colours, planes
    or hotspot x, bit count or hotspot y, payload), in that order."""
    head = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    at = 6 + 16 * len(entries)
    table, body = b"", b""
    for w, h, colours, a, b, payload in entries:
        table += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, a, b,
                             len(payload), at + len(body))
        body += payload
    return head + table + body


def icns_rle(plane: np.ndarray) -> bytes:
    """PIL's read_32 run-length scheme: repeats of 3 to 130 as a byte
    n + 125 and the value, the rest as a byte n - 1 and n literal bytes
    (n at most 128)."""
    v = np.asarray(plane, np.uint8).reshape(-1).tobytes()
    out, i, n = bytearray(), 0, len(v)
    while i < n:
        j = i
        while j < n and j - i < 130 and v[j] == v[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i + 125, v[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and v[j] == v[j + 1] == v[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + v[i:j]
        i = j
    return bytes(out)


def icns_bytes(entries: list) -> bytes:
    """An ICNS file of (type, payload) entries."""
    body = b"".join(t + struct.pack(">I", 8 + len(p)) + p for t, p in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb(rgb: np.ndarray, rle: bool = True, it32: bool = False) -> bytes:
    """A 24-bit RGB entry's payload: three run-length planes (or raw
    interleaved RGB), after four zero bytes for it32."""
    if rle:
        data = b"".join(icns_rle(rgb[..., c]) for c in range(3))
    else:
        data = np.asarray(rgb, np.uint8).tobytes()
    return (b"\x00" * 4 if it32 else b"") + data


def msp2_bytes(bits: np.ndarray) -> bytes:
    """A version 2 ("LinS") MSP file of (h, w) bits (1 white): each row
    run-length coded (runs of 3 or more as 0, count, value; the rest as
    count and literal bytes), an all-white row as a row of 0 bytes."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    coded = []
    for row in rows:
        r = row.tobytes()
        if r == b"\xff" * len(r):
            coded.append(b"")
            continue
        out, i, n = bytearray(), 0, len(r)
        while i < n:
            j = i
            while j < n and j - i < 255 and r[j] == r[i]:
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i, r[i]])
                i = j
                continue
            j = i
            while j < n and j - i < 255 and not (j + 2 < n
                                                  and r[j] == r[j + 1]
                                                  == r[j + 2]):
                j += 1
            out += bytes([j - i]) + r[i:j]
            i = j
        coded.append(bytes(out))
    head = [0] * 16
    head[0], head[1] = struct.unpack("<HH", b"LinS")
    head[2], head[3], head[8], head[9] = w, h, w, h
    head[4:8] = [1, 1, 1, 1]
    check = 0
    for v in head:
        check ^= v
    head[12] = check
    return (struct.pack("<16H", *head)
            + struct.pack(f"<{h}H", *(len(c) for c in coded))
            + b"".join(coded))


# ---------------------------------------------------------------------------
# SPIDER and WebP
# ---------------------------------------------------------------------------

def spider_bytes(px: np.ndarray, order: str = "<", iform: int = 1,
                 nslice: int = 1, stack: int = 0, imgnumber: int = 0,
                 labrec=None, fields: dict = None) -> bytes:
    """A SPIDER file of (h, w) float samples in byte order `order`:
    PIL's header (labrec records of 4 * w bytes, at least 1024 bytes)
    with the file type, slices, label fields given (counted from 1), or
    a stack of `stack` images, the first `px` and image k all k."""
    h, w = px.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt) if labrec is None else labrec
    labbyt = labrec * lenbyt

    def header(istack, maxim, img):
        v = [0.0] * (labbyt // 4 + 1)
        for i, x in {1: nslice, 2: h, 3: h, 5: iform, 12: w, 13: labrec,
                     22: labbyt, 23: lenbyt, 24: istack, 26: maxim,
                     27: img, **(fields or {})}.items():
            v[i] = x
        return struct.pack(f"{order}{len(v) - 1}f", *v[1:])

    def body(a):
        return np.asarray(a, np.float32).astype(order + "f4").tobytes()

    if not stack:
        return header(0, 0, imgnumber) + body(px)
    return header(stack, stack, 0) + b"".join(
        header(0, 0, k + 1) + body(px if k == 0 else np.full_like(px, k))
        for k in range(stack))


def riff_webp(chunks: list) -> bytes:
    """A WebP file of (fourcc, payload) chunks, each padded to even."""
    body = b"WEBP" + b"".join(
        k + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1)
        for k, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x_chunk(w: int, h: int, flags: int) -> bytes:
    """A VP8X payload: the flags and the canvas size."""
    return (bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little"))


class BoolWriter:
    """The boolean entropy encoder of RFC 6386, section 7.3."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put(128, (v >> k) & 1)

    def flagged(self, v: int, n: int) -> None:
        """A signed n-bit value behind a flag bit (0: the flag alone)."""
        self.put(128, v != 0)
        if v:
            self.literal(abs(v), n)
            self.put(128, v < 0)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out) + bytes(2)


def _tree_paths(tree) -> dict:
    """{leaf value: [(node, bit), ...]} of a token tree in libwebp's form
    (node i's children at 2i and 2i + 1; a leaf is -value)."""
    paths = {}

    def walk(i, path):
        for bit in (0, 1):
            k = tree[2 * i + bit]
            if k > 0:
                walk(k, path + [(i, bit)])
            else:
                paths[-k] = path + [(i, bit)]

    walk(0, [])
    return paths


def _put_coeff(bw: BoolWriter, p, v: int) -> None:
    """The token of a non-zero coefficient v after its p[1] (not zero)
    bit: one or more, the large-value tree, its extra bits, the sign."""
    from rlshaders_tpu_torch.scene.vp8 import _CAT_PROBS
    a = abs(v)
    bw.put(p[2], a > 1)
    if a > 1:
        bw.put(p[3], a > 4)
        if a <= 4:
            bw.put(p[4], a > 2)
            if a > 2:
                bw.put(p[5], a - 3)
        else:
            bw.put(p[6], a > 10)
            if a <= 10:
                bw.put(p[7], a > 6)
                if a <= 6:
                    bw.put(159, a - 5)
                else:
                    bw.put(165, (a - 7) >> 1)
                    bw.put(145, (a - 7) & 1)
            else:
                cat = next(c for c in (3, 2, 1, 0) if a >= 3 + (8 << c))
                bw.put(p[8], cat >> 1)
                bw.put(p[9 + (cat >> 1)], cat & 1)
                extra = a - 3 - (8 << cat)
                n = len(_CAT_PROBS[cat])
                for k, prob in enumerate(_CAT_PROBS[cat]):
                    bw.put(prob, (extra >> (n - 1 - k)) & 1)
    bw.put(128, v < 0)


def vp8_frame(w: int, h: int, seed: int, *, simple: bool = False,
              level: int = 20, sharpness: int = 0, partitions: int = 1,
              q: int = 40, segments: bool = False, deltas: bool = False,
              skip: bool = True, updates: int = 8,
              exact: bool = True) -> bytes:
    """A VP8 key frame (a VP8 chunk's payload) of seeded modes and
    coefficients, written with the boolean encoder: the loop filter
    `simple` or normal at `level` and `sharpness`, `partitions` (1, 2, 4
    or 8) token partitions, quantizer index q, optionally four segments
    (a map, absolute quantizers and filter levels), reference and mode
    filter deltas, skipped macroblocks and `updates` coefficient
    probability updates; with `exact` False, coefficients past the range
    where libwebp's transforms are exact (its SIMD code then decides). It
    reaches what PIL's writer never sets; its decode is what libwebp
    makes of it, held to PIL's by the tests."""
    from rlshaders_tpu_torch.scene.vp8 import _BMODE_TREE, BANDS
    from rlshaders_tpu_torch.scene.vp8_tables import (AC_TABLE, BMODE_PROBS,
                                                      COEFF_PROBS,
                                                      COEFF_UPDATE_PROBS,
                                                      DC_TABLE)
    rng = np.random.default_rng(seed)
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    bw = BoolWriter()
    bw.literal(0, 2)                               # colour space, clamping
    bw.put(128, segments)
    seg_probs = (120, 80, 200)
    if segments:
        bw.put(128, 1)                             # update the map
        bw.put(128, 1)                             # update the data
        bw.put(128, 1)                             # absolute values
        for v in (q, min(q + 17, 127), max(q - 23, 0), 127):
            bw.flagged(v, 7)
        for v in (level, 0, 63, level // 2):
            bw.flagged(v, 6)
        for p in seg_probs:
            bw.put(128, 1)
            bw.literal(p, 8)
    bw.put(128, simple)
    bw.literal(level, 6)
    bw.literal(sharpness, 3)
    bw.put(128, deltas)
    if deltas:
        bw.put(128, 1)
        for v in (5, -3, 0, 2):                    # reference deltas
            bw.flagged(v, 6)
        for v in (-9, 4, 0, 1):                    # mode deltas
            bw.flagged(v, 6)
    bw.literal(partitions.bit_length() - 1, 2)
    bw.literal(q, 7)
    for v in (2, -3, 1, -1, 3):                    # the quantizer deltas
        bw.flagged(v, 4)
    # the largest level of each (segment, type, DC or AC) that keeps the
    # dequantized value where libwebp's transforms are exact: 2047 for a
    # block, 1023 for Y2 (its inverse WHT sums 16 of them over 8)
    qs = (q, min(q + 17, 127), max(q - 23, 0), 127) if segments else (q,) * 4

    def step(table, v, top=127):
        return table[min(max(v, 0), top)]

    limits = [{3: (2047 // step(DC_TABLE, s + 2), 2047 // step(AC_TABLE, s)),
               0: (0, 2047 // step(AC_TABLE, s)),
               1: (1023 // (2 * step(DC_TABLE, s - 3)),
                   1023 // max((step(AC_TABLE, s + 1) * 101581) >> 16, 8)),
               2: (2047 // step(DC_TABLE, s - 1, 117),
                   2047 // step(AC_TABLE, s + 3))} for s in qs]
    bw.put(128, 0)                                 # refresh entropy probs
    probs = list(COEFF_PROBS)
    chosen = set(rng.choice(len(probs), updates, replace=False).tolist())
    for i, u in enumerate(COEFF_UPDATE_PROBS):
        bw.put(u, i in chosen)
        if i in chosen:
            probs[i] = int(rng.integers(1, 256))
            bw.literal(probs[i], 8)
    skip_prob = 40
    bw.put(128, skip)
    if skip:
        bw.literal(skip_prob, 8)
    # the modes
    bpaths = _tree_paths(_BMODE_TREE)
    top = [0] * (4 * mbw)
    mbs = []
    for y in range(mbh):
        left = [0] * 4
        for x in range(mbw):
            seg = int(rng.integers(0, 4)) if segments else 0
            if segments:
                bw.put(seg_probs[0], seg >= 2)
                bw.put(seg_probs[1 + (seg >= 2)], seg & 1)
            skipped = bool(skip and rng.random() < 0.2)
            if skip:
                bw.put(skip_prob, skipped)
            is4 = bool(rng.random() < 0.5)
            bw.put(145, not is4)
            if is4:
                for r in range(4):
                    for c in range(4):
                        m = int(rng.integers(0, 10))
                        prob = BMODE_PROBS[(top[4 * x + c] * 10 + left[r])
                                           * 9:][:9]
                        for node, bit in bpaths[m]:
                            bw.put(prob[node], bit)
                        top[4 * x + c] = left[r] = m
            else:
                m = int(rng.integers(0, 4))        # DC, TM, V (2), H (3)
                if m == 0:
                    bits = ((156, 0), (163, 0))
                elif m == 2:
                    bits = ((156, 0), (163, 1))
                else:
                    bits = ((156, 1), (128, m == 1))
                for prob, bit in bits:
                    bw.put(prob, bit)
                top[4 * x:4 * x + 4] = [m] * 4
                left = [m] * 4
            uv = int(rng.integers(0, 4))
            bw.put(142, uv != 0)
            if uv:
                bw.put(114, uv != 2)
                if uv != 2:
                    bw.put(183, uv == 1)
            mbs.append((y, x, is4, skipped, seg))
    first = bw.finish()
    # the tokens: each block's coefficients, mostly zero and small
    parts = [BoolWriter() for _ in range(partitions)]
    tops = [[0] * 9 for _ in range(mbw)]
    lefts = [0] * 9
    for y, x, is4, skipped, seg in mbs:
        if x == 0:
            lefts = [0] * 9
        t = tops[x]
        if skipped:
            for k in range(9 if not is4 else 8):
                t[k] = lefts[k] = 0
            continue
        pw = parts[y % partitions]
        plan = ([(3, 0, k) for k in range(16)] if is4 else
                [(1, 0, 24)] + [(0, 1, k) for k in range(16)])
        plan += [(2, 0, 16 + k) for k in range(8)]
        for typ, first_pos, blk in plan:
            if blk == 24:
                ta = la = 8
            elif blk < 16:
                ta, la = blk & 3, blk >> 2
            else:
                ch = 4 if blk < 20 else 6
                ta, la = ch + ((blk - 16) & 1), ch + (((blk - 16) & 3) >> 1)
            last = int(rng.integers(first_pos, 17))
            coeffs = np.zeros(16, np.int64)
            if last > first_pos:
                mag = rng.choice([1, 1, 1, 2, 3, 5, 8, 12, 25, 70, 400]
                                 + ([] if exact else [1500, 2100]),
                                 last - first_pos)
                zero = rng.random(last - first_pos) < 0.4
                sign = rng.choice([-1, 1], last - first_pos)
                coeffs[first_pos:last] = np.where(zero, 0, mag * sign)
                if exact:
                    dc_top, ac_top = limits[seg][typ]
                    coeffs[1:] = np.clip(coeffs[1:], -ac_top, ac_top)
                    coeffs[0] = np.clip(coeffs[0], -dc_top, dc_top)
            nz = int(np.flatnonzero(coeffs)[-1]) + 1 if coeffs.any() else 0
            ctx = t[ta] + lefts[la]
            n = first_pos
            prev_zero = False
            while n < 16:
                p = probs[((typ * 8 + BANDS[n]) * 3 + ctx) * 11:][:11]
                if not prev_zero:
                    pw.put(p[0], n < nz)
                    if n >= nz:
                        break
                v = int(coeffs[n])
                pw.put(p[1], v != 0)
                if v == 0:
                    prev_zero, ctx = True, 0
                else:
                    _put_coeff(pw, p, v)
                    prev_zero, ctx = False, 1 if abs(v) == 1 else 2
                n += 1
            t[ta] = lefts[la] = int(nz > first_pos)
    tail = [p.finish() for p in parts]
    sizes = b"".join(len(p).to_bytes(3, "little") for p in tail[:-1])
    tag = (len(first) << 5) | 0x10                 # key frame, shown
    return (tag.to_bytes(3, "little") + b"\x9d\x01\x2a"
            + struct.pack("<HH", w, h) + first + sizes + b"".join(tail))


class BitWriterL:
    """The LSB-first bit writer of the lossless (VP8L) bitstream."""

    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, value: int, bits: int) -> None:
        self.v |= (value & ((1 << bits) - 1)) << self.n
        self.n += bits

    def code(self, codes: dict, symbol: int) -> None:
        """A prefix-coded symbol: its canonical code, first bit first."""
        code, n = codes[symbol]
        self.put(int(f"{code:0{n}b}"[::-1], 2) if n else 0, n)

    def finish(self) -> bytes:
        return self.v.to_bytes((self.n + 7) // 8, "little")


def _complete_lengths(used, size: int, rng) -> list:
    """Code lengths over `size` symbols giving each used one a length and
    forming a complete code (one used symbol: one of length 1)."""
    used = sorted(set(used)) or [0]
    lengths = [0] * size
    if len(used) == 1:
        lengths[used[0]] = 1
        return lengths
    top = (len(used) - 1).bit_length()
    short = (1 << top) - len(used)        # at top - 1 bits, the rest at top
    for k, sym in enumerate(rng.permutation(used).tolist()):
        lengths[sym] = top - 1 if k < short else top
    return lengths


def _canonical(lengths: list) -> dict:
    """{symbol: (code, length)} of a canonical code (one symbol: no bits)."""
    syms = sorted((n, s) for s, n in enumerate(lengths) if n)
    if len(syms) == 1:
        return {syms[0][1]: (0, 0)}
    out, code, prev = {}, 0, syms[0][0]
    for n, s in syms:
        code <<= n - prev
        prev = n
        out[s] = (code, n)
        code += 1
    return out


def _put_lengths(bw: BitWriterL, lengths: list, rng) -> None:
    """A prefix code's lengths in the normal form: runs as repeat codes
    16 (the last non-zero length), 17 and 18 (zeros), a random
    max_symbol where the tail allows it, through a code-length code."""
    toks, i, prev = [], 0, 8
    while i < len(lengths):
        n = lengths[i]
        run = 1
        while i + run < len(lengths) and lengths[i + run] == n:
            run += 1
        if n == 0 and run >= 11:
            r = min(run, 138)
            toks.append((18, r - 11, 7))
        elif n == 0 and run >= 3:
            r = min(run, 10)
            toks.append((17, r - 3, 3))
        elif n == prev and run >= 3:
            r = min(run, 6)
            toks.append((16, r - 3, 2))
        else:
            r = 1
            toks.append((n, 0, 0))
        if n:
            prev = n
        i += r
    # the trailing zeros past max_symbol need not be written
    last = max(k for k, t in enumerate(toks) if t[0] not in (17, 18)
               or k == 0)
    cut = rng.random() < 0.5 and 2 <= last + 1 < len(toks)
    if cut:
        toks = toks[:last + 1]
    cl = _complete_lengths([t[0] for t in toks], 19, rng)
    codes = _canonical(cl)
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
             15)
    count = max(4, max(k for k, c in enumerate(order) if cl[c]) + 1)
    bw.put(0, 1)                                 # the normal form
    bw.put(count - 4, 4)
    for c in order[:count]:
        bw.put(cl[c], 3)
    bw.put(cut, 1)
    if cut:
        m = len(toks) - 2
        nbits = max(2, m.bit_length() + (m.bit_length() & 1))
        bw.put((nbits - 2) // 2, 3)
        bw.put(m, nbits)
    for sym, extra, bits in toks:
        bw.code(codes, sym)
        if bits:
            bw.put(extra, bits)


def _put_code(bw: BitWriterL, used, size: int, rng) -> dict:
    """A prefix code over the symbols used (the simple form where one or
    two small ones are), written; returns its codes."""
    used = sorted(set(used)) or [0]
    if len(used) <= 2 and max(used) < 256 and rng.random() < 0.7:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        wide = used[0] > 1 or rng.random() < 0.5
        bw.put(wide, 1)
        bw.put(used[0], 8 if wide else 1)
        if len(used) == 2:
            bw.put(used[1], 8)
        lengths = [0] * size
        for u in used:
            lengths[u] = 1
        return _canonical(lengths)
    lengths = _complete_lengths(used, size, rng)
    _put_lengths(bw, lengths, rng)
    return _canonical(lengths)


def _prefix(v: int) -> tuple:
    """(symbol, extra bits, their count) of an LZ77 length or distance."""
    d = v - 1
    if d < 4:
        return d, 0, 0
    hb = d.bit_length() - 1
    second = (d >> (hb - 1)) & 1
    return 2 * hb + second, d & ((1 << (hb - 1)) - 1), hb - 1


def _put_image(bw: BitWriterL, w: int, h: int, px: list, rng,
               main: bool) -> None:
    """An entropy-coded image of packed ARGB `px`: a colour cache, meta
    prefix codes (the main image) and LZ77 copies at random."""
    from rlshaders_tpu_torch.scene.vp8l import CACHE_MULT, DISTANCE_MAP
    cache_bits = int(rng.integers(1, 12)) if rng.random() < 0.5 else 0
    bw.put(cache_bits > 0, 1)
    if cache_bits:
        bw.put(cache_bits, 4)
    meta_bits, groups = 0, 1
    if main and rng.random() < 0.5:
        meta_bits = int(rng.integers(2, 5))
        mw, mh = (w + (1 << meta_bits) - 1) >> meta_bits, \
            (h + (1 << meta_bits) - 1) >> meta_bits
        mpx = [m << 8 for m in rng.integers(0, 3, mw * mh).tolist()]
        bw.put(1, 1)
        bw.put(meta_bits - 2, 3)
        _put_image(bw, mw, mh, mpx, rng, False)   # its copies change it
        meta = [(m >> 8) & 0xFFFF for m in mpx]
        groups = max(meta) + 1
    elif main:
        bw.put(0, 1)
    # the ops: literals, copies and cache hits, as the decoder will see
    ops, cache = [], {}
    i = 0
    while i < len(px):
        y, x = divmod(i, w)
        g = meta[(y >> meta_bits) * mw + (x >> meta_bits)] if meta_bits else 0
        key = ((px[i] * CACHE_MULT) & 0xFFFFFFFF) >> (32 - cache_bits) \
            if cache_bits else None
        r = rng.random()
        if i and r < 0.25:
            length = int(min(len(px) - i, rng.integers(1, 40)))
            if rng.random() < 0.5:
                code = int(rng.integers(1, 121))
                dx, dy = DISTANCE_MAP[code - 1]
                dist = max(dx + dy * w, 1)
            else:
                dist = int(rng.integers(1, i + 1))
                code = dist + 120
            if dist <= i:
                for k in range(length):
                    px[i + k] = px[i + k - dist]
                ops.append((g, "copy", length, code))
                if cache_bits:
                    for k in range(length):
                        c = px[i + k]
                        cache[((c * CACHE_MULT) & 0xFFFFFFFF)
                              >> (32 - cache_bits)] = c
                i += length
                continue
        if cache_bits and cache.get(key) == px[i] and r < 0.6:
            ops.append((g, "cache", key))
        else:
            ops.append((g, "lit", px[i]))
        if cache_bits:
            cache[key] = px[i]
        i += 1
    # each group's codes over the symbols its ops use
    sizes = (256 + 24 + ((1 << cache_bits) if cache_bits else 0), 256, 256,
             256, 40)
    used = [[[] for _ in range(5)] for _ in range(groups)]
    for op in ops:
        u = used[op[0]]
        if op[1] == "lit":
            a = op[2]
            for k, s in enumerate(((a >> 8) & 255, (a >> 16) & 255,
                                   a & 255, a >> 24)):
                u[k].append(s)
        elif op[1] == "cache":
            u[0].append(280 + op[2])
        else:
            u[0].append(256 + _prefix(op[2])[0])
            u[4].append(_prefix(op[3])[0])
    codes = [[_put_code(bw, used[gi][k], sizes[k], rng) for k in range(5)]
             for gi in range(groups)]
    for op in ops:
        c = codes[op[0]]
        if op[1] == "lit":
            a = op[2]
            bw.code(c[0], (a >> 8) & 255)
            bw.code(c[1], (a >> 16) & 255)
            bw.code(c[2], a & 255)
            bw.code(c[3], a >> 24)
        elif op[1] == "cache":
            bw.code(c[0], 280 + op[2])
        else:
            for k, v in ((0, op[2]), (4, op[3])):
                sym, extra, n = _prefix(v)
                bw.code(c[k], (256 if k == 0 else 0) + sym)
                bw.put(extra, n)


def vp8l_stream(w: int, h: int, seed: int, transforms=(0, 1, 2, 3),
                colours: int = 16) -> bytes:
    """A VP8L bitstream (a VP8L chunk's payload) of seeded residuals
    under the transforms given, in that order (0 predictor with every
    mode 0-15 among its tiles, 1 cross-colour, 2 subtract-green, 3 colour
    indexing of `colours` colours whose indices run past the palette),
    each image with a colour cache, meta prefix codes, LZ77 copies by
    both distance forms and codes of both forms at random. What PIL's
    writer never sets; its decode is what libwebp makes of it."""
    rng = np.random.default_rng(seed)
    bw = BitWriterL()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(1, 1)
    bw.put(0, 3)
    xs = w
    for t in transforms:
        bw.put(1, 1)
        bw.put(t, 2)
        if t in (0, 1):
            bits = int(rng.integers(2, 5))
            bw.put(bits - 2, 3)
            tw, th = (xs + (1 << bits) - 1) >> bits, \
                (h + (1 << bits) - 1) >> bits
            sub = rng.integers(0, 1 << 32, tw * th, dtype=np.uint64)
            if t == 0:
                sub = (sub & ~np.uint64(0xF00)) | (
                    (np.arange(tw * th, dtype=np.uint64) % 16) << 8)
            _put_image(bw, tw, th, sub.tolist(), rng, False)
        elif t == 3:
            bw.put(colours - 1, 8)
            pal = rng.integers(0, 1 << 32, colours, dtype=np.uint64)
            _put_image(bw, colours, 1, pal.tolist(), rng, False)
            bits = 0 if colours > 16 else 1 if colours > 4 else \
                2 if colours > 2 else 3
            xs = (xs + (1 << bits) - 1) >> bits
    bw.put(0, 1)
    px = rng.integers(0, 1 << 32, xs * h, dtype=np.uint64)
    if 3 in transforms:                # indices, some past the palette
        px = px & ~np.uint64(0xFF00) | (rng.integers(
            0, 256, xs * h).astype(np.uint64) << 8)
    _put_image(bw, xs, h, px.tolist(), rng, True)
    return bw.finish()


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def _pil(px: np.ndarray, mode: str, fmt: str, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    img = Image.fromarray(px)
    if mode == "P":
        img = img.convert("RGB").quantize(16, dither=0)
    elif mode:
        img = img.convert(mode)
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def big_dds() -> bytes:
    """The 2048x2048 texture of make_image_modes in DXT1 blocks."""
    return _pil(modes.big_texture(), "RGB", "DDS", pixel_format="DXT1")


def files() -> dict:
    """{name in scenes/data/formats: bytes} of every committed file."""
    from PIL import Image
    grid, logo = modes._png_pixels("grid.png"), modes._png_pixels("logo.png")
    lrgba = np.asarray(Image.open(os.path.join(modes.DATA, "logo.png")))
    gpal, gidx = modes._indexed(grid)
    lpal, lidx = modes._indexed(logo)
    ggrey = np.asarray(Image.fromarray(grid).convert("L"))
    lgrey = np.asarray(Image.fromarray(logo).convert("L"))
    half = lrgba[::2, ::2]
    return {
        # frame C
        "texture_2048_dxt1.dds": big_dds(),
        "logo_rle.tga": _pil(lrgba, "RGBA", "TGA", rle=True),
        "logo_jpeg.tif": _pil(logo, "RGB", "TIFF", compression="jpeg",
                              quality=90),
        # frame D
        "grid.qoi": _pil(grid, "RGB", "QOI"),
        "logo_palette.pcx": _pil(logo, "P", "PCX"),
        "logo_group4.tif": _pil(lgrey, "1", "TIFF", compression="group4"),
        # TIFF
        "grid_ycbcr420_tiles_jpeg.tif": tiff_jpeg_bytes(grid, tile=(64, 48)),
        "grid_group3_2d_fill_lsb_minwhite.tif": _pil(
            ggrey, "1", "TIFF", compression="group3",
            tiffinfo={292: 5, 266: 2, 262: 0}),
        "logo_mh_strips.tif": _pil(lgrey, "1", "TIFF",
                                   compression="tiff_ccitt", strip_size=380),
        # DIB
        "logo_palette.dib": _pil(logo, "P", "DIB"),
        # TGA
        "grid_grey_topdown.tga": _pil(grid[::2, ::2], "L", "TGA",
                                      orientation=1),
        "grid_cmap16_mirrored_rle.tga": tga_bytes(
            gidx[::2] + 3, 9, 8, cmap=gpal, cmap_depth=16, cmap_start=3,
            flags=0x30, across=True),
        "logo_bgr15_half.tga": tga_bytes(half, 2, 16),
        # PNM
        "grid_ascii.ppm": pnm_bytes(grid[::4, ::4], "P3"),
        "logo_rgb12.ppm": pnm_bytes(
            logo[::3, ::3].astype(np.int64) * 4095 // 255, "P6", 4095),
        "grid_bits.pbm": _pil(ggrey, "1", "PPM"),
        "logo.pfm": _pil(lgrey[::3, ::3].astype(np.float32) * 1.3 - 20.0,
                         "F", "PPM"),
        # DDS
        "logo_dxt5.dds": _pil(lrgba, "RGBA", "DDS", pixel_format="DXT5"),
        "grid_bc5_half.dds": _pil(grid[::2, ::2], "RGB", "DDS",
                                  pixel_format="BC5"),
        "logo_rgb_half.dds": _pil(half, "RGB", "DDS"),
        # SGI, PCX, QOI
        "grid_rle.sgi": sgi_bytes(grid),
        "logo_rgba_half.sgi": _pil(half, "RGBA", "SGI"),
        "grid_rgb.pcx": _pil(grid, "RGB", "PCX"),
        "grid_planes4.pcx": pcx_planes_bytes(gidx, gpal, 4),
        "logo_rgba.qoi": _pil(lrgba, "RGBA", "QOI"),
    }


def big_bc7() -> bytes:
    """The 2048x2048 texture of make_image_modes in BC7 blocks, block i in
    mode i % 8 with partition (i // 8) modulo the mode's count, rotation
    i // 8 and index selector i // 32 (modes 4 and 5): every mode, every
    partition of each mode and every rotation and selector occur."""
    tex = modes.big_texture()
    rgba = np.concatenate([tex, np.full(tex.shape[:2] + (1,), 255,
                                        np.uint8)], -1)
    i = np.arange((tex.shape[0] // 4) * (tex.shape[1] // 4))
    body = bc7_blocks(rgba, i % 8, i // 8, i // 8, i // 32)
    return dds_bytes(tex.shape[1], tex.shape[0], body, 0x4, b"DX10",
                     dxgi=98)


def _bc6h_dds(rgb: np.ndarray, signed: bool) -> bytes:
    """BC6H blocks of rgb, block i in mode i % 14 with partition i // 14."""
    i = np.arange(-(-rgb.shape[0] // 4) * -(-rgb.shape[1] // 4))
    return dds_bytes(rgb.shape[1], rgb.shape[0],
                     bc6h_blocks(rgb, i % 14, i // 14, signed), 0x4, b"DX10",
                     dxgi=96 if signed else 95)


def files_b() -> dict:
    """{name in scenes/data/formats_b: bytes} of every committed file: the
    game-texture and icon formats PIL opens beyond those of files()."""
    from PIL import Image
    grid, logo = modes._png_pixels("grid.png"), modes._png_pixels("logo.png")
    lrgba = np.asarray(Image.open(os.path.join(modes.DATA, "logo.png")))
    ggrey = np.asarray(Image.fromarray(grid).convert("L"))
    lgrey = np.asarray(Image.fromarray(logo).convert("L"))
    gpal, gidx = modes._indexed(grid)
    lpal, lidx = modes._indexed(logo)
    g128 = grid[::2, ::2]
    g128a = np.concatenate([g128, np.full((128, 128, 1), 255, np.uint8)], -1)
    # the logo at ICNS's 128x128 (nearest sample)
    l128 = logo[np.arange(128) * 200 // 128][:, np.arange(128) * 300 // 128]
    l16 = logo[np.arange(16) * 200 // 16][:, np.arange(16) * 300 // 16]
    return {
        # frame E
        "texture_2048_bc7.dds": big_bc7(),
        "logo_bc6h_sf16.dds": _bc6h_dds(logo, True),
        "logo_dxt3.blp": blp_dxt(lrgba, "DXT3"),
        # frame F
        "grid_bmp32.ico": icon_bytes([
            (64, 64, 0, 1, 8, icon_dib(gidx[::4, ::4], 8, gpal)),
            (128, 128, 0, 1, 32, icon_dib(g128a[..., :3], 32,
                                          and_mask=False)),
            (32, 32, 16, 1, 4, icon_dib(gidx[::8, ::8], 4, gpal)),
            (16, 16, 2, 1, 1, icon_dib(gidx[::16, ::16] % 2, 1,
                                       [(0, 0, 0), (255, 255, 255)]))]),
        "logo_it32.icns": icns_bytes([
            (b"is32", icns_rgb(l16)), (b"s8mk", bytes(256)),
            (b"it32", icns_rgb(l128, it32=True)),
            (b"t8mk", np.full(128 * 128, 255, np.uint8).tobytes())]),
        "logo_palette.im": _pil(logo, "P", "IM"),
        # DDS: BC4, BC6H, BC7
        "grid_bc4_ati1.dds": dds_bytes(256, 256, bc4_blocks(ggrey), 0x4,
                                       b"ATI1"),
        "logo_bc4_odd.dds": dds_bytes(149, 99, bc4_blocks(
            lgrey[1::2, 1::2][:99, :149]), 0x4, b"DX10", dxgi=80),
        "grid_bc6h_uf16.dds": _bc6h_dds(g128, False),
        "logo_bc7_srgb.dds": dds_bytes(
            150, 100, bc7_blocks(lrgba[::2, ::2], np.arange(950) % 8,
                                 np.arange(950) // 8, np.arange(950) // 8,
                                 np.arange(950) // 32), 0x4, b"DX10",
            dxgi=99),
        # BLP
        "logo_jpeg.blp": blp_jpeg(logo),
        "logo_palette.blp": _pil(logo, "P", "BLP", blp_version="BLP1"),
        "grid_palette.blp": _pil(grid, "P", "BLP"),
        "grid_dxt1.blp": blp_dxt(np.concatenate(
            [grid, np.full((256, 256, 1), 255, np.uint8)], -1), "DXT1", 0),
        "logo_dxt5_odd.blp": blp_dxt(lrgba[::2, ::2][:, :149], "DXT5"),
        # ICO, CUR, ICNS
        "logo_png.ico": _pil(lrgba, "RGBA", "ICO"),
        "logo.cur": icon_bytes([
            (32, 32, 0, 3, 5, icon_dib(lidx[::6, ::9][:32, :32], 8, lpal)),
            (150, 100, 0, 7, 9, icon_dib(logo[::2, ::2], 24)),
            (100, 150, 0, 0, 0, icon_dib(logo[::2, ::2][:, :100].transpose(
                1, 0, 2)[:150].copy(), 24))], cursor=True),
        "grid_png.icns": icns_bytes([
            (b"is32", icns_rgb(grid[::16, ::16], rle=False)),
            (b"ic07", modes.png_bytes(g128, 8, 2))]),
        # IM, MSP, XBM
        "grid_rgb.im": _pil(g128, "RGB", "IM"),
        "logo_ycc.im": _pil(logo[::2, ::2], "YCbCr", "IM"),
        "logo_f32.im": _pil(lgrey[::2, ::2].astype(np.float32) * 1.3 - 20.0,
                            "F", "IM"),
        "grid.msp": _pil(ggrey, "1", "MSP"),
        "logo_rle.msp": msp2_bytes(lgrey > 100),
        "grid.xbm": _pil(ggrey, "1", "XBM"),
    }


def big_webp() -> bytes:
    """The 2048x2048 texture of make_image_modes as a lossy WebP at
    quality 90 (a single VP8 chunk, about 225 KB)."""
    return _pil(modes.big_texture(), "RGB", "WEBP", quality=90)


def _srgb_icc() -> bytes:
    """LittleCMS's sRGB profile, its creation date fixed (bytes 24-35) so
    that the file is the same at every run."""
    from PIL import ImageCms
    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    return icc[:24] + struct.pack(">6H", 2025, 1, 1, 0, 0, 0) + icc[36:]


def files_c() -> dict:
    """{name in scenes/data/formats_c: bytes} of every committed file:
    SPIDER and still WebP (lossless VP8L, lossy VP8, VP8X with alpha and
    metadata), PIL's writes but for the VP8 and VP8L features its writer
    never sets (vp8_frame, vp8l_stream)."""
    from PIL import Image
    grid, logo = modes._png_pixels("grid.png"), modes._png_pixels("logo.png")
    lrgba = np.asarray(Image.open(os.path.join(modes.DATA, "logo.png")))
    ggrey = np.asarray(Image.fromarray(grid).convert("L"))
    lgrey = np.asarray(Image.fromarray(logo).convert("L"))
    crop = modes.big_texture()[600:728, 900:1028]          # 128x128
    c200 = np.asarray(Image.fromarray(crop).quantize(200, dither=0)
                      .convert("RGB"))
    c12 = np.asarray(Image.fromarray(crop).quantize(12, dither=0)
                     .convert("RGB"))
    ainv = lrgba.copy()
    ainv[..., 3] = np.where(lgrey > 100, 255, 90)          # half see-through
    return {
        # frame G
        "texture_2048.webp": big_webp(),
        "logo_rgba_lossless.webp": _pil(lrgba, "RGBA", "WEBP", lossless=True,
                                        method=4),
        "logo_alpha_lossy.webp": _pil(ainv, "RGBA", "WEBP", quality=80),
        # frame H
        "grid_half.spider": _pil(ggrey[::2, ::2], "L", "SPIDER"),
        "logo_palette_lossless.webp": _pil(logo, "RGB", "WEBP",
                                           lossless=True),
        "logo_q5.webp": _pil(logo, "RGB", "WEBP", quality=5),
        # VP8L: both methods' extremes, a <= 16 and a <= 256 colour image
        "grid_lossless_m0.webp": _pil(grid, "RGB", "WEBP", lossless=True,
                                      method=0),
        "grid_lossless_m6.webp": _pil(grid, "RGB", "WEBP", lossless=True,
                                      method=6),
        "logo_rgba_lossless_m0.webp": _pil(lrgba, "RGBA", "WEBP",
                                           lossless=True, method=0),
        "crop_lossless_m0.webp": _pil(crop, "RGB", "WEBP", lossless=True,
                                      method=0, quality=50),
        "crop_lossless_m6.webp": _pil(crop, "RGB", "WEBP", lossless=True,
                                      method=6),
        "crop_200colours_lossless.webp": _pil(c200, "RGB", "WEBP",
                                              lossless=True),
        "crop_12colours_lossless.webp": _pil(c12, "RGB", "WEBP",
                                             lossless=True, method=6),
        # VP8 at three qualities and sizes no multiple of 16
        "grid_q50.webp": _pil(grid, "RGB", "WEBP", quality=50),
        "crop_q100.webp": _pil(crop, "RGB", "WEBP", quality=100),
        "logo_odd_q75.webp": _pil(logo[1::2, 1::2][:99, :149], "RGB", "WEBP"),
        "crop_17x33.webp": _pil(crop[:33, :17], "RGB", "WEBP", quality=60),
        "pixel_1x1.webp": _pil(crop[:1, :1], "RGB", "WEBP", quality=90),
        # VP8X: alpha, an ICC profile, EXIF
        "grid_icc.webp": _pil(grid, "RGB", "WEBP", quality=70,
                              icc_profile=_srgb_icc()),
        "logo_alpha_exif.webp": _pil(
            lrgba, "RGBA", "WEBP", quality=40,
            exif=b"Exif\x00\x00MM\x00*\x00\x00\x00\x08\x00\x00"),
        # VP8 features PIL's writer never sets
        "vp8_simple_filter.webp": riff_webp([(b"VP8 ", vp8_frame(
            75, 50, 1, simple=True, level=30, sharpness=2))]),
        "vp8_partitions8_sharp.webp": riff_webp([(b"VP8 ", vp8_frame(
            64, 130, 2, partitions=8, sharpness=6, level=40))]),
        "vp8_segments_deltas.webp": riff_webp([(b"VP8 ", vp8_frame(
            90, 70, 3, segments=True, deltas=True, partitions=2))]),
        # VP8L features PIL's writer never sets: predictor modes 0-15,
        # indices past the palette
        "vp8l_all_predictors.webp": riff_webp([(b"VP8L", vp8l_stream(
            61, 37, 5, (2, 0, 1)))]),
        "vp8l_palette5_past.webp": riff_webp([(b"VP8L", vp8l_stream(
            45, 29, 6, (3,), colours=5))]),
        # SPIDER: from "F" (values past 0..255, negative and fractional),
        # big-endian, a stack
        "logo_f32.spider": _pil(lgrey[::2, ::2].astype(np.float32) * 1.3
                                - 20.25, "F", "SPIDER"),
        "grid_big_endian.spider": spider_bytes(
            ggrey[::4, ::4].astype(np.float32) * 0.9 + 0.5, ">"),
        "logo_stack.spider": spider_bytes(
            lgrey[::4, ::4].astype(np.float32), "<", stack=3),
    }


def j2k_boxes(kind: bytes, body: bytes) -> bytes:
    """A JP2 box: its length, its type, its body."""
    return struct.pack(">I4s", 8 + len(body), kind) + body


def jp2_wrap(codestream: bytes, w: int, h: int, nc: int, extra: bytes = b"",
             colr: bytes = b"\x01\x00\x00\x00\x00\x00\x10",
             bpc: int = 7) -> bytes:
    """A JP2 file around a J2K codestream: signature, file type, a header
    box of ihdr, colr (sRGB by default, None for none) and `extra` boxes,
    then the codestream box. PIL writes no palette boxes, so palette files
    are built here around PIL's codestream."""
    ihdr = struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0)
    head = j2k_boxes(b"ihdr", ihdr) + (
        j2k_boxes(b"colr", colr) if colr is not None else b"") + extra
    return (j2k_boxes(b"jP  ", b"\r\n\x87\n")
            + j2k_boxes(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + j2k_boxes(b"jp2h", head) + j2k_boxes(b"jp2c", codestream))


def pclr_cmap(palette: np.ndarray) -> bytes:
    """A JP2 palette box ((n, 3 or 4) uint8 entries, 8 bits each) and the
    component mapping box that sends component 0 through every column."""
    n, cols = palette.shape
    pclr = struct.pack(">HB", n, cols) + bytes([7] * cols) + bytes(
        np.asarray(palette, np.uint8).ravel())
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(cols))
    return j2k_boxes(b"pclr", pclr) + j2k_boxes(b"cmap", cmap)


def jp2_palette(rgb: np.ndarray, colours: int, **kw) -> bytes:
    """`rgb` quantized to `colours` colours as a JP2 file of palette
    indices (PIL's lossless codestream of them as "L") with its pclr and
    cmap boxes."""
    from PIL import Image
    q = Image.fromarray(rgb).quantize(colours, dither=0)
    pal = np.asarray(q.getpalette()[:3 * colours], np.uint8).reshape(-1, 3)
    idx = np.asarray(q)
    stream = _pil(idx, "L", "JPEG2000", no_jp2=True, **kw)
    return jp2_wrap(stream, idx.shape[1], idx.shape[0], 1, pclr_cmap(pal))


def webp_chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a WebP file's chunks."""
    out, pos = [], 12
    while pos < len(data):
        kind, n = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def anmf(x: int, y: int, w: int, h: int, chunks: list, duration: int = 100,
         bits: int = 0) -> bytes:
    """An ANMF payload: the frame's place (x and y even), size, duration
    and blend and dispose bits, then its image chunks."""
    head = b"".join((v).to_bytes(3, "little") for v in (
        x // 2, y // 2, w - 1, h - 1, duration)) + bytes([bits])
    return head + b"".join(k + struct.pack("<I", len(p)) + p
                           + b"\x00" * (len(p) & 1) for k, p in chunks)


def animated_webp(w: int, h: int, flags: int, frames: list,
                  background: int = 0xFF404040) -> bytes:
    """An animated WebP: VP8X (the animation flag and `flags`), ANIM and
    one ANMF chunk for each payload of `frames`."""
    return riff_webp([(b"VP8X", vp8x_chunk(w, h, 0x02 | flags)),
                      (b"ANIM", struct.pack("<IH", background, 0))]
                     + [(b"ANMF", f) for f in frames])


def big_jp2() -> bytes:
    """The 2048x2048 texture of make_image_modes as JPEG 2000 as cinema and
    archive plates ship: the 9/7 wavelet, the ICT, three quality layers
    (compression 200, 100 and 50), about 250 KB."""
    return _pil(modes.big_texture(), "RGB", "JPEG2000", irreversible=True,
                mct=1, quality_layers=[200, 100, 50])


def files_d() -> dict:
    """{name in scenes/data/formats_d: bytes} of every committed file:
    JPEG 2000 (J2K and JP2 files and an ICNS entry) as PIL writes it, a
    palette JP2 around PIL's codestream, and animated WebP, one file PIL
    writes and one built here with its first frame inside a larger
    canvas."""
    from PIL import Image
    grid, logo = modes._png_pixels("grid.png"), modes._png_pixels("logo.png")
    lrgba = np.asarray(Image.open(os.path.join(modes.DATA, "logo.png")))
    lgrey = np.asarray(Image.fromarray(logo).convert("L"))
    crop = modes.big_texture()[600:728, 900:1028]          # 128x128
    odd = crop[:97, :75]
    grey16 = (lgrey.astype(np.uint16) * 3 // 2
              + np.arange(300, dtype=np.uint16)[None] % 7)
    la = np.stack([lgrey, np.where(lgrey > 100, 255, 70).astype(np.uint8)],
                  -1)
    ainv = lrgba.copy()
    ainv[..., 3] = np.where(lgrey > 100, 255, 90)          # half see-through
    still = webp_chunks(_pil(ainv[::2, ::2], "RGBA", "WEBP", quality=70))
    lossy = [c for c in still if c[0] in (b"ALPH", b"VP8 ")]
    second = webp_chunks(_pil(logo[::4, ::4], "RGB", "WEBP", lossless=True))
    frames = [Image.fromarray(np.roll(grid, 37 * k, axis=1)).convert("RGB")
              for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=True, duration=80)
    return {
        # frame I
        "texture_2048.jp2": big_jp2(),
        "logo_rgba_lossless.jp2": _pil(lrgba, "RGBA", "JPEG2000", mct=1),
        "logo_anim_lossy.webp": animated_webp(190, 130, 0x10, [
            anmf(20, 14, 150, 100, lossy),
            anmf(0, 0, 75, 50, [c for c in second if c[0] == b"VP8L"])]),
        # frame J
        "crop_palette.jp2": jp2_palette(crop, 200),
        "grid_tiles_rpcl.j2k": _pil(
            grid, "RGB", "JPEG2000", no_jp2=True, tile_size=(96, 80),
            tile_offset=(3, 2), offset=(7, 5), progression="RPCL",
            num_resolutions=4),
        "grid_anim_lossless.webp": buf.getvalue(),
        # I;16 (clamped to 255 by convert("RGB")) and LA
        "logo_grey16.jp2": _pil(grey16, "I;16", "JPEG2000"),
        "logo_la.jp2": _pil(la, "LA", "JPEG2000", irreversible=True),
        # the five progression orders, with precincts, code-blocks of
        # 16 or 32, quality layers, odd sizes and an image offset
        "crop_lrcp.j2k": _pil(odd, "RGB", "JPEG2000", no_jp2=True,
                              irreversible=True, mct=1, quality_mode="dB",
                              quality_layers=[30, 38, 45],
                              codeblock_size=(16, 16),
                              precinct_size=(64, 64)),
        "crop_rlcp.j2k": _pil(odd, "RGB", "JPEG2000", no_jp2=True,
                              progression="RLCP", quality_layers=[20, 5, 1],
                              codeblock_size=(32, 16), num_resolutions=3),
        "crop_rpcl.jp2": _pil(odd, "RGB", "JPEG2000", progression="RPCL",
                              irreversible=True, precinct_size=(32, 32),
                              codeblock_size=(16, 16), offset=(3, 9),
                              tile_size=(128, 128)),
        "crop_pcrl.j2k": _pil(crop, "RGB", "JPEG2000", no_jp2=True,
                              progression="PCRL", mct=1,
                              precinct_size=(64, 32), tile_size=(64, 64),
                              quality_layers=[8, 2], plt=True),
        "crop_cprl.j2k": _pil(odd, "RGB", "JPEG2000", no_jp2=True,
                              progression="CPRL", signed=True,
                              precinct_size=(32, 32), comment="CPRL"),
        # the digital cinema profiles Pillow accepts for 8 bits: tile-parts
        # and TLM, POC for 4K
        "crop_cinema2k.j2k": _pil(crop[:48, :64], "RGB", "JPEG2000",
                                  no_jp2=True, cinema_mode="cinema2k-24"),
        "crop_cinema4k.j2k": _pil(crop[:48, :64], "RGB", "JPEG2000",
                                  no_jp2=True, cinema_mode="cinema4k-24"),
        # ICNS with a JP2 entry (ic08, 256x256)
        "grid_jp2.icns": icns_bytes([
            (b"is32", icns_rgb(grid[::16, ::16], rle=False)),
            (b"ic08", _pil(grid, "RGB", "JPEG2000", irreversible=True,
                           quality_layers=[20]))]),
    }


def _avif(px: np.ndarray, mode: str, **kw) -> bytes:
    """PIL's AVIF of the pixels with one encoder thread: aom's bytes
    depend on its thread count, which Pillow takes from the host's cores
    unless it is given."""
    return _pil(px, mode, "AVIF", max_threads=1, **kw)


def big_avif() -> bytes:
    """The content of texture_2048.jp2 (PIL's decode of it) as AVIF at
    PIL's defaults (quality 75, speed 6, 4:2:0, autotiling: 4x2 tiles of
    128x128 superblocks), about 390 KB."""
    from PIL import Image
    src = os.path.join(modes.DATA, "formats_d", "texture_2048.jp2")
    return _avif(np.asarray(Image.open(src).convert("RGB")), "RGB")


def _exif(orientation: int) -> bytes:
    from PIL import Image
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()


def files_e() -> dict:
    """{name in scenes/data/formats_e: bytes} of every committed file: still
    AVIF as PIL 12.1 writes it through its documented options (quality,
    speed, subsampling, range, tiles, RGBA with and without premultiplied
    alpha, ICC, EXIF, XMP), and through `advanced` aom options that make
    aom use the coding tools its defaults leave out here (CDEF, delta q
    and lf, loop restoration of each kind), so that the files reach every
    intra tool aom writes."""
    from PIL import Image
    grid = modes._png_pixels("grid.png")
    lrgba = np.asarray(Image.open(os.path.join(modes.DATA, "logo.png")))
    crop = np.asarray(Image.open(os.path.join(
        modes.DATA, "formats_d", "texture_2048.jp2")).convert("RGB"))
    photo = crop[600:856, 900:1156]                         # 256x256
    odd = photo[:33, :17]
    ramp = np.arange(256)
    gradient = np.stack(np.broadcast_arrays(
        ramp[None, :], ramp[:, None], (ramp[None, :] + ramp[:, None]) // 2),
        -1).astype(np.uint8)
    icc = Image.open(os.path.join(modes.DATA, "logo.png")).info.get("icc")
    return {
        # frame K
        "texture_2048.avif": big_avif(),
        "logo_rgba.avif": _avif(lrgba, "RGBA"),
        "logo_premultiplied.avif": _avif(lrgba, "RGBA",
                                         alpha_premultiplied=True),
        # frame L
        "grid_lossless_444.avif": _avif(grid, "RGB", quality=100,
                                        subsampling="4:4:4"),
        "logo_grey_400.avif": _avif(lrgba, "RGBA", subsampling="4:0:0"),
        "logo_limited_422.avif": _avif(lrgba[..., :3], "RGB",
                                       subsampling="4:2:2",
                                       range="limited"),
        # flat colour at aom's screen-content speeds: palette, intra copy
        "grid_speed0.avif": _avif(grid, "RGB", speed=0, quality=60),
        "grid_q50.avif": _avif(grid, "RGB", quality=50),
        # the subsamplings, range, quality and speed extremes, tiles
        "photo_420_q0.avif": _avif(photo, "RGB", quality=0),
        "photo_422_q50.avif": _avif(photo, "RGB", quality=50,
                                    subsampling="4:2:2", speed=2),
        "photo_444_limited.avif": _avif(photo, "RGB", quality=70,
                                        subsampling="4:4:4",
                                        range="limited", speed=10),
        "photo_lossless.avif": _avif(photo[:64, :96], "RGB", quality=100),
        "photo_speed0.avif": _avif(photo, "RGB", quality=40, speed=0),
        "photo_tiles.avif": _avif(crop[:512, :1024], "RGB", quality=60,
                                  tile_rows=1, tile_cols=2,
                                  autotiling=False),
        # a smooth gradient at aom's lowest quality: 64x64 transforms
        "gradient_q5_speed0.avif": _avif(gradient, "RGB", quality=5,
                                         speed=0),
        # sizes
        "px_1x1.avif": _avif(photo[:1, :1], "RGB"),
        "odd_17x33.avif": _avif(odd, "RGB", quality=60),
        "odd_17x33_rgba.avif": _avif(np.dstack([odd, odd[..., 0]]), "RGBA",
                                     quality=60, subsampling="4:2:2"),
        # metadata: ICC, EXIF with an orientation (irot/imir), XMP
        "logo_icc_exif_xmp.avif": _avif(
            lrgba, "RGBA", icc_profile=icc or b"", exif=_exif(6),
            xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"),
        "grid_mirrored.avif": _avif(grid, "RGB", exif=_exif(2)),
        # aom tools its defaults do not reach here
        "photo_cdef.avif": _avif(photo, "RGB", quality=35, speed=2,
                                 advanced={"enable-cdef": "1"}),
        "photo_deltaq_lf.avif": _avif(photo, "RGB", quality=45, speed=4,
                                      advanced={"enable-cdef": "1",
                                                "deltaq-mode": "2",
                                                "delta-lf-mode": "1"}),
        "photo_restoration.avif": _avif(crop[:320, :320], "RGB",
                                        quality=25, speed=0,
                                        advanced={"enable-cdef": "1"}),
    }


def heif_box(typ: bytes, body: bytes, full: tuple = None) -> bytes:
    """An ISOBMFF box; `full` = (version, flags) makes it a full box."""
    if full is not None:
        body = struct.pack(">I", (full[0] << 24) | full[1]) + body
    return struct.pack(">I4s", 8 + len(body), typ) + body


def heif_children(data: bytes, at: int, end: int) -> list:
    """(type, start, end) of the boxes in data[at:end], each whole."""
    out = []
    while at < end:
        size, typ = struct.unpack_from(">I4s", data, at)
        out.append((typ, at, at + size))
        at += size
    return out


def avif_parts(data: bytes) -> dict:
    """The primary item's (and the alpha item's) AV1 payload and property
    boxes (av1C, colr) of a still AVIF file PIL wrote: {"color": (payload,
    {type: box}), "alpha": ... or None}."""
    top = {t: (a, e) for t, a, e in heif_children(data, 0, len(data))}
    a, e = top[b"meta"]
    meta = {t: (x, y) for t, x, y in heif_children(data, a + 12, e)}
    x, y = meta[b"iloc"]
    # PIL writes iloc version 0 with 4-byte offsets and lengths
    n = struct.unpack_from(">H", data, x + 14)[0]
    where = {}
    for k in range(n):
        item, _, _, off, length = struct.unpack_from(">HHHII", data,
                                                     x + 16 + 14 * k)
        where[item] = data[off:off + length]
    x, y = meta[b"iprp"]
    boxes = dict((t, (a2, e2)) for t, a2, e2 in heif_children(data, x + 8, y))
    a2, e2 = boxes[b"ipco"]
    props = [data[p:q] for _, p, q in heif_children(data, a2 + 8, e2)]
    a2, e2 = boxes[b"ipma"]
    assoc, at = {}, a2 + 16
    for _ in range(struct.unpack_from(">I", data, a2 + 12)[0]):
        item, count = struct.unpack_from(">HB", data, at)
        assoc[item] = [props[(b & 0x7F) - 1] for b in data[at + 3:
                                                            at + 3 + count]]
        at += 3 + count
    out = {}
    for k, item in enumerate(sorted(where)):
        got = {p[4:8]: p for p in assoc[item] if p[4:8] in (b"av1C",
                                                             b"colr")}
        out["color" if k == 0 else "alpha"] = (where[item], got)
    out.setdefault("alpha", None)
    return out


ALPHA_URN = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"


def avif_grid(tiles: list, rows: int, cols: int, out_w: int, out_h: int, *,
              ispe: tuple = None, big: bool = False,
              alpha: bool = False) -> bytes:
    """A HEIF file whose primary item is a grid (`rows` x `cols` cells,
    `out_w` x `out_h` output; 32-bit sizes where `big`) over the AV1
    payloads of `tiles`, still AVIF files PIL wrote, one a cell in row
    order: each tile an av01 item with its own ispe, av1C and pixi, the
    grid item with the first tile's colr and an ispe of `ispe` (the
    output size by default). With `alpha`, the tiles' alpha items make
    a second grid, auxiliary to the first."""
    parts = [avif_parts(t) for t in tiles]
    ispe = ispe or (out_w, out_h)
    props, items = [], []

    def prop(box: bytes) -> int:
        if box not in props:
            props.append(box)
        return props.index(box) + 1

    def ispe_box(w, h):
        return heif_box(b"ispe", struct.pack(">II", w, h), (0, 0))

    def pixi(n):
        return heif_box(b"pixi", bytes([n] + [8] * n), (0, 0))

    fmt = ">BBBBII" if big else ">BBBBHH"
    grid_body = struct.pack(fmt, 0, int(big), rows - 1, cols - 1, out_w,
                            out_h)
    planes = 1 if parts[0]["color"][1][b"av1C"][8 + 2] & 0x10 else 3
    grids = [("color", 1)] + ([("alpha", 1 + len(tiles) + 1)] if alpha
                              else [])
    refs = b""
    for kind, gid in grids:
        tile_ids = list(range(gid + 1, gid + 1 + len(parts)))
        for tid, p in zip(tile_ids, parts):
            payload, boxes = p[kind]
            h, w = _av1_size(payload)
            assoc = [prop(boxes[b"av1C"]) | 0x80, prop(ispe_box(w, h)),
                     prop(pixi(1 if kind == "alpha" else planes))]
            items.append((tid, b"av01", 1, payload, assoc))
        gassoc = [prop(ispe_box(*ispe)),
                  prop(pixi(1 if kind == "alpha" else planes))]
        if kind == "color" and b"colr" in parts[0]["color"][1]:
            gassoc.append(prop(parts[0]["color"][1][b"colr"]))
        if kind == "alpha":
            gassoc.append(prop(heif_box(b"auxC", ALPHA_URN, (0, 0))))
            refs += heif_box(b"auxl", struct.pack(">HHH", gid, 1, 1))
        items.append((gid, b"grid", 0, grid_body, gassoc))
        refs_body = struct.pack(">HH", gid, len(tile_ids)) + b"".join(
            struct.pack(">H", t) for t in tile_ids)
        refs = heif_box(b"dimg", refs_body) + refs
    items.sort()
    ftyp = heif_box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")
    hdlr = heif_box(b"hdlr", bytes(4) + b"pict" + bytes(12) + b"\0", (0, 0))
    pitm = heif_box(b"pitm", struct.pack(">H", 1), (0, 0))
    iinf = heif_box(b"iinf", struct.pack(">H", len(items)) + b"".join(
        heif_box(b"infe", struct.pack(">HH4s", i, 0, t) + b"\0",
                 (2, hidden)) for i, t, hidden, _, _ in items), (0, 0))
    iref = heif_box(b"iref", refs, (0, 0))
    ipco = heif_box(b"ipco", b"".join(props))
    ipma = heif_box(b"ipma", struct.pack(">I", len(items)) + b"".join(
        struct.pack(">HB", i, len(a)) + bytes(a)
        for i, _, _, _, a in items), (0, 0))
    iprp = heif_box(b"iprp", ipco + ipma)

    def meta(offsets):
        iloc = heif_box(b"iloc", struct.pack(">BBH", 0x44, 0, len(items))
                        + b"".join(struct.pack(">HHHII", i, 0, 1, off,
                                               len(body))
                                   for (i, _, _, body, _), off in
                                   zip(items, offsets)), (0, 0))
        return heif_box(b"meta", hdlr + pitm + iloc + iinf + iref + iprp,
                        (0, 0))
    size = len(ftyp) + len(meta([0] * len(items))) + 8
    offsets = []
    for _, _, _, body, _ in items:
        offsets.append(size)
        size += len(body)
    mdat = heif_box(b"mdat", b"".join(body for _, _, _, body, _ in items))
    return ftyp + meta(offsets) + mdat


def _av1_size(payload: bytes) -> tuple:
    """(height, width) of an AV1 still picture's sequence header (its
    maximum frame size, which PIL's writes use as the frame size)."""
    from rlshaders_tpu_torch.scene import av1
    seq = av1.sequence_header(payload, *next(
        (a, e) for t, _, _, a, e in av1.obus(payload) if t == 1))
    return seq["max_height"], seq["max_width"]


def _avif_frames(frames: list, mode: str, **kw) -> bytes:
    """PIL's AVIF image sequence (save_all) of the frames, one encoder
    thread, with the creation and modification times libavif writes
    into mvhd, tkhd and mdhd (the time of the run) set to 0, so that each
    run writes the same bytes."""
    from PIL import Image
    buf = io.BytesIO()
    imgs = [Image.fromarray(f).convert(mode) for f in frames]
    imgs[0].save(buf, "AVIF", save_all=True, append_images=imgs[1:],
                 max_threads=1, **kw)
    data = bytearray(buf.getvalue())

    def walk(at, end):
        for typ, a, e in heif_children(data, at, end):
            if typ in (b"moov", b"trak", b"mdia"):
                walk(a + 8, e)
            elif typ in (b"mvhd", b"tkhd", b"mdhd"):
                n = 16 if data[a + 8] == 1 else 8
                data[a + 12:a + 12 + n] = bytes(n)
    walk(0, len(data))
    return bytes(data)


def grain_flag(data: bytes, which: int) -> bytes:
    """The AVIF file with one flag at the end of its primary item's film
    grain parameters set (`which` 1: clip_to_restricted_range, 2:
    overlap_flag): PIL's writer (aom) sets no clipping."""
    from rlshaders_tpu_torch.scene import av1, avif
    payload = avif.parse(data)["color"]
    at = data.index(payload)
    seq = None
    for typ, tid, sid, a, e in av1.obus(payload):
        if typ == av1.OBU_SEQUENCE_HEADER:
            seq = av1.sequence_header(payload, a, e)
        elif typ == av1.OBU_FRAME:
            r = av1.BitReader(payload, a, e)
            frame = av1.frame_header(r, seq, tid, sid)
            assert frame["apply_grain"]
            bit = r.pos - which
            out = bytearray(data)
            out[at + (bit >> 3)] |= 0x80 >> (bit & 7)
            return bytes(out)
    raise ValueError("no frame")


def big_grid() -> bytes:
    """The 2048x2048 texture as a 2x2 grid of four 1024x1024 tiles, each
    PIL's AVIF at its defaults (one thread)."""
    from PIL import Image
    src = os.path.join(modes.DATA, "formats_d", "texture_2048.jp2")
    tex = np.asarray(Image.open(src).convert("RGB"))
    tiles = [_avif(np.ascontiguousarray(tex[r:r + 1024, c:c + 1024]), "RGB")
             for r in (0, 1024) for c in (0, 1024)]
    return avif_grid(tiles, 2, 2, 2048, 2048)


def _tiles(px: np.ndarray, rows: int, cols: int, tw: int, th: int,
           mode: str = "RGB", **kw) -> list:
    return [_avif(np.ascontiguousarray(px[r * th:(r + 1) * th,
                                          c * tw:(c + 1) * tw]), mode, **kw)
            for r in range(rows) for c in range(cols)]


def files_f(big: bool = True) -> dict:
    """{name in scenes/data/formats_f: bytes} of every committed file (but
    the two 2048x2048 ones where `big` is False): AVIF
    with aom's quantizer matrices (enable-qm, qm-min, qm-max) and film
    grain (its film-grain-test vectors 1-16: luma and chroma scaling,
    chroma from luma, AR lags 2 and 3, overlap), PIL's image sequences
    (save_all, with alpha) and grids this tool builds from PIL's AV1
    payloads (`avif_grid`; PIL writes none), at the subsamplings, odd
    sizes and 1x1, with alpha; one grain file has its clipping flag set
    (`grain_flag`), which aom never writes."""
    from PIL import Image
    lrgba = np.asarray(Image.open(os.path.join(modes.DATA, "logo.png")))
    tex = np.asarray(Image.open(os.path.join(
        modes.DATA, "formats_d", "texture_2048.jp2")).convert("RGB"))
    photo = tex[600:856, 900:1156]                          # 256x256
    odd = np.ascontiguousarray(photo[:33, :17])
    out = {
        # frame M (with texture_2048_grain.avif)
        "logo_sequence_rgba.avif": _avif_frames(
            [lrgba, lrgba[::-1].copy(), np.roll(lrgba, 40, 1)], "RGBA"),
        "logo_qm.avif": _avif(lrgba, "RGBA", quality=60,
                              advanced={"enable-qm": "1"}),
        # frame N (with texture_2048_grid.avif)
        "logo_qm_444_rgba.avif": _avif(lrgba, "RGBA", quality=55,
                                       subsampling="4:4:4",
                                       advanced={"enable-qm": "1",
                                                 "qm-min": "2",
                                                 "qm-max": "10"}),
        "logo_odd_grain_csfl.avif": _avif(
            np.ascontiguousarray(lrgba[:199, :299, :3]), "RGB", quality=50,
            advanced={"film-grain-test": "15"}),
        # quantizer matrices at each subsampling and level range
        "photo_qm_420.avif": _avif(photo, "RGB", quality=45, speed=4,
                                   advanced={"enable-qm": "1",
                                             "qm-min": "0", "qm-max": "6"}),
        "photo_qm_422.avif": _avif(photo, "RGB", quality=35, speed=2,
                                   subsampling="4:2:2",
                                   advanced={"enable-qm": "1"}),
        "photo_qm_400.avif": _avif(photo, "RGB", quality=30,
                                   subsampling="4:0:0",
                                   advanced={"enable-qm": "1",
                                             "qm-min": "4",
                                             "qm-max": "15"}),
        # film grain: test vectors over the subsamplings, sizes, alpha
        "photo_grain_400.avif": _avif(photo, "RGB", quality=50,
                                      subsampling="4:0:0",
                                      advanced={"film-grain-test": "6"}),
        "photo_grain_422.avif": _avif(photo, "RGB", quality=50,
                                      subsampling="4:2:2",
                                      advanced={"film-grain-test": "4"}),
        "photo_grain_444.avif": _avif(photo, "RGB", quality=50,
                                      subsampling="4:4:4",
                                      advanced={"film-grain-test": "16"}),
        "odd_grain_rgba.avif": _avif(np.dstack([odd, odd[..., 0]]), "RGBA",
                                     quality=60,
                                     advanced={"film-grain-test": "2"}),
        "px_1x1_grain.avif": _avif(photo[:1, :1].copy(), "RGB",
                                   advanced={"film-grain-test": "9"}),
        "photo_grain_clip.avif": grain_flag(_avif(
            photo[:96, :160].copy(), "RGB", quality=40,
            advanced={"film-grain-test": "11"}), 1),
        # image sequences: the first frame of each
        "photo_sequence.avif": _avif_frames(
            [photo, photo[::-1].copy(), photo[:, ::-1].copy()], "RGB",
            quality=50),
        "odd_sequence_444.avif": _avif_frames(
            [odd, odd[::-1].copy()], "RGB", subsampling="4:4:4"),
        # grids
        "grid_1x2.avif": avif_grid(_tiles(photo, 1, 2, 64, 64), 1, 2, 128,
                                   64),
        "grid_2x1.avif": avif_grid(_tiles(photo, 2, 1, 64, 64), 2, 1, 64,
                                   128),
        "grid_3x3_odd_444.avif": avif_grid(
            _tiles(photo, 3, 3, 66, 64, subsampling="4:4:4"), 3, 3, 197,
            191),
        "grid_2x2_cropped.avif": avif_grid(_tiles(photo, 2, 2, 64, 64),
                                           2, 2, 120, 100, big=True),
        "grid_rgba.avif": avif_grid(
            _tiles(np.dstack([photo, photo[..., 1]]), 1, 2, 64, 64,
                   "RGBA"), 1, 2, 128, 64, alpha=True),
    }
    if big:
        # PIL's defaults with aom's first film grain test vector
        out["texture_2048_grain.avif"] = _avif(
            tex, "RGB", advanced={"film-grain-test": "1"})
        out["texture_2048_grid.avif"] = big_grid()
    return out


# ---------------------------------------------------------------------------
# TIFF: YCbCr outside JPEG
# ---------------------------------------------------------------------------

def ycbcr_cell_bytes(ycc: np.ndarray, hs: int, vs: int, predictor: int = 1,
                     rowsize: int = 0):
    """tools/make_image_modes.py `tiff_bytes`'s cell_bytes for full-size
    YCbCr samples ((h, w, 3)): each strip or tile as blocks of hs x vs luma
    samples and the block's mean Cb and Cr (rounded), the image's edge
    samples repeated past it; predictor 2 differences each `rowsize`
    bytes at a stride of 3 where the sizes divide, as libtiff does."""
    h, w, _ = ycc.shape

    def cell(x, y, cw, ch):
        nr, nc = -(-ch // vs), -(-cw // hs)
        yy = np.minimum(np.arange(y, y + nr * vs), h - 1)
        xx = np.minimum(np.arange(x, x + nc * hs), w - 1)
        px = ycc[yy][:, xx].astype(np.int64)
        blk = px.reshape(nr, vs, nc, hs, 3).transpose(0, 2, 1, 3, 4)
        lum = blk[..., 0].reshape(nr, nc, hs * vs)
        chroma = (blk[..., 1:].reshape(nr, nc, hs * vs, 2).sum(2)
                  + hs * vs // 2) // (hs * vs)
        out = np.concatenate([lum, chroma], -1).reshape(-1)
        if predictor == 2 and rowsize % 3 == 0 and out.size % rowsize == 0:
            rows = out.reshape(-1, rowsize // 3, 3)
            rows[:, 1:] = np.diff(rows, axis=1)
            out = rows.reshape(-1) & 0xFF
        return out.astype(np.uint8).tobytes()
    return cell


def ycbcr_tiff(ycc: np.ndarray, hs: int, vs: int, *, order: str = "II",
               compression: int = 5, predictor: int = 1, tile=None,
               rows_per_strip=None, coefficients=None, reference=None,
               subsampling_tag: bool = True, tags=()) -> bytes:
    """A YCbCr TIFF (photometric 6) of full-size samples, subsampled hs x
    vs, in strips or tiles; YCbCrCoefficients and ReferenceBlackWhite as
    (numerator, denominator) pairs where given; no YCbCrSubsampling tag
    (libtiff then takes 2x2) where `subsampling_tag` is False."""
    h, w, _ = ycc.shape
    if tile:
        rowsize = 3 * tile[0]
    else:
        rowsize = -(-w // hs) * (hs * vs + 2) // vs
    extra = list(tags)
    if subsampling_tag:
        extra.append((530, 3, [hs, vs]))
    if coefficients is not None:
        extra.append((529, 5, coefficients))
    if reference is not None:
        extra.append((532, 5, reference))
    return modes.tiff_bytes(
        np.zeros((h, w, 3), np.int64), 8, 6, order=order,
        compression=compression, predictor=predictor, tile=tile,
        rows_per_strip=rows_per_strip, tags=extra,
        cell_bytes=ycbcr_cell_bytes(ycc, hs, vs, predictor, rowsize))


# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------

def psd_packbits_row(row: bytes) -> bytes:
    """One row as PackBits records: runs of 3 or more equal bytes as
    repeats, the rest as literals, at most 128 bytes a record, and a
    no-op record (0x80) before the row's second record."""
    out, i, n = bytearray(), 0, len(row)
    records = 0
    while i < n:
        if records == 1:
            out.append(0x80)
        j = i
        while j < n and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), row[i]])
        else:
            j = i
            while j < n and j - i < 128 and not (
                    j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            out += bytes([j - i - 1]) + row[i:j]
        records += 1
        i = j
    return bytes(out)


def psd_bytes(channels: np.ndarray, mode: int, bits: int = 8, *,
              rle: bool = False, palette: np.ndarray = None,
              resources: bool = True, layers: bool = False,
              spill: bool = False, version: int = 1,
              compression: int = None) -> bytes:
    """A PSD file of `channels` ((c, h, w) samples: bytes, or 0/1 where
    bits is 1), colour mode `mode` (0 bitmap, 1 grey, 2 indexed, 3 RGB,
    4 CMYK, 7 multichannel, 8 duotone, 9 LAB): the header, the colour
    mode data (a 768-byte palette, or a duotone block), image resources
    (a resolution block and one of odd length) where `resources`, a layer
    and mask section holding one layer of the first channel's pixels
    where `layers`, then the merged image, raw or (`rle`) as PackBits
    rows after their byte counts; `spill` makes the first row's last
    record run on into the next row, which PIL's decoder drops."""
    c, h, w = channels.shape
    out = bytearray(b"8BPS" + struct.pack(">H6xHIIHH", version, c, h, w,
                                          bits, mode))
    if palette is not None:
        cmd = palette.astype(np.uint8).T.tobytes()     # R, G then B
    elif mode == 8:
        cmd = b"duotone-data\x00\x01"
    else:
        cmd = b""
    out += struct.pack(">I", len(cmd)) + cmd
    res = b""
    if resources:
        res = (b"8BIM" + struct.pack(">H", 1005) + b"\x00\x00"
               + struct.pack(">I", 16) + bytes(16)
               + b"8BIM" + struct.pack(">H", 1000) + b"\x03abc"
               + struct.pack(">I", 5) + b"12345\x00")
    out += struct.pack(">I", len(res)) + res
    if layers:
        img = channels[0].astype(np.uint8).tobytes() if bits == 8 else \
            np.packbits(channels[0].astype(np.uint8), axis=1).tobytes()
        rec = (struct.pack(">iiiiH", 0, 0, h, w, 1) + struct.pack(
            ">hI", 0, 2 + len(img)) + b"8BIMnorm" + bytes([255, 0, 0, 0])
            + struct.pack(">I", 12) + struct.pack(">II", 0, 0) + b"\x03lay")
        info = struct.pack(">h", 1) + rec + struct.pack(">H", 0) + img
        if len(info) & 1:
            info += b"\x00"
        section = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
        out += struct.pack(">I", len(section)) + section
    else:
        out += struct.pack(">I", 0)
    if bits == 1:
        rows = [np.packbits(ch.astype(np.uint8), axis=1) for ch in channels]
    else:
        rows = [ch.astype(np.uint8) for ch in channels]
    if compression is not None:
        out += struct.pack(">H", compression)
    elif not rle:
        out += struct.pack(">H", 0)
        for r in rows:
            out += r.tobytes()
    else:
        packed = [[psd_packbits_row(r[y].tobytes()) for y in range(h)]
                  for r in rows]
        if spill and w > 2:
            # the first row's records as one literal longer than the row
            row0 = rows[0][0].tobytes()
            packed[0][0] = bytes([len(row0)]) + row0 + row0[:1]
        out += struct.pack(">H", 1)
        for ch in packed:
            out += b"".join(struct.pack(">H", len(p)) for p in ch)
        for ch in packed:
            out += b"".join(ch)
    return bytes(out)


# ---------------------------------------------------------------------------
# formats_g: float and signed TIFF, YCbCr TIFF, sYCC JPEG 2000, PSD and
# AVIF frames libavif scales
# ---------------------------------------------------------------------------

SEED_G = 17


def height_map(side: int = 1024, seed: int = SEED_G) -> np.ndarray:
    """(side, side) float32 heights about 100, quantised to 1/256: a sum
    of seeded ridges and a little noise, as a sculpting tool exports a
    displacement map."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side] / side
    hgt = np.full((side, side), 100.0)
    for _ in range(6):
        fx, fy, ph = rng.uniform(1, 6), rng.uniform(1, 6), rng.uniform(0, 6)
        hgt += rng.uniform(4, 12) * np.sin(2 * np.pi * (fx * x + fy * y)
                                           + ph)
    hgt += rng.normal(0, 0.3, hgt.shape)
    return (np.round(hgt * 256) / 256).astype(np.float32)


def float_tiff(values: np.ndarray, **kw) -> bytes:
    """A 32-bit floating-point grey TIFF (SampleFormat 3) of (h, w)
    float32 values."""
    bits = values.astype(np.float32).view(np.uint32).astype(np.int64)
    return modes.tiff_bytes(bits[..., None], 32, kw.pop("photometric", 1),
                            tags=[(339, 3, [3])] + list(kw.pop("tags", ())),
                            **kw)


def signed_tiff(values: np.ndarray, bits: int, **kw) -> bytes:
    """A signed (SampleFormat 2) grey TIFF of (h, w) integers."""
    return modes.tiff_bytes((values.astype(np.int64) % (1 << bits))[..., None],
                            bits, 1, tags=[(339, 3, [2])], **kw)


def scaled_avif(data: bytes, w: int, h: int, which=None) -> bytes:
    """An AVIF with the ispe properties (all, or the `which`-th ones) and
    track header sizes rewritten to w x h: libavif scales each decoded
    frame to that size."""
    out = bytearray(data)
    at, k = 0, 0
    while True:
        at = out.find(b"ispe", at)
        if at < 0:
            break
        if which is None or k in which:
            struct.pack_into(">II", out, at + 8, w, h)
        at, k = at + 4, k + 1
    at = 0
    while True:
        at = out.find(b"tkhd", at)
        if at < 0:
            break
        v = out[at + 4]
        struct.pack_into(">II", out, at + 4 + 4 + (32 if v == 1 else 20)
                         + 52, w << 16, h << 16)
        at += 4
    return bytes(out)


def files_g() -> dict:
    """{name in scenes/data/formats_g: bytes}: the 1024x1024 float height
    map (Deflate, floating-point predictor) and signed and float TIFF of
    every layout PIL opens (8-, 16- and 32-bit signed, 32-bit unsigned
    little-endian, float under photometric 0 and 1, both byte orders,
    where libtiff hands PIL big-endian samples swapped; predictors 2 and
    3; strips and tiles); YCbCr TIFF outside JPEG (`ycbcr_tiff`) at every
    subsampling libtiff converts, clipped 4x4 tiles, Rec. 709
    coefficients and a studio-range ReferenceBlackWhite, and PIL's own;
    sYCC JP2 (PIL's, and an RGBA codestream under colour space 18);
    PSD (`psd_bytes`) of every mode PIL opens, raw and RLE, with and
    without a layer section, odd sizes; and AVIF whose ispe or track
    size libavif scales it to, up and down, in stills, a grid's tiles
    and a sequence."""
    from PIL import Image
    lrgba = np.asarray(Image.open(os.path.join(modes.DATA, "logo.png")))
    grid = np.asarray(Image.open(os.path.join(modes.DATA, "grid.png")))
    tex = np.asarray(Image.open(os.path.join(
        modes.DATA, "formats_d", "texture_2048.jp2")).convert("RGB"))
    photo = tex[600:856, 900:1156]                          # 256x256
    odd = np.ascontiguousarray(photo[:37, :53])
    wide = odd.astype(np.int64)
    lum = np.asarray(Image.fromarray(lrgba[..., :3]).convert("L")).astype(
        np.int64)
    hgt = height_map()

    def ycc(px):
        return np.asarray(Image.fromarray(np.ascontiguousarray(
            px[..., :3])).convert("YCbCr")).astype(np.int64)

    def pil_tiff(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "TIFF", **kw)
        return buf.getvalue()

    def pil_jp2(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "JPEG2000", **kw)
        return buf.getvalue()

    def planes(px):
        return np.moveaxis(px, -1, 0)

    rgba_stream = pil_jp2(Image.fromarray(np.ascontiguousarray(
        lrgba[:64, :96])), no_jp2=True)
    # PSD stores CMYK inverted (PIL reads it with its "C;I" modes)
    cmyk = 255 - np.asarray(Image.fromarray(photo).convert("CMYK"))
    rng = np.random.default_rng(SEED_G)
    # values of every mantissa bit, whose bytes swapped are other floats
    fine = rng.uniform(0, 1, odd.shape[:2]).astype(np.float32)
    logo_avif = _avif(lrgba, "RGBA", quality=60)
    grid_tiles = avif_grid(_tiles(photo, 1, 2, 64, 64), 1, 2, 128, 64)
    out = {
        # frame O
        "height_1024_float_pred3.tif": float_tiff(
            hgt, compression=32946, predictor=3, rows_per_strip=64),
        "logo_int16_signed.tif": signed_tiff(lum * 3 - 150, 16,
                                             compression=5, predictor=2,
                                             rows_per_strip=32),
        "logo_rgb_rle_layers.psd": psd_bytes(planes(lrgba[..., :3]), 3,
                                             rle=True, layers=True),
        # frame P
        "grid_ycbcr_2x2_lzw.tif": ycbcr_tiff(ycc(grid), 2, 2,
                                             rows_per_strip=16),
        "logo_sycc.jp2": pil_jp2(Image.fromarray(
            np.ascontiguousarray(lrgba[..., :3])).convert("YCbCr")),
        "logo_scaled_ispe.avif": scaled_avif(logo_avif, 360, 240),
        # the rest of the sweep
        "photo_cmyk_rle.psd": psd_bytes(planes(cmyk), 4, rle=True),
        "odd_float_mm_tiles_lzw_pred3.tif": float_tiff(
            odd[..., 0].astype(np.float32) / 2 + fine, order="MM",
            compression=5, predictor=3, tile=(16, 16)),
        "odd_float_minwhite_raw.tif": float_tiff(
            odd[..., 1].astype(np.float32) * 1.5 - 60, photometric=0,
            rows_per_strip=7),
        "odd_float_mm_raw_planar.tif": float_tiff(
            odd[..., 2].astype(np.float32) - fine, order="MM", planar=2),
        "odd_int32_signed_packbits.tif": signed_tiff(
            wide[..., 0] * 300 - 20000, 32, compression=32773,
            rows_per_strip=5),
        "odd_int16_signed_mm_deflate.tif": signed_tiff(
            wide[..., 1] * 2 - 100, 16, order="MM", compression=8,
            predictor=2, tile=(16, 16)),
        "odd_int8_signed.tif": signed_tiff(odd[..., 2], 8),
        "odd_uint32_lzw_pred2.tif": modes.tiff_bytes(
            wide[..., :1] * 16843009, 32, 1,
            compression=5, predictor=2, rows_per_strip=8),
        "odd_ycbcr_4x4_tiles_deflate.tif": ycbcr_tiff(
            ycc(odd), 4, 4, compression=8, tile=(16, 16)),
        "odd_ycbcr_4x2_bt709_studio.tif": ycbcr_tiff(
            ycc(odd), 4, 2, compression=32773, rows_per_strip=8,
            coefficients=[(2126, 10000), (7152, 10000), (722, 10000)],
            reference=[(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                       (240, 1)]),
        "odd_ycbcr_2x1_mm_pred2.tif": ycbcr_tiff(
            ycc(odd), 2, 1, order="MM", compression=5, predictor=2,
            rows_per_strip=6),
        "odd_ycbcr_1x2_lzw.tif": ycbcr_tiff(ycc(odd), 1, 2, compression=5,
                                            rows_per_strip=10),
        "odd_ycbcr_default_2x2.tif": ycbcr_tiff(
            ycc(odd), 2, 2, compression=8, subsampling_tag=False),
        "odd_ycbcr_pil_packbits.tif": pil_tiff(
            Image.fromarray(odd).convert("YCbCr"), compression="packbits"),
        "odd_sycc_rgba.jp2": jp2_wrap(rgba_stream, 96, 64, 4,
                                      colr=b"\x01\x00\x00\x00\x00\x00\x12"),
        "odd_sycc.j2k": pil_jp2(Image.fromarray(odd).convert("YCbCr"),
                                no_jp2=True),
        "odd_bitmap.psd": psd_bytes(
            (planes(odd[..., :1]) > 100).astype(np.int64), 0, 1),
        "odd_grey_rle.psd": psd_bytes(planes(odd[..., :1]), 1, rle=True,
                                      resources=False),
        "odd_indexed.psd": psd_bytes(planes(odd[..., :1]), 2,
                                     palette=photo[::16, ::16].reshape(
                                         256, 3)),
        "odd_multichannel_spill.psd": psd_bytes(planes(odd), 7, rle=True,
                                                spill=True),
        "odd_duotone_layers.psd": psd_bytes(planes(odd[..., :1]), 8,
                                            layers=True),
        "odd_rgba_rle.psd": psd_bytes(planes(np.dstack([odd, odd[..., 0]])),
                                      3, rle=True, layers=True),
        "odd_cmyk5_raw.psd": psd_bytes(planes(np.dstack([
            255 - np.asarray(Image.fromarray(odd).convert("CMYK")),
            odd[..., 1]])), 4),
        "photo_scaled_down34.avif": scaled_avif(
            _avif(photo, "RGB", quality=50), 192, 192),
        "odd_scaled_420_rgba.avif": scaled_avif(
            _avif(np.dstack([odd, odd[..., 0]]), "RGBA"), 71, 30),
        "grid_scaled_tiles.avif": scaled_avif(grid_tiles, 70, 64,
                                              which=(0,)),
        "sequence_scaled.avif": scaled_avif(_avif_frames(
            [odd, odd[::-1].copy()], "RGB"), 40, 50),
    }
    return out


# ---------------------------------------------------------------------------
# formats_h: ZSTD TIFF, LAB, and nine more of PIL's plugins
# ---------------------------------------------------------------------------

SEED_H = 18


def zstd_coder(level: int = 3, checksum: bool = False, size: bool = False,
               ldm: bool = False):
    """A Zstandard compressor of one frame (the `zstandard` module) at
    `level`, with or without its checksum and content size, for
    `make_image_modes.tiff_bytes(..., compress=)`."""
    import zstandard

    params = zstandard.ZstdCompressionParameters.from_level(
        level, write_checksum=checksum, write_content_size=size,
        enable_ldm=ldm)
    return zstandard.ZstdCompressor(compression_params=params).compress


def sun_rle(data: bytes) -> bytes:
    """Sun's run-length coding: runs of 3 to 256 equal bytes (and any
    0x80) as 0x80, n - 1, v, a single 0x80 as 0x80 0x00, other bytes as
    themselves."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 256 and data[j] == data[i]:
            j += 1
        if data[i] == 0x80 and j - i == 1:
            out += b"\x80\x00"
        elif j - i >= 3 or data[i] == 0x80:
            out += bytes([0x80, j - i - 1, data[i]])
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def sun_bytes(px: np.ndarray, depth: int, ftype: int = 1,
              palette: np.ndarray = None) -> bytes:
    """A Sun raster file: px is (h, w) values of 1, 4 or 8 bits (1 is
    black at depth 1) or (h, w, 3) RGB at 24 or 32 bits (stored BGR, or
    RGB where ftype is 3, a fourth byte 0); rows padded to 16 bits, or
    (ftype 2) run-length coded with no padding; `palette` ((n, 3)) as
    its reds, greens then blues."""
    h, w = px.shape[:2]
    if depth in (24, 32):
        rgb = px[..., :3] if ftype == 3 else px[..., 2::-1]
        if depth == 32:
            rgb = np.dstack([rgb, np.zeros((h, w), np.uint8)])
        rows = rgb.astype(np.uint8).reshape(h, -1)
    else:
        rows = modes.pack_rows(px.astype(np.int64), depth,
                               True).reshape(h, -1)
    if ftype == 2:
        body = sun_rle(rows.tobytes())
    else:
        pad = (w * depth + 15) // 16 * 2 - rows.shape[1]
        body = np.hstack([rows, np.zeros((h, pad), np.uint8)]).tobytes()
    cmap = b"" if palette is None else \
        palette.astype(np.uint8).T.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       1 if cmap else 0, len(cmap)) + cmap + body


def sun_raster(px: np.ndarray) -> bytes:
    """A 24-bit standard Sun raster file of (h, w, 3) uint8 pixels (BGR
    samples, rows padded to 16 bits)."""
    return sun_bytes(px, 24)


XPM_KEYS = (" .XoO+@#$%&*=-;:>,<1234567890qwertyuipasdfghjklzxcvbnmMNBVC"
            "ZASDFGHJKLPIUYTREWQ!~^/()_`'][{}|")


def xpm_bytes(index: np.ndarray, colours: list, bpp: int = 1,
              none: int = None, symbolic: bool = False) -> bytes:
    """An XPM file of (h, w) indices into `colours` ((r, g, b) tuples;
    entry `none`, where given, is "None"), keys of `bpp` characters from
    XPM_KEYS, a "/* pixels */" line before the rows; `symbolic` puts an
    "s" pair before each "c" one, as GIMP writes."""
    h, w = index.shape
    n = len(colours)
    keys = [XPM_KEYS[k % len(XPM_KEYS)] + "".join(
        XPM_KEYS[k // len(XPM_KEYS) ** (i + 1) % len(XPM_KEYS)]
        for i in range(bpp - 1)) for k in range(n)]
    lines = ["/* XPM */", "static char *image[] = {",
             "/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {n} {bpp} ",']
    for k, (key, c) in enumerate(zip(keys, colours)):
        col = "None" if k == none else "#%02X%02X%02X" % tuple(c)
        sym = f"s c{k} " if symbolic else ""
        lines.append(f'"{key} {sym}c {col}",')
    lines.append("/* pixels */")
    for y in range(h):
        row = "".join(keys[v] for v in index[y])
        lines.append(f'"{row}"' + ("," if y < h - 1 else ""))
    lines.append("};")
    return ("\n".join(lines) + "\n").encode()


def dcx_bytes(pages: list) -> bytes:
    """A DCX file of PCX pages: the magic, 1024 page offsets (0 after the
    last), then the pages."""
    at, table = 4 + 4 * 1024, []
    for p in pages:
        table.append(at)
        at += len(p)
    table += [0] * (1024 - len(table))
    return struct.pack("<I1024I", 987654321, *table) + b"".join(pages)


def pcx_bytes(px: np.ndarray, mode: str = "RGB") -> bytes:
    """PIL's PCX of (h, w, 3) pixels in `mode`."""
    return _pil(px, mode, "PCX")


def dxt1_blocks(px: np.ndarray) -> bytes:
    """PIL's DXT1 blocks of (h, w, 3 or 4) pixels (its DDS writer's)."""
    return _pil(px, "RGBA" if px.shape[2] == 4 else "RGB", "DDS",
                pixel_format="DXT1")[128:]


def ftex_bytes(w: int, h: int, fmt: int, body: bytes) -> bytes:
    """An FTEX file of one format (0 DXT1, 1 raw RGB) and one mip-map."""
    return (b"FTEX" + struct.pack("<7i", 1, w, h, 1, 1, fmt, 32)
            + struct.pack("<i", len(body)) + body)


def gbr_bytes(px: np.ndarray, version: int = 2,
              name: bytes = b"brush") -> bytes:
    """A GIMP brush of (h, w) grey or (h, w, 4) RGBA pixels, version 1 or
    2 (with the "GIMP" magic and a spacing)."""
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    extra = b"GIMP" + struct.pack(">I", 25) if version == 2 else b""
    size = 20 + len(extra) + len(name) + 1
    return (struct.pack(">5I", size, version, w, h, depth) + extra + name
            + b"\x00" + px.astype(np.uint8).tobytes())


def imt_bytes(px: np.ndarray, comment: bool = True) -> bytes:
    """An IM Tools file of (h, w) grey pixels."""
    h, w = px.shape
    head = (b"* written by make_image_formats\n" if comment else b"") + \
        f"width {w}\nheight {h}\npixel n8\n".encode()
    return head + b"\x0c" + px.astype(np.uint8).tobytes()


def mcidas_bytes(values: np.ndarray, size: int, prefix: int = 0,
                 bands: int = 1, at: int = 256) -> bytes:
    """A McIdas area file of (h, w) values of `size` bytes (1, 2 or 4,
    big-endian; 4 signed), `bands` bands a row (the first the values,
    the rest their complement), `prefix` bytes before each row, the data
    `at` bytes into the file."""
    h, w = values.shape
    word = [0] * 65
    word[2], word[9], word[10], word[11] = 4, h, w, size
    word[14], word[15], word[34] = bands, prefix, at
    head = struct.pack(">64i", *word[1:])
    dt = {1: "u1", 2: ">u2", 4: ">i4"}[size]
    v = values.astype(np.int64)
    rows = [np.hstack([np.full((1, prefix), 7, np.uint8).reshape(-1)]
                      + [(v[y] if b == 0 else ~v[y]).astype(dt).view(
                          np.uint8) for b in range(bands)])
            for y in range(h)]
    return head.ljust(at, b"\x00") + b"".join(r.tobytes() for r in rows)


def pixar_bytes(px: np.ndarray) -> bytes:
    """A PIXAR file of (h, w, 3) RGB pixels, the layout PIL opens."""
    h, w = px.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<2H", head, 416, h, w)
    struct.pack_into("<2H", head, 424, 14, 2)
    return bytes(head) + px.astype(np.uint8).tobytes()


def xvthumb_bytes(px: np.ndarray) -> bytes:
    """An XV thumbnail of (h, w, 3) RGB pixels: 3-3-2 indices after xv's
    header and comment lines."""
    h, w = px.shape[:2]
    p = px.astype(np.int64)
    index = (p[..., 0] >> 5) << 5 | (p[..., 1] >> 5) << 2 | p[..., 2] >> 6
    head = (b"P7 332\n#XVVERSION:Version 2.28  Rev: 9/26/92\n"
            + f"#IMGINFO:{w}x{h} RGB (12345 bytes)\n".encode()
            + b"#END_OF_COMMENTS\n" + f"{w} {h} 255\n".encode())
    return head + index.astype(np.uint8).tobytes()


def zero_tiff_pad(data: bytes) -> bytes:
    """A little-endian TIFF with the bytes between its last strip and its
    directory zeroed: libtiff leaves the pad byte that aligns the
    directory as it finds it in memory, so PIL's writes differ there from
    run to run."""
    out = bytearray(data)
    ifd = struct.unpack_from("<I", out, 4)[0]
    tags = {}
    for k in range(struct.unpack_from("<H", out, ifd)[0]):
        tag, typ, n, val = struct.unpack_from("<HHII", out, ifd + 2 + 12 * k)
        if tag in (273, 279, 324, 325):
            fmt = "<" + ("H" if typ == 3 else "I") * n
            tags[tag] = (struct.unpack_from(fmt, out, ifd + 10 + 12 * k)
                         if struct.calcsize(fmt) <= 4 else
                         struct.unpack_from(fmt, out, val))
    offs = tags.get(273, tags.get(324, ()))
    counts = tags.get(279, tags.get(325, ()))
    end = max((o + c for o, c in zip(offs, counts)), default=ifd)
    if end < ifd:
        out[end:ifd] = bytes(ifd - end)
    return bytes(out)


def lab_of(px: np.ndarray) -> np.ndarray:
    """PIL's LAB of (h, w, 3) RGB pixels as Pillow stores it (and PSD):
    L*, a* + 128, b* + 128. (numpy's view of a LAB image is its "LAB" raw
    mode, TIFF's signed a* and b*.)"""
    from PIL import Image
    return np.asarray(Image.fromarray(np.ascontiguousarray(
        px[..., :3])).convert("LAB")) ^ np.array([0, 128, 128], np.uint8)


def files_h() -> dict:
    """{name in scenes/data/formats_h: bytes}: the 2048x2048 texture
    resized to 1024x1024 as a LAB TIFF under ZSTD (PIL's write); a
    512x512 copy tiled 256x256 under ZSTD with predictor 2 at level 19
    with a checksum, as GDAL tiles a colour map; Sun rasters of every
    depth, raw and run-length coded, with and without a colour map; LAB
    PSD (RLE and raw) and LAB TIFF of PIL's other compressions; XPM (a
    palette with an unused "None", two-character keys of more than 256
    colours); FTEX of DXT1 blocks and of raw RGB; DCX; GIMP brushes of
    both versions; IMT; McIdas areas of 1, 2 and 4 bytes; PIXAR; an XV
    thumbnail; and ZSTD TIFF of the other sample layouts (big-endian,
    float with predictor 3, a frame with its content size)."""
    from PIL import Image
    lrgba = np.asarray(Image.open(os.path.join(modes.DATA, "logo.png")))
    logo = np.ascontiguousarray(lrgba[..., :3])
    grid = np.asarray(Image.open(os.path.join(modes.DATA, "grid.png")))
    big = Image.open(os.path.join(modes.DATA, "modes", "texture_2048.jpg"))
    tex = np.asarray(big.convert("RGB").resize((1024, 1024)))
    photo = np.asarray(big.convert("RGB").resize((512, 512)))
    odd = np.ascontiguousarray(photo[100:137, 200:253])
    lum = np.asarray(Image.fromarray(odd).convert("L"))
    rng = np.random.default_rng(SEED_H)

    def pil_tiff(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "TIFF", **kw)
        return zero_tiff_pad(buf.getvalue())

    def lab_img(px):
        # PIL's LAB carries lcms2's Lab profile, stamped with the time it
        # was made: fixed here, so each run writes the same bytes
        img = Image.fromarray(np.ascontiguousarray(px)).convert("LAB")
        icc = bytearray(img.info["icc_profile"])
        icc[24:36] = struct.pack(">6H", 2026, 1, 1, 0, 0, 0)
        img.info["icc_profile"] = bytes(icc)
        return img

    def planes(px):
        return np.moveaxis(px, -1, 0)

    # the grid's few colours as palette indices, the photo's 4-bit grey
    colours, gidx = np.unique(grid.reshape(-1, 3), axis=0,
                              return_inverse=True)
    gidx = gidx.reshape(grid.shape[:2])
    many = rng.integers(0, 300, (37, 53))
    many_cols = [tuple(int(v) for v in c)
                 for c in rng.integers(0, 256, (300, 3))]
    pal16 = rng.integers(0, 256, (16, 3))
    out = {
        # frame Q
        "texture_1024_lab_zstd.tif": pil_tiff(lab_img(tex),
                                              compression="zstd"),
        "photo_512_zstd_tiles_pred2.tif": modes.tiff_bytes(
            photo.astype(np.int64), 8, 2, compression=50000, predictor=2,
            tile=(256, 256), compress=zstd_coder(19, checksum=True)),
        "logo_rle24.ras": sun_bytes(logo, 24, 2),
        # frame R
        "logo_lab_rle.psd": psd_bytes(planes(lab_of(logo)), 9, rle=True),
        "grid.xpm": xpm_bytes(gidx, [tuple(c) for c in colours] + [
            (0, 0, 0)], none=len(colours)),
        "logo_dxt1.ftex": ftex_bytes(300, 200, 0, dxt1_blocks(lrgba)),
        # the rest of the sweep
        "odd_rgb32_rgb_order.ras": sun_bytes(odd, 32, 3),
        "odd_bgr32_rle.ras": sun_bytes(odd, 32, 2),
        "odd_grey8_pal_rle.ras": sun_bytes(lum, 8, 2, palette=rng.integers(
            0, 256, (200, 3))),
        "odd_grey4_pal.ras": sun_bytes(lum >> 4, 4, palette=pal16),
        "odd_grey4.ras": sun_bytes(lum >> 4, 4, 2),
        "odd_bilevel.ras": sun_bytes(lum > 120, 1),
        "odd_bilevel_rle.ras": sun_bytes(lum > 90, 1, 2),
        "odd_grey8.ras": sun_bytes(lum, 8, 5),
        "odd_lab_raw.psd": psd_bytes(planes(lab_of(odd)), 9, layers=True),
        "odd_lab_lzw_mm.tif": modes.tiff_bytes(
            (lab_of(odd) ^ np.array([0, 128, 128])).astype(np.int64), 8, 8,
            order="MM", compression=5, predictor=2, rows_per_strip=8),
        "odd_lab_jpeg.tif": pil_tiff(lab_img(odd), compression="jpeg"),
        "odd_lab_packbits_tiles.tif": modes.tiff_bytes(
            (lab_of(odd) ^ np.array([0, 128, 128])).astype(np.int64), 8, 8,
            compression=32773, tile=(16, 16)),
        "odd_many_2chars.xpm": xpm_bytes(many, many_cols, 2,
                                         symbolic=True),
        "odd_rgb.ftex": ftex_bytes(53, 37, 1, odd.tobytes()),
        "odd_pages.dcx": dcx_bytes([pcx_bytes(odd), pcx_bytes(
            logo, "P")]),
        "odd_v1_grey.gbr": gbr_bytes(lum, 1),
        "odd_v2_rgba.gbr": gbr_bytes(np.dstack([odd, lum])),
        "odd.imt": imt_bytes(lum),
        "odd_8bit.mcidas": mcidas_bytes(lum, 1, prefix=4, bands=2),
        "odd_16bit.mcidas": mcidas_bytes(lum.astype(np.int64) * 3 - 20, 2),
        "odd_32bit.mcidas": mcidas_bytes(
            lum.astype(np.int64) * 70000 - 300000, 4, at=512),
        "odd.pixar": pixar_bytes(odd),
        "odd.xvthumb": xvthumb_bytes(odd),
        "odd_zstd_mm_float_pred3.tif": float_tiff(
            lum.astype(np.float32) / 3 - 10, order="MM", compression=50000,
            predictor=3, tile=(16, 16), compress=zstd_coder(-3)),
        "odd_zstd_grey16_size.tif": modes.tiff_bytes(
            lum[..., None].astype(np.int64) * 257, 16, 1,
            compression=50000, rows_per_strip=9,
            compress=zstd_coder(12, checksum=True, size=True)),
    }
    return out


# the side of the bomb files: 13,380 ** 2 = 179,024,400 pixels, just past
# PIL's limit of 178,956,970
BOMB_SIDE = S = 13380


def _bomb_png(w: int, h: int,
              body: bytes = b"\x78\x9c\x03\x00\x00\x00\x00\x01") -> bytes:
    """A 1-bit grey PNG header of w x h with an IDAT of `body`."""
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 1, 0, 0, 0, 0))
            + chunk(b"IDAT", body) + chunk(b"IEND", b""))


def _bomb_dib(w: int, h: int, bits: int = 24) -> bytes:
    return struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, 0, 0, 0, 0, 0)


def _bomb_icon(entry_w: int, entry_h: int, body: bytes, cursor: bool) -> bytes:
    """An ICO (or CUR) directory of one entry, then the entry's bytes."""
    return (struct.pack("<HHH", 0, 2 if cursor else 1, 1)
            + struct.pack("<BBBBHHII", entry_w, entry_h, 0, 0, 1, 32,
                          len(body), 22) + body)


def _bomb_avif() -> bytes:
    """PIL's 8x8 AVIF with its ispe patched to S x S."""
    from PIL import Image
    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (40, 90, 200)).save(buf, "AVIF", max_threads=1)
    data = buf.getvalue()
    at = data.index(b"ispe") + 8
    return data[:at] + struct.pack(">II", S, S) + data[at + 8:]


def _bomb_tiff() -> bytes:
    """One IFD: width, length, 8 bits, no compression, min-is-black, a
    strip of the whole image."""
    entries = [(256, 4, S), (257, 4, S), (258, 3, 8), (259, 3, 1),
               (262, 3, 1), (273, 4, 8), (277, 3, 1), (278, 4, S),
               (279, 4, S * S)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", tag, typ, 1, v) for tag, typ, v in entries)
    return b"II*\x00" + struct.pack("<I", 16) + bytes(8) + ifd + bytes(4)


def _bomb_msp() -> bytes:
    """A version 1 header whose words XOR to 0, as PIL checks."""
    words = [0x6144, 0x4D6E, S, S, 1, 1, 1, 1, 0, 0, 0, 0]
    check = 0
    for w in words:
        check ^= w
    return struct.pack("<13H", *words, check).ljust(32, b"\0") + bytes(16)


def _bomb_spider() -> bytes:
    """PIL's SPIDER label fields (counted from 1): nslice 1, nrow, iform
    1, nsam, labrec 1, labbyt = lenbyt = 4 * nsam."""
    fields = [0.0] * 27
    fields[0], fields[1], fields[4] = 1.0, float(S), 1.0
    fields[11], fields[12] = float(S), 1.0
    fields[21] = fields[22] = float(4 * S)
    return struct.pack(">27f", *fields).ljust(1024, b"\0")


def fault5_png() -> bytes:
    """The whole 1-bit grey PNG of S x S black pixels (21,846 B)."""
    return _bomb_png(S, S, zlib.compress(bytes(S * (1 + (S + 7) // 8)), 9))


def bomb_cases() -> dict:
    """{PIL's format name: (a header-only file of S x S pixels, whether PIL
    raises at open rather than on loading the entry or inner image it
    picks)} for each format the port decodes."""
    sos = b"\x01\x01\x00\x00\x3f\x00"
    sof = struct.pack(">BHHB", 8, S, S, 1) + b"\x01\x11\x00"
    siz = struct.pack(">HIIIIIIIIH", 0, S, S, 0, 0, S, S, 0, 0, 1) + \
        b"\x07\x01\x01"
    png = _bomb_png(S, S)
    icns = b"ic10" + struct.pack(">I", 8 + len(png)) + png
    blp = (b"BLP2" + struct.pack("<iBBBBII", 1, 1, 0, 0, 0, S, S)
           + struct.pack("<16I", 20 + 128 + 1024, *([0] * 15))
           + struct.pack("<16I", 16, *([0] * 15)) + bytes(1040))
    im = (b"Image type: L image\r\nName: bomb\r\n"
          + f"Image size (x*y): {S}*{S}\r\n".encode()
          + b"File size (no of images): 1\r\n")
    pcx = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, S - 1, S - 1, 72,
                      72) + bytes(48) + struct.pack("<BBHH", 0, 1, S, 1)
    dds = (struct.pack("<4sIIIIIII", b"DDS ", 124, 0x1007, S, S, 0, 0, 0)
           + bytes(44) + struct.pack("<II4sIIIII", 32, 0x4, b"DXT1", 0, 0,
                                     0, 0, 0)
           + struct.pack("<IIIII", 0x1000, 0, 0, 0, 0))
    frame = anmf(0, 0, 1, 1, [(b"VP8L", vp8l_stream(1, 1, 1))])
    return {
        "BMP": (b"BM" + struct.pack("<IHHI", 62, 0, 0, 54)
                + _bomb_dib(S, S) + bytes(8), True),
        "DIB": (_bomb_dib(S, S) + bytes(16), True),
        # a logical screen of S x S and one 1x1 frame
        "GIF": (b"GIF89a" + struct.pack("<HHBBB", S, S, 0, 0, 0) + b","
                + struct.pack("<HHHHB", 0, 0, 1, 1, 0)
                + b"\x02\x02\x44\x01\x00;", True),
        "JPEG": (b"\xff\xd8\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
                 + b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
                 + bytes(8) + b"\xff\xd9", True),
        "PPM": (f"P6\n{S} {S}\n255\n".encode() + bytes(16), True),
        "PNG": (png, True),
        "AVIF": (_bomb_avif(), True),
        "BLP": (blp, True),
        "CUR": (_bomb_icon(32, 32, _bomb_dib(S, 2 * S, 32) + bytes(16),
                           True), True),
        "PCX": (pcx.ljust(128, b"\0") + bytes(16), True),
        "DDS": (dds + bytes(16), True),
        "JPEG2000": (b"\xff\x4f\xff\x51" + struct.pack(">H", 2 + len(siz))
                     + siz + b"\xff\xd9", True),
        "ICNS": (b"icns" + struct.pack(">I", 8 + len(icns)) + icns, False),
        "ICO": (_bomb_icon(0, 0, png, False), False),
        "IM": (im.ljust(511, b"\0") + b"\x1a" + bytes(16), True),
        "TIFF": (_bomb_tiff(), True),
        "MSP": (_bomb_msp(), True),
        "QOI": (b"qoif" + struct.pack(">IIBB", S, S, 3, 0) + bytes(16),
                True),
        "SGI": (struct.pack(">HBBHHHH", 474, 0, 1, 2, S, S, 1).ljust(
            512, b"\0") + bytes(16), True),
        "SPIDER": (_bomb_spider(), True),
        "TGA": (struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, S, S,
                            24, 0x20) + bytes(16), True),
        # an animated WebP: an S x S canvas and one 1x1 frame
        "WEBP": (animated_webp(S, S, 0, [frame]), True),
        "XBM": (f"#define b_width {S}\n#define b_height {S}\n"
                f"static char b_bits[] = {{\n0x00, 0x00 }};\n".encode(),
                True),
    }


# ---------------------------------------------------------------------------
# formats_i: hand-written JPEG, FLI/FLC, PhotoCD, FITS and IPTC (no PIL)
# ---------------------------------------------------------------------------

ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)


class _JpegBits:
    """The entropy-coded bits of a JPEG scan, 0xFF bytes stuffed."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = self.acc << 1 | (v >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _jseg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def jpeg_blocks(blocks: np.ndarray, w: int, h: int, qt, *,
                wide: bool = False, restart: int = 0) -> bytes:
    """A grey baseline JPEG (SOF1 where `wide`, a 16-bit quantisation
    table) of w x h samples whose (rows, cols, 64) natural-order blocks
    are the quantised coefficients given, any value a 16-bit JCOEF holds
    (DC differences of up to 15 bits), with a restart marker every
    `restart` blocks. Its Huffman tables give every DC size a 5-bit code
    and every AC symbol a 9-bit code (the last a 10-bit one)."""
    qt = np.asarray(qt, np.int64)
    dqt = bytes([0x10 if wide else 0]) + b"".join(
        int(qt[ZIGZAG[k]]).to_bytes(2 if wide else 1, "big")
        for k in range(64))
    dc = bytes([0x00, 0, 0, 0, 0, 16] + [0] * 11) + bytes(range(16))
    ac = bytes([0x10] + [0] * 8 + [255, 1] + [0] * 6) + bytes(range(256))
    acode = {sym: (sym, 9) if sym < 255 else (510, 10) for sym in range(256)}
    sof = struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0])
    head = (b"\xff\xd8" + _jseg(0xDB, dqt) + _jseg(0xC4, dc + ac)
            + (_jseg(0xDD, struct.pack(">H", restart)) if restart else b"")
            + _jseg(0xC1 if wide else 0xC0, sof)
            + _jseg(0xDA, bytes([1, 1, 0x00, 0, 63, 0])))
    flat = np.asarray(blocks, np.int64).reshape(-1, 64)
    out, bw, pred = [], _JpegBits(), 0
    for n, b in enumerate(flat):
        if restart and n and n % restart == 0:
            marker = 0xD0 + (n // restart - 1) % 8
            out.append(bw.flush() + bytes([0xFF, marker]))
            bw, pred = _JpegBits(), 0
        diff = int(b[0]) - pred
        pred = int(b[0])
        size = abs(diff).bit_length()
        bw.put(size, 5)
        bw.put(diff if diff >= 0 else diff + (1 << size) - 1, size)
        run = 0
        for k in range(1, 64):
            v = int(b[ZIGZAG[k]])
            if not v:
                run += 1
                continue
            while run > 15:
                bw.put(*acode[0xF0])
                run -= 16
            size = abs(v).bit_length()
            bw.put(*acode[run << 4 | size])
            bw.put(v if v > 0 else v + (1 << size) - 1, size)
            run = 0
        if run:
            bw.put(*acode[0])
    out.append(bw.flush())
    return head + b"".join(out) + b"\xff\xd9"


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


def jpeg_grey(px: np.ndarray, quality_table: int = 8, **kw) -> bytes:
    """A grey JPEG of (h, w) samples: the float DCT of each block
    (edge-replicated to whole blocks), quantised by a flat table of
    `quality_table`, through jpeg_blocks."""
    h, w = px.shape
    a = np.pad(px.astype(np.float64) - 128, ((0, -h % 8), (0, -w % 8)),
               mode="edge")
    m = _dct_matrix()
    blk = a.reshape(a.shape[0] // 8, 8, a.shape[1] // 8, 8).transpose(
        0, 2, 1, 3)
    coef = np.einsum("ij,abjk,lk->abil", m, blk, m)
    qt = np.full(64, quality_table)
    q = np.round(coef.reshape(*coef.shape[:2], 64) / qt).astype(np.int64)
    return jpeg_blocks(q, w, h, qt, **kw)


def fli_bytes(w: int, h: int, frames: list, flc: bool = True,
              flags: int = 3, prefix: bytes = b"") -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file of `frames`, each a list of
    (sub-chunk type, data); `prefix` is the body of a 0xF100 prefix chunk
    put before the first frame."""
    body = b""
    if prefix:
        body += struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    for chunks in frames:
        subs = b"".join(struct.pack("<IH", 6 + len(d), t) + d
                        for t, d in chunks)
        body += struct.pack("<IHH8x", 16 + len(subs), 0xF1FA,
                            len(chunks)) + subs
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(body),
                     0xAF12 if flc else 0xAF11, len(frames), w, h, 8, flags,
                     70)
    return bytes(head) + body


def fli_colour(palette: np.ndarray, six_bit: bool = False,
               packets=None) -> bytes:
    """A COLOR_256 (chunk 4) or COLOR_64 (11, `six_bit`) body: `packets`
    of (skip, count), by default one packet of every entry."""
    pal = np.asarray(palette, np.int64) >> (2 if six_bit else 0)
    packets = packets or [(0, len(pal))]
    out, at = [struct.pack("<H", len(packets))], 0
    for skip, n in packets:
        at += skip
        out.append(bytes([skip, n % 256]) + pal[at:at + n].astype(
            np.uint8).tobytes())
        at += n
    return b"".join(out)


def fli_brun(index: np.ndarray) -> bytes:
    """A BRUN body (chunk 15): each row byte runs (a count and a value)
    and literal packets (a negative count and the bytes)."""
    out = bytearray()
    for row in index.astype(np.uint8):
        packets, x, w = [], 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 127 and row[x + run] == row[x]:
                run += 1
            if run >= 3:
                packets.append(bytes([run, row[x]]))
                x += run
                continue
            lit = 1
            while x + lit < w and lit < 127 and not (
                    x + lit + 2 < w and row[x + lit] == row[x + lit + 1]
                    == row[x + lit + 2]):
                lit += 1
            packets.append(bytes([256 - lit]) + row[x:x + lit].tobytes())
            x += lit
        out += bytes([len(packets) % 256]) + b"".join(packets)
    return bytes(out)


def fli_lc(old: np.ndarray, new: np.ndarray) -> bytes:
    """An LC body (chunk 12, byte deltas) turning `old` into `new`: the
    first changed line, the line count, then per line packets of a skip,
    and a literal count (or a negative run count and its byte)."""
    rows = [y for y in range(len(new)) if (old[y] != new[y]).any()]
    if not rows:
        return struct.pack("<HH", 0, 0)
    y0, y1 = rows[0], rows[-1] + 1
    out = bytearray(struct.pack("<HH", y0, y1 - y0))
    for y in range(y0, y1):
        diff = np.flatnonzero(old[y] != new[y])
        packets, x = [], 0
        i = 0
        while i < len(diff):
            start = int(diff[i])
            end = start + 1
            while end < len(new[y]) and end - start < 120 and (
                    old[y][end] != new[y][end]):
                end += 1
            while start - x > 255:
                packets.append(bytes([255, 0]))
                x += 255
            seg = new[y][start:end].astype(np.uint8)
            if len(seg) >= 3 and (seg == seg[0]).all():
                packets.append(bytes([start - x, 256 - len(seg), seg[0]]))
            else:
                packets.append(bytes([start - x, len(seg)]) + seg.tobytes())
            x = end
            i = int(np.searchsorted(diff, end))
        out += bytes([len(packets)]) + b"".join(packets)
    return bytes(out)


def fli_ss2(old: np.ndarray, new: np.ndarray, skip_words: bool = True
            ) -> bytes:
    """An SS2 body (chunk 7, word deltas) turning `old` into `new`: a line
    count, then per line up to the last changed one a skip word over
    unchanged lines (or, without `skip_words`, a line of no packets for
    each), a last-byte word where the width is odd, a packet count and
    packets of a skip and a word count (255: a run of one word)."""
    h, w = new.shape
    even = w & ~1
    changed = [y for y in range(h) if (old[y] != new[y]).any()]
    out, lines, y = bytearray(), 0, 0
    for cy in changed:
        words = []
        if cy > y and skip_words:
            words.append(struct.pack("<H", (65536 - (cy - y)) & 0xFFFF))
        elif cy > y:
            out += bytes(2 * (cy - y))          # lines of no packets
            lines += cy - y
        if w & 1:
            words.append(struct.pack("<H", 0x8000 | int(new[cy, w - 1])))
        packets, x = [], 0
        for start in range(0, even, 2):
            if (old[cy, start:start + 2] == new[cy, start:start + 2]).all():
                continue
            while start - x > 255:
                packets.append(bytes([255, 0]))
                x += 255
            pair = new[cy, start:start + 2].astype(np.uint8).tobytes()
            kind = bytes([start - x, 255]) if start % 4 == 0 else \
                bytes([start - x, 1])
            packets.append(kind + pair)
            x = start + 2
        out += b"".join(words) + struct.pack("<H", len(packets)) + b"".join(
            packets)
        lines += 1
        y = cy + 1
    return struct.pack("<H", lines) + bytes(out)


def _palette_index(px: np.ndarray) -> tuple:
    """(palette (n, 3), (h, w) indices) of an RGB image of at most 256
    colours."""
    flat = px.reshape(-1, 3)
    pal, index = np.unique(flat, axis=0, return_inverse=True)
    if len(pal) > 256:
        raise ValueError("more than 256 colours")
    return pal, index.reshape(px.shape[:2])


def _cube(px: np.ndarray) -> tuple:
    """(palette, indices) of an RGB image quantised to a 6x7x6 cube."""
    steps = np.array([6, 7, 6])
    q = (px.astype(np.int64) * (steps - 1) + 127) // 255
    index = (q[..., 0] * 7 + q[..., 1]) * 6 + q[..., 2]
    r, g, b = np.meshgrid(np.arange(6), np.arange(7), np.arange(6),
                          indexing="ij")
    pal = np.stack([r * 51, g * 255 // 6, b * 51], -1).reshape(-1, 3)
    return pal, index


def pcd_bytes(rgb: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD file of a (512, 768, 3) image: "PCD_IPI" at byte 2048,
    the orientation at 2048 + 1538, and the base image at 96 x 2048 in
    PhotoYCC (two luma rows, then their 4:2:0 C1 and C2), the inverse of
    Pillow's YCC;P unpacker."""
    p = rgb.astype(np.float64)
    lum = (0.299 * p[..., 0] + 0.587 * p[..., 1] + 0.114 * p[..., 2])
    y = np.clip(np.round(lum / 1.3584), 0, 255)
    c1 = np.clip(np.round((p[..., 2] - lum) / 2.2179 + 156), 0, 255)
    c2 = np.clip(np.round((p[..., 0] - lum) / 1.8215 + 137), 0, 255)

    def sub(c):
        return np.round(c.reshape(256, 2, 384, 2).mean(axis=(1, 3)))

    chunks = np.concatenate([y.reshape(256, 1536), sub(c1), sub(c2)], 1)
    head = bytearray(96 * 2048)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    return bytes(head) + chunks.astype(np.uint8).tobytes()


def _card(key: str, value: str = None) -> bytes:
    text = key.ljust(8) if value is None else f"{key:<8}= {value:>20}"
    return text.ljust(80).encode()


def fits_bytes(values: np.ndarray, bitpix: int, *, cards=(),
               naxis: int = None, pad: bool = True) -> bytes:
    """A FITS file of (h, w) values (rows bottom-up, as FITS keeps them)
    of BITPIX 8, 16, 32, -32 or -64, big-endian, with extra header
    `cards`; `naxis` 1 writes one axis of w, 3 a third axis of 1."""
    h, w = values.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    naxis = naxis or 2
    head = [_card("SIMPLE", "T"), _card("BITPIX", str(bitpix)),
            _card("NAXIS", str(naxis)), _card("NAXIS1", str(w))]
    if naxis > 1:
        head.append(_card("NAXIS2", str(h)))
    if naxis > 2:
        head.append(_card("NAXIS3", "1"))
    head += [_card(*c) if isinstance(c, tuple) else c for c in cards]
    head.append(_card("END"))
    head = b"".join(head)
    head += b" " * (-len(head) % 2880)
    data = values[::-1].astype(dt).tobytes()
    return head + data + (bytes(-len(data) % 2880) if pad else b"")


def fits_gzip(values: np.ndarray, zbitpix: int = 16, tiles: int = 1
              ) -> bytes:
    """A FITS file whose image is a tile-compressed BINTABLE (ZIMAGE = T,
    ZCMPTYPE 'GZIP_1  ') of (h, w) values, the heap one gzip member a
    tile of rows, each pixel as 4 big-endian bytes (Pillow keeps the last
    ZBITPIX / 8 of them); the file ends with the heap, as Pillow's reader
    wants it."""
    import gzip
    h, w = values.shape
    rows = values[::-1].astype(">i4")
    parts = np.array_split(rows, tiles)
    members = [gzip.compress(p.tobytes(), mtime=0) for p in parts]
    primary = [_card("SIMPLE", "T"), _card("BITPIX", "8"),
               _card("NAXIS", "0"), _card("EXTEND", "T"), _card("END")]
    prim = b"".join(primary)
    prim += b" " * (-len(prim) % 2880)
    table = b"".join(struct.pack(">ii", len(m), sum(len(x) for x in
                                                    members[:i]))
                     for i, m in enumerate(members))
    ext = [_card("XTENSION", "'BINTABLE'"), _card("BITPIX", "8"),
           _card("NAXIS", "2"), _card("NAXIS1", "8"),
           _card("NAXIS2", str(tiles)), _card("PCOUNT",
                                              str(sum(map(len, members)))),
           _card("GCOUNT", "1"), _card("TFIELDS", "1"),
           _card("TTYPE1", "'COMPRESSED_DATA'"), _card("TFORM1", "'1PB'"),
           _card("ZIMAGE", "T"), _card("ZBITPIX", str(zbitpix)),
           _card("ZNAXIS", "2"), _card("ZNAXIS1", str(w)),
           _card("ZNAXIS2", str(h)), _card("ZTILE1", str(w)),
           _card("ZTILE2", str(-(-h // tiles))),
           _card("ZCMPTYPE", "'GZIP_1  '"), _card("END")]
    ext = b"".join(ext)
    ext += b" " * (-len(ext) % 2880)
    return prim + ext + table + b"".join(members)


def iptc_field(rec: int, num: int, value: bytes, extended: bool = False
               ) -> bytes:
    """An IPTC/NAA field: 0x1C, record, dataset, a 2-byte size (or, where
    `extended`, the size as PIL reads an extended one: 0x84 in place of
    its first byte and the size in the 4 bytes after the header)."""
    if extended:
        return bytes([0x1C, rec, num, 0x84, 0]) + struct.pack(
            ">I", len(value)) + value
    return bytes([0x1C, rec, num]) + struct.pack(">H", len(value)) + value


def iptc_bytes(w: int, h: int, data: bytes, layers: int = 1,
               component: int = 0, compression: int = 1, band: int = None,
               chunk: int = 30000) -> bytes:
    """An IPTC/NAA image: its size, layers, compression (1 raw, 5 JPEG)
    and band fields, then the data in (8, 10) fields of `chunk` bytes."""
    fields = [iptc_field(2, 5, b"make_image_formats"),
              iptc_field(3, 60, bytes([layers, component])),
              iptc_field(3, 20, struct.pack(">H", w)),
              iptc_field(3, 30, struct.pack(">H", h)),
              iptc_field(3, 120, bytes([compression]))]
    if band is not None:
        fields.append(iptc_field(3, 65, bytes([band])))
    for at in range(0, len(data), chunk):
        fields.append(iptc_field(8, 10, data[at:at + chunk]))
    return b"".join(fields)


def _port_png(name: str) -> np.ndarray:
    from rlshaders_tpu_torch.scene.png import decode_png
    with open(os.path.join(modes.DATA, name), "rb") as f:
        return decode_png(f.read())


def _read(*parts: str) -> bytes:
    with open(os.path.join(modes.DATA, *parts), "rb") as f:
        return f.read()


def _mutate(data: bytes, edits) -> bytes:
    out = bytearray(data)
    for at, value in edits:
        out[at] = value
    return bytes(out)


def idct_extremes() -> bytes:
    """A grey JPEG of eight blocks of extreme coefficients under a 16-bit
    table with values past 32767 (negative as libjpeg-turbo's 16-bit
    multiplier), where libjpeg-turbo's SIMD IDCT and its C routine give
    other samples: full-range AC values, a DC-only block (the column
    pass's shortcut) and DC values whose product wraps."""
    rng = np.random.default_rng(19001)
    blocks = np.zeros((1, 8, 64), np.int64)
    for b in range(8):
        idx = rng.choice(64, 12 + 6 * b, replace=False)
        blocks[0, b, idx] = rng.integers(-32767, 32768, len(idx))
    blocks[0, 3, 1:] = 0                       # DC only
    blocks[0, 4, 8:] = 0                       # AC in the first row only
    blocks[0, :, 0] = (-30000, 20000, -5000, 32000, 900, -32000, 0, 12345)
    qt = rng.integers(1, 65536, 64)
    qt[0] = 40000
    return jpeg_blocks(blocks, 64, 8, qt, wide=True)


def grey_restart() -> bytes:
    """A seeded 64x40 grey JPEG with a restart marker every 3 blocks."""
    img = np.random.default_rng(3).integers(0, 256, (40, 64))
    return jpeg_grey(img.astype(np.uint8), restart=3)


# damaged JPEGs: (base, one-byte edits (offset, value), cut (EOI then
# appended) or bytes appended after dropping the EOI): each a case of
# tests/test_torch_image_jpeg_damaged.py's fuzz that PIL decodes. A base
# is a file under scenes/data or one of the writers above ("@name").
_WRITTEN = {"grey_restart": grey_restart, "idct_extremes": idct_extremes}
DAMAGED = {
    # the SIMD IDCT's samples differ from the C routine's (268 pixels)
    "grid_simd_idct.jpg": ("grid.jpg", [(2664, 229)], None),
    # a marker made mid-scan: the rest of the scan is grey
    "grid_marker_hit.jpg": ("grid.jpg", [(8688, 255)], None),
    "grid_bad_code.jpg": ("grid.jpg", [(9944, 21)], None),
    # the EOI lost and two bytes after the scan: the bit buffer's last
    # read-ahead stops short of the end, so PIL decodes it
    "grid_eoi_lost.jpg": ("grid.jpg", [], b"\x00\x00"),
    "logo_progressive_damaged.jpg": ("modes/logo_progressive.jpg",
                                     [(5770, 131)], None),
    "logo_progressive_refine_damaged.jpg": ("modes/logo_progressive.jpg",
                                            [(9059, 243)], None),
    # cut after its fourth scan: block smoothing fills the low AC
    "logo_progressive_smoothed.jpg": ("modes/logo_progressive.jpg", [],
                                      3984),
    # the second restart marker turned into RST3: libjpeg resyncs
    "grey_restart_resync.jpg": ("@grey_restart", [(970, 0xD3)], None),
    "idct_extremes.jpg": ("@idct_extremes", [], None),
    "odd_lab_jpeg_damaged.tif": ("formats_h/odd_lab_jpeg.tif",
                                 [(1199, 130)], None),
}


def damaged_jpegs() -> dict:
    """{name: bytes} of DAMAGED."""
    out = {}
    for name, (base, edits, end) in DAMAGED.items():
        data = _WRITTEN[base[1:]]() if base.startswith("@") else _read(
            *base.split("/"))
        data = _mutate(data, edits)
        if isinstance(end, int):
            data = data[:end] + b"\xff\xd9"
        elif end is not None:
            data = data[:-2] + end
        out[name] = data
    return out


def flc_texture(side_w: int = 640, side_h: int = 480) -> bytes:
    """Frame S's FLC: the 2048x2048 texture's top-left corner quantised to
    a 6x7x6 cube, as one BRUN frame with its COLOR_256 palette."""
    tex = modes.big_texture()[:side_h, :side_w]
    pal, index = _cube(tex)
    return fli_bytes(side_w, side_h, [[(4, fli_colour(pal)),
                                       (15, fli_brun(index))]])


def files_i() -> dict:
    """{name in scenes/data/formats_i: bytes}, written by hand with no
    PIL: FLI and FLC files of every sub-chunk type (COLOR_64, COLOR_256,
    BRUN, LC, SS2, BLACK, COPY, PSTAMP) and frame S's 640x480 FLC; a
    768x512 PhotoCD and its two turned orientations; FITS of each BITPIX,
    one and three axes and a GZIP_1 tile table, and frame T's 512x512
    16-bit height map (GZIP_1 tiles, to keep the folder small); raw and
    JPEG IPTC (grey, a band
    of RGB and CMYK, a colour JPEG); and damaged JPEGs (DAMAGED)."""
    logo = _port_png("logo.png")
    grid = _port_png("grid.png")
    rng = np.random.default_rng(19000)
    out = {}
    # FLI / FLC
    gpal, gidx = _palette_index(grid)
    lpal, lidx = _palette_index(logo)
    out["grid_brun.flc"] = fli_bytes(256, 256, [[
        (4, fli_colour(gpal)), (15, fli_brun(gidx))]])
    black = np.zeros_like(lidx)
    out["logo_color64_lc.fli"] = fli_bytes(300, 200, [[
        (11, fli_colour(lpal, six_bit=True)), (13, b""),
        (12, fli_lc(black, lidx))], [(13, b"")]], flc=False, flags=0)
    odd = rng.integers(0, 40, (37, 53)).astype(np.uint8)
    odd2 = odd.copy()
    odd2[5:30:3, 4:50] = rng.integers(0, 40, (9, 46))
    out["odd_copy_ss2.flc"] = fli_bytes(53, 37, [[
        (4, fli_colour(rng.integers(0, 256, (40, 3)), packets=[(3, 20),
                                                            (5, 15)])),
        (16, odd.tobytes()), (7, fli_ss2(odd, odd2)),
        (18, bytes(64))]])
    out["texture_640_brun.flc"] = flc_texture()
    # PhotoCD
    tex = modes.big_texture()[::4, ::4][:512, :768]
    tex = np.pad(tex, ((0, 0), (0, 768 - tex.shape[1]), (0, 0)),
                 mode="reflect")
    for turn, name in ((0, "photo_768.pcd"), (1, "photo_768_turn90.pcd"),
                       (3, "photo_768_turn270.pcd")):
        out[name] = pcd_bytes(tex, turn)
    # FITS
    y, x = np.mgrid[0:37, 0:53]
    ramp = (x * 4 + y * 3) % 256
    out["odd_8bit.fits"] = fits_bytes(ramp, 8, cards=[
        ("BZERO", "0"), ("BSCALE", "1"), _card("COMMENT   hand-written")])
    out["odd_16bit.fits"] = fits_bytes(
        (ramp << 8) + (rng.random((37, 53)) < 0.1) * 3, 16)
    out["odd_32bit.fits"] = fits_bytes(
        (ramp.astype(np.int64) << 24) - (1 << 31) * (ramp > 200), 32)
    f32 = np.frombuffer(np.asarray(ramp - 20.5, "<f4").tobytes(), ">f4")
    out["odd_float32.fits"] = fits_bytes(f32.reshape(37, 53), -32)
    out["odd_float64.fits"] = fits_bytes(
        rng.normal(0, 1, (37, 53)), -64)
    out["odd_naxis1.fits"] = fits_bytes(ramp[:1], 8, naxis=1)
    out["odd_naxis3.fits"] = fits_bytes(ramp, 8, naxis=3)
    out["odd_gzip_tiles.fits"] = fits_gzip((ramp << 16) + ramp, 16, 3)
    height = modes.big_texture()[::4, ::4, 1][:512, :512].astype(np.int64)
    out["height_512_16bit_gzip.fits"] = fits_gzip(
        (height << 8) + (height > 230) * 7, 16, 8)
    # IPTC
    out["odd_raw_grey.iptc"] = iptc_bytes(53, 37, ramp.astype(
        np.uint8).tobytes(), chunk=500)
    out["logo_raw_rgb_band.iptc"] = iptc_bytes(
        300, 200, logo[..., 1].tobytes(), 3, 1, band=2)
    out["odd_raw_cmyk_band.iptc"] = iptc_bytes(
        53, 37, ramp.astype(np.uint8).tobytes(), 4, 1, band=4)
    out["odd_jpeg_grey.iptc"] = iptc_bytes(
        53, 37, jpeg_grey(ramp.astype(np.uint8)), compression=5)
    out["grid_jpeg_rgb.iptc"] = iptc_bytes(256, 256, _read("grid.jpg"),
                                           compression=5)
    out.update(damaged_jpegs())
    return out


BOMBS = os.path.join(os.path.dirname(modes.DATA), "bombs")


def bomb_files() -> dict:
    """{name in scenes/bombs: bytes}: for each of PIL's formats the
    port decodes, a header-only file of 13,380 x 13,380 pixels, past
    PIL's decompression-bomb limit (tests/test_torch_image_bomb.py holds
    each to PIL), and the whole 1-bit PNG of that size."""
    out = {f"{fmt.lower()}.bomb": data for fmt, (data, _) in
           bomb_cases().items()}
    out["png_whole.bomb"] = fault5_png()
    return out


# the sets of committed files: folder -> (its files, the digests' name)
SETS = {"formats": (files, "FORMAT_DIGESTS"),
        "formats_b": (files_b, "FORMAT_B_DIGESTS"),
        "formats_c": (files_c, "FORMAT_C_DIGESTS"),
        "formats_d": (files_d, "FORMAT_D_DIGESTS"),
        "formats_e": (files_e, "FORMAT_E_DIGESTS"),
        "formats_f": (files_f, "FORMAT_F_DIGESTS"),
        "formats_g": (files_g, "FORMAT_G_DIGESTS"),
        "formats_h": (files_h, "FORMAT_H_DIGESTS"),
        "formats_i": (files_i, "FORMAT_I_DIGESTS")}


def main(argv=None) -> None:
    """Write the folder named on the command line (scenes/data/formats by
    default, formats_b, formats_c, formats_d, formats_e, formats_f,
    formats_g, formats_h or formats_i) and
    print its digests; `bombs` writes scenes/bombs (outside scenes/data:
    no texture; each file raises)."""
    argv = sys.argv[1:] if argv is None else argv
    folder = argv[0] if argv else "formats"
    out = os.path.join(modes.DATA, folder)
    if folder == "bombs":
        out = BOMBS
        os.makedirs(out, exist_ok=True)
        for name, data in sorted(bomb_files().items()):
            with open(os.path.join(out, name), "wb") as f:
                f.write(data)
        return
    make, label = SETS[folder]
    os.makedirs(out, exist_ok=True)
    print(f"{label} = {{")
    for name, data in sorted(make().items()):
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        print(f'    "scenes/data/{folder}/{name}":\n'
              f'        "{modes.digest(data)}",')
    print("}")


if __name__ == "__main__":
    main()
