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


def main() -> None:
    os.makedirs(FORMATS, exist_ok=True)
    print("FORMAT_DIGESTS = {")
    for name, data in sorted(files().items()):
        with open(os.path.join(FORMATS, name), "wb") as f:
            f.write(data)
        print(f'    "scenes/data/formats/{name}":\n'
              f'        "{modes.digest(data)}",')
    print("}")


if __name__ == "__main__":
    main()
