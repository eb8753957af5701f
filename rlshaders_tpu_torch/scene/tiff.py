"""TIFF decoding in numpy (zlib, scene/lzw.py, scene/jpeg.py and
scene/ccitt.py for the data), equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_tiff` returns those bytes for the first image (IFD) of a TIFF, as
PIL's `open` reads it:

* II and MM byte order; strips and tiles; planar configuration 1 (chunky)
  and 2 (one plane a sample);
* compression none, LZW (most significant bit first, the early width
  change), PackBits, Deflate and Adobe Deflate; predictor 1 and 2
  (horizontal differences at 8 and 16 bits);
* JPEG compression (7) as libtiff hands it to PIL: each strip or tile a
  JPEG stream read after the shared JPEGTables (tag 347), so it may be
  abbreviated; under photometric YCbCr libjpeg converts it to RGB
  (upsampling subsampled chroma as libjpeg does), under any other the
  decoded components are the samples (grey, grey and alpha, RGB, RGBA,
  CMYK), whatever markers the stream holds;
* CCITT compression of bilevel images (scene/ccitt.py): modified Huffman
  (2), Group 3 one- or two-dimensional with or without fill bits (3) and
  Group 4 (4), fill order 1 or 2, MinIsWhite or MinIsBlack;
* the sample layouts of PIL's TiffImagePlugin.OPEN_INFO for unsigned
  samples: MinIsWhite (0) and MinIsBlack (1) grey of 1, 2, 4, 8 and 16
  bits, grey and alpha, RGB of 8 and 16 bits with an alpha or unused
  extra sample, palette (3) of 1, 2, 4 or 8 bits, CMYK (5) of 8 or 16
  bits.

The samples map to 8 bits as PIL's modes and unpackers map them: 16-bit
samples keep their high byte, but 16-bit grey opens as "I;16" (or
"I;16B"), whose RGB clamps to 255, and is not inverted under MinIsWhite;
1-, 2- and 4-bit grey scale by 255, 85 and 17 (inverted under
MinIsWhite); an associated (premultiplied) alpha divides the colour as
PIL's "RGBa" unpacker does; a palette keeps the high byte of ColorMap;
CMYK converts as Pillow's cmyk2rgb, (255 - C)(255 - K) / 255. EXIF
orientation is not applied, as PIL's `open` does not apply it.

A valid file of a layout or compression that PIL opens but the port does
not (old-style JPEG, LZMA, ZSTD and WebP compression, fill order 2 but
under CCITT compression, planar or non-8-bit JPEG data, orientations 5-8,
uncompressed planar 16-bit data that PIL misreads) or that PIL cannot
open raises NotImplementedError naming it; malformed data raises
ValueError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import bomb
from . import ccitt, lzw
from .jpeg import decode_planes, muldiv255, ycc_to_rgb
from .png import unpack_samples

MAGICS = (b"II*\x00", b"MM\x00*", b"MM*\x00", b"II\x00*")
BIGTIFF = (b"II+\x00", b"MM\x00+")

_COMPRESSIONS = {
    6: "old-style JPEG", 32771: "16-bit padded raw", 32809: "ThunderScan",
    34676: "SGILog", 34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD",
    50001: "WebP",
}
_TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
         262: "photometric", 266: "fill_order", 273: "strip_offsets",
         274: "orientation", 277: "samples", 278: "rows_per_strip",
         279: "strip_counts", 284: "planar", 317: "predictor",
         292: "t4options", 320: "colormap", 322: "tile_width",
         323: "tile_length", 324: "tile_offsets", 325: "tile_counts",
         338: "extra", 339: "sample_format", 347: "jpeg_tables"}
_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i"}
_CCITT = (2, 3, 4)


def _layout(big: bool, photo: int, bits: tuple, extra: tuple):
    """What PIL's OPEN_INFO makes of these unsigned samples: (kind, bits a
    sample), kind one of grey, grey_inv, grey16, rgb, rgba_pre, palette,
    cmyk; None where PIL has no mode for them."""
    n = len(bits)
    if len(set(bits)) != 1:
        return None
    b = bits[0]
    if n == 1 and photo in (0, 1):
        if b in (1, 2, 4, 8):
            return ("grey" if photo else "grey_inv"), b
        if b == 16 and (photo == 1 or not big):
            return "grey16", b
    if photo == 1 and bits == (8, 8) and extra == (2,):
        return "grey", 8
    if photo == 2 and b in (8, 16):
        if n == 3 and not extra:
            return "rgb", b
        if n == 4 and (not extra or extra in ((0,), (2,))
                       or (b == 8 and extra == (999,))):
            return "rgb", b
        if n == 4 and extra == (1,):
            return "rgba_pre", b
        if b == 8 and n in (5, 6) and extra[1:] == (0,) * (n - 4) \
                and extra[0] in (0, 1, 2):
            return ("rgba_pre" if extra[0] == 1 else "rgb"), b
    if photo == 3 and n == 1 and b in (1, 2, 4, 8):
        return "palette", b
    if photo == 3 and bits == (8, 8) and extra in ((0,), (2,)):
        return "palette", 8
    if photo == 5 and ((b == 8 and n == 4 + len(extra) and n <= 6
                        and not any(extra))
                       or (b == 16 and n == 4 and not extra)):
        return "cmyk", b
    return None


def _planar_kind(kind: str, depth: int, spp: int, extra: tuple,
                 compression: int, tiled: bool) -> str:
    """The layout of a planar-configuration-2 image as PIL reads it. PIL
    reads an uncompressed one plane by plane, each as one letter of its
    raw mode (so 16-bit planes, two-sample planes, an associated alpha,
    the edge tiles of four planes and one plane of any raw mode longer
    than a letter fail or misread; an unused extra sample fails in
    strips), and a compressed one through libtiff's RGBA
    reader, which takes four RGB samples without ExtraSamples as colour
    premultiplied by alpha."""
    one_letter = (kind, depth) in (("grey", 1), ("grey", 8), ("palette", 8))
    if 0 in extra or (compression == 1 and (
            depth == 16 or spp == 2 or kind == "rgba_pre"
            or (tiled and spp > 3) or (spp == 1 and not one_letter))):
        raise NotImplementedError(
            f"planar TIFF of {spp} {depth}-bit samples with extra samples "
            f"{extra} and compression {compression} (which PIL misreads "
            f"or refuses) is not decoded by the port")
    if compression != 1 and kind == "rgb" and spp == 4 and not extra:
        return "rgba_pre"
    return kind


def _ifd(data: bytes) -> dict:
    """The tags of the first IFD that the decoder reads, by name, each a
    tuple of integers."""
    if data[:4] in BIGTIFF:
        raise NotImplementedError("BigTIFF images are not decoded by the "
                                  "port")
    if data[:4] not in MAGICS or len(data) < 8:
        raise ValueError("not a TIFF file")
    e = ">" if data[:2] == b"MM" else "<"
    pos = struct.unpack(e + "I", data[4:8])[0]
    if pos + 2 > len(data):
        raise ValueError("TIFF IFD offset past the end of the file")
    count = struct.unpack(e + "H", data[pos:pos + 2])[0]
    if pos + 2 + 12 * count > len(data):
        raise ValueError("TIFF IFD runs past the end of the file")
    tags = {"big": e == ">"}
    for i in range(count):
        entry = data[pos + 2 + 12 * i:pos + 14 + 12 * i]
        tag, typ, n = struct.unpack(e + "HHI", entry[:8])
        if tag not in _TAGS or typ not in _TYPES:
            continue
        size = struct.calcsize(_TYPES[typ]) * n
        if size <= 4:
            raw = entry[8:8 + size]
        else:
            off = struct.unpack(e + "I", entry[8:12])[0]
            raw = data[off:off + size]
            if len(raw) < size:
                raise ValueError(f"TIFF tag {tag} runs past the end of "
                                 f"the file")
        tags[_TAGS[tag]] = (raw if typ == 7 else
                            struct.unpack(e + _TYPES[typ] * n, raw))
    return tags


def _packbits(raw: bytes, need: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw) and len(out) < need:
        n = raw[i]
        i += 1
        if n < 128:
            out += raw[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += raw[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _inflate(raw: bytes, compression: int, need: int) -> bytes:
    """The decompressed bytes of one strip or tile."""
    if compression == 1:
        return raw
    if compression == 5:
        if raw[:1] == b"\x00" and raw[1:2] and raw[1] & 1:
            raise NotImplementedError("TIFF with old-style (least "
                                      "significant bit first) LZW is not "
                                      "decoded by the port")
        return lzw.decode(raw, 8, True, 1, need)
    if compression in (8, 32946):
        try:
            return zlib.decompressobj().decompress(raw)
        except zlib.error as err:
            raise ValueError(f"corrupt TIFF Deflate data: {err}") from None
    return _packbits(raw, need)


def _one(tags: dict, name: str, default=None):
    v = tags.get(name)
    return default if v is None else v[0]


def decode_tiff(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of the first image of a TIFF, PIL's
    `convert("RGB")` of it byte for byte."""
    tags = _ifd(data)
    if "width" not in tags or "height" not in tags:
        raise ValueError("TIFF without its image width and length")
    w, h = _one(tags, "width"), _one(tags, "height")
    bomb.check("TIFF", w, h)
    compression = _one(tags, "compression", 1)
    photo = _one(tags, "photometric", 0)
    planar = _one(tags, "planar", 1)
    predictor = _one(tags, "predictor", 1)
    if compression in _COMPRESSIONS:
        raise NotImplementedError(f"TIFF with {_COMPRESSIONS[compression]} "
                                  f"compression is not decoded by the port")
    if compression not in (1, 2, 3, 4, 5, 7, 8, 32773, 32946):
        raise NotImplementedError(f"TIFF compression {compression} is not "
                                  f"decoded by the port")
    fill_order = _one(tags, "fill_order", 1)
    if fill_order != 1 and compression not in _CCITT:
        raise NotImplementedError("TIFF with fill order 2 (least "
                                  "significant bit first) is decoded by "
                                  "the port under CCITT compression only")
    if _one(tags, "orientation", 1) in (5, 6, 7, 8):
        raise NotImplementedError("TIFF with a transposing orientation "
                                  "(5-8) is not decoded by the port")
    fmt = tags.get("sample_format", (1,))
    if any(f != 1 for f in fmt):
        raise NotImplementedError(f"TIFF with sample format {fmt} (signed "
                                  f"or floating point) is not decoded by "
                                  f"the port")
    spp = _one(tags, "samples", 1)
    bits = tags.get("bits", (1,))
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    extra = tags.get("extra", ())
    layout = _layout(tags["big"], photo, bits, extra)
    if compression == 7 and photo == 6 and bits == (8, 8, 8) \
            and not extra and planar == 1:
        layout = ("ycbcr", 8)          # libjpeg converts it to RGB
    if compression in _CCITT and layout not in (("grey", 1),
                                                ("grey_inv", 1)):
        raise NotImplementedError(
            f"CCITT-compressed TIFF of photometric {photo} and bits {bits} "
            f"(not a bilevel image) is not decoded by the port")
    if compression == 7 and (planar != 1 or bits[0] != 8):
        raise NotImplementedError(
            f"JPEG-compressed TIFF of {bits[0]}-bit samples in planar "
            f"configuration {planar} is not decoded by the port")
    if layout is None or len(bits) != spp:
        raise NotImplementedError(
            f"TIFF with photometric {photo}, bits {bits} and extra samples "
            f"{extra} is not decoded by the port")
    kind, depth = layout
    # a predictor applies to LZW and Deflate data only (libtiff)
    if compression in (5, 8, 32946) and (predictor not in (1, 2) or (
            predictor == 2 and depth not in (8, 16))):
        raise NotImplementedError(f"TIFF predictor {predictor} at {depth} "
                                  f"bits is not decoded by the port")
    if planar == 2:
        kind = _planar_kind(kind, depth, spp, extra, compression,
                            "tile_offsets" in tags)
    if w == 0 or h == 0:
        raise ValueError(f"TIFF of {w}x{h} pixels")

    if "tile_offsets" in tags:
        tw, th = _one(tags, "tile_width", 0), _one(tags, "tile_length", 0)
        if not tw or not th:
            raise ValueError("TIFF tiles without a width and length")
        offsets, counts = tags["tile_offsets"], tags.get("tile_counts", ())
        cells = [(x, y, tw, th) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    elif "strip_offsets" in tags:
        rps = min(_one(tags, "rows_per_strip", h), h) or h
        offsets, counts = tags["strip_offsets"], tags.get("strip_counts",
                                                          ())
        cells = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
    else:
        raise ValueError("TIFF without strip or tile offsets")
    planes = [list(range(spp))] if planar == 1 else [[s]
                                                     for s in range(spp)]
    if len(offsets) < len(cells) * len(planes):
        raise ValueError(f"TIFF holds {len(offsets)} strips or tiles, its "
                         f"layout needs {len(cells) * len(planes)}")

    px = np.zeros((h, w, spp), np.int32)
    i = 0
    for chans in planes:
        for x, y, cw, ch in cells:
            n = len(chans)
            rowbytes = (cw * n * depth + 7) // 8
            need = ch * rowbytes
            off = offsets[i]
            end = off + (need if compression == 1 or i >= len(counts)
                         else counts[i])
            i += 1
            if compression == 7:
                px[y:y + ch, x:x + cw] = _jpeg_cell(
                    data[off:end], tags, cw, ch, spp)[:h - y, :w - x]
                continue
            if compression in _CCITT:
                px[y:y + ch, x:x + cw, 0] = ccitt.decode(
                    data[off:end], cw, ch, compression,
                    _one(tags, "t4options", 0), fill_order)[:h - y, :w - x]
                continue
            raw = _inflate(data[off:end], compression, need)
            if len(raw) < need:
                raise ValueError(f"TIFF strip or tile {i - 1} holds "
                                 f"{len(raw)} bytes, its rows need {need}")
            rows = np.frombuffer(raw[:need], np.uint8).reshape(ch, rowbytes)
            s = unpack_samples(rows, cw * n, depth, tags["big"]).reshape(
                ch, cw, n)
            if predictor == 2 and compression in (5, 8, 32946):
                s = np.cumsum(s, axis=1) & ((1 << depth) - 1)
            px[y:y + ch, x:x + cw][..., chans] = s[:h - y, :w - x]
    return _to_rgb(px, kind, depth, tags)


def _jpeg_cell(stream: bytes, tags: dict, cw: int, ch: int,
               spp: int) -> np.ndarray:
    """(ch, cw, spp) int32 of one JPEG-compressed strip or tile, as
    libtiff hands it to PIL: its JPEGTables read first; under photometric
    YCbCr libjpeg's conversion to RGB (upsampled as libjpeg upsamples),
    under any other the decoded components as they are."""
    planes, _, _ = decode_planes(stream, tags.get("jpeg_tables", b""))
    if len(planes) != spp:
        raise ValueError(f"TIFF JPEG strip or tile of {len(planes)} "
                         f"components, the image has {spp} samples")
    jh, jw = planes[0][0].shape
    if jh < ch or jw < cw:
        raise ValueError(f"TIFF JPEG strip or tile of {jw}x{jh} samples, "
                         f"its cell is {cw}x{ch}")
    if _one(tags, "photometric") == 6:
        out = ycc_to_rgb(*(p for p, _ in planes))
    else:
        out = np.stack([p for p, _ in planes], -1)
    return out[:ch, :cw].astype(np.int32)


def _to_rgb(px: np.ndarray, kind: str, depth: int, tags: dict):
    """(h, w, 3) uint8 of the samples as PIL's mode for them converts
    them to RGB."""
    if kind == "palette":
        cmap = np.asarray(tags.get("colormap", ()), np.int64)
        if cmap.size == 0:
            raise ValueError("palette TIFF without a ColorMap")
        n = cmap.size // 3
        pal = np.zeros((max(256, n), 3), np.uint8)
        pal[:n] = (cmap[:3 * n].reshape(3, n).T >> 8).astype(np.uint8)
        return pal[px[..., 0]]
    if kind in ("grey", "grey_inv"):
        g = px[..., 0] * (255 // ((1 << depth) - 1))
        g = 255 - g if kind == "grey_inv" else g
        return np.repeat(g[..., None], 3, axis=2).astype(np.uint8)
    if kind == "grey16":
        g = np.minimum(px[..., 0], 255)
        return np.repeat(g[..., None], 3, axis=2).astype(np.uint8)
    if kind == "ycbcr":
        return px.astype(np.uint8)
    if depth == 16:
        px = px >> 8
    if kind == "cmyk":
        k = 255 - px[..., 3:4]
        return muldiv255(255 - px[..., :3], k).astype(np.uint8)
    rgb = px[..., :3]
    if kind == "rgba_pre":
        a = px[..., 3:4]
        rgb = np.where(a == 255, rgb, np.where(
            a == 0, 0, np.minimum(rgb * 255 // np.maximum(a, 1), 255)))
    return rgb.astype(np.uint8)
