"""TIFF decoding in numpy (zlib, lzma, scene/lzw.py, scene/zstd.py,
scene/jpeg.py and scene/ccitt.py for the data), equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_tiff` returns those bytes for the first image (IFD) of a TIFF, as
PIL's `open` reads it. PIL reads the tags itself (`_ifd`: it stops at a
tag whose data runs past the end of the file, and fails on bytes, text
or ratios where it wants an integer) and decodes an uncompressed image
with its own tiles (`_raw_pixels`); every other it hands to libtiff,
which reads the tags again with its own rules (`_libtiff_directory`):

* II and MM byte order; strips and tiles; planar configuration 1 (chunky)
  and 2 (one plane a sample);
* compression none, LZW (most significant bit first, the early width
  change), PackBits, Deflate, Adobe Deflate, LZMA and ZSTD (libtiff's
  codec: the strip's first frame, read until the rows are full,
  `zstd.tiff_strip`); predictor 1, 2 (horizontal differences at 8, 16
  and 32 bits) and 3 (libtiff's floating-point predictor: byte planes,
  then differences);
* JPEG compression (7) as libtiff hands it to PIL: each strip or tile a
  JPEG stream read after the shared JPEGTables (tag 347), so it may be
  abbreviated; under photometric YCbCr libjpeg converts it to RGB
  (upsampling subsampled chroma as libjpeg does), under any other the
  decoded components are the samples (grey, grey and alpha, RGB, RGBA,
  CMYK), whatever markers the stream holds;
* YCbCr (6) under any other compression, which PIL reads through
  libtiff's RGBA reader (`_ycbcr_rgba`): blocks of subsampled chroma at
  1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4, TIFFYCbCrToRGB's fixed-point
  tables from YCbCrCoefficients and ReferenceBlackWhite;
* CCITT compression of bilevel images (scene/ccitt.py): modified Huffman
  (2), Group 3 one- or two-dimensional with or without fill bits (3) and
  Group 4 (4), fill order 1 or 2, MinIsWhite or MinIsBlack;
* the sample layouts of PIL's TiffImagePlugin.OPEN_INFO: MinIsWhite (0)
  and MinIsBlack (1) grey of 1, 2, 4, 8 and 16 bits, grey and alpha, RGB
  of 8 and 16 bits with an alpha or unused extra sample, palette (3) of
  1, 2, 4 or 8 bits, CMYK (5) of 8 or 16 bits; signed grey of 8 bits
  (read as unsigned "L"), 16 and 32 bits (mode I), unsigned 32-bit grey
  in little-endian files (mode I), 32-bit float grey (mode F); CIELab
  (8) of three 8-bit samples, chunky, PIL's mode LAB: its unpacker flips
  the sign bit of a* and b*, and Pillow converts it to RGB through
  LittleCMS (`lab.to_rgb`).

The samples map to 8 bits as PIL's modes and unpackers map them: 16-bit
samples keep their high byte, but 16-bit grey opens as "I;16" (or
"I;16B"), whose RGB clamps to 255, and is not inverted under MinIsWhite;
1-, 2- and 4-bit grey scale by 255, 85 and 17 (inverted under
MinIsWhite); an associated (premultiplied) alpha divides the colour as
PIL's "RGBa" unpacker does; a palette keeps the high byte of ColorMap;
CMYK converts as Pillow's cmyk2rgb, (255 - C)(255 - K) / 255; mode I
clamps to 0..255 and mode F truncates and clamps (NaN 0). libtiff hands
PIL samples in native order, which PIL's I;16BS, I;32BS and F;32BF
unpackers read as big-endian: a big-endian file's signed and float
samples come out byte-swapped, as they do in PIL. Orientations 2-4 are
applied as PIL's exif_transpose applies them.

A valid file of a layout or compression that PIL opens but the port does
not (old-style JPEG, WebP and CCITT RLEW compression, fill order 2 but
under CCITT compression, planar or non-8-bit JPEG data, orientations
5-8, uncompressed planar data that PIL misreads, uncompressed or planar
YCbCr, YCbCr data that fails part way, planar LAB) or that PIL cannot
open raises NotImplementedError naming it (ICCLab and ITULab, 9 and 10,
among these); malformed data raises ValueError.
"""
from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from . import bomb
from . import ccitt, lab, lzw, zstd
from .jpeg import decode_planes, muldiv255, ycc_to_rgb
from .png import unpack_samples
from .pnm import float_to_rgb

MAGICS = (b"II*\x00", b"MM\x00*", b"MM*\x00", b"II\x00*")
BIGTIFF = (b"II+\x00", b"MM\x00+")

_COMPRESSIONS = {
    6: "old-style JPEG", 32771: "16-bit padded raw (CCITT RLEW)",
    32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24", 50001: "WebP",
}
# the codecs libtiff sets a predictor up for
_PREDICTED = (5, 8, 32946, 34925, 50000)
_TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
         262: "photometric", 266: "fill_order", 273: "strip_offsets",
         274: "orientation", 277: "samples", 278: "rows_per_strip",
         279: "strip_counts", 284: "planar", 317: "predictor",
         292: "t4options", 320: "colormap", 322: "tile_width",
         323: "tile_length", 324: "tile_offsets", 325: "tile_counts",
         338: "extra", 339: "sample_format", 347: "jpeg_tables",
         530: "ycbcr_subsampling"}
_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 13: "I",
          16: "Q", 17: "q"}
# the YCbCr tags libtiff reads as floats, from any of these types
_FLOAT_TAGS = {529: "ycbcr_coefficients", 532: "reference_black_white"}
_FLOAT_TYPES = {3: "H", 4: "I", 5: "II", 10: "ii", 11: "f", 12: "d"}
# libtiff's RGBA reader: the YCbCr subsamplings it converts
_SUBSAMPLINGS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
# the strip and tile arrays, which libtiff reads as far as the image needs
_STRILES = {273: "strip_offsets", 279: "strip_counts", 324: "tile_offsets",
            325: "tile_counts"}
# the tags libtiff's TIFFReadDirectory fails on where it cannot read them
# as one integer (a value a sample where marked)
_FATAL = {256: False, 257: False, 258: True, 259: True, 277: False,
          278: False, 280: True, 281: True, 284: False, 322: False,
          323: False, 339: True}
_LIB_INT_TYPES = (1, 3, 4, 6, 8, 9, 16, 17)
# the tags libtiff takes one value of (it ignores one of another count)
_SINGLE = (256, 257, 262, 266, 274, 277, 278, 284, 292, 317, 322, 323)
# the bytes a value of each type PIL's TIFF reader knows
_PIL_UNITS = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_LUMA = (0.299, 0.587, 0.114)
_REF_BW = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
_CCITT = (2, 3, 4)


def _layout(big: bool, photo: int, bits: tuple, extra: tuple,
            fmt: tuple = (1,)):
    """What PIL's OPEN_INFO makes of these samples: (kind, bits a
    sample), kind one of grey, grey_inv, grey16, rgb, rgba_pre, palette,
    cmyk, and for one grey sample of 32 bits or a signed or floating-point
    one: int16 and int32 (signed, mode I), uint32 (little-endian only,
    read as a signed int32) and float (mode F); None where PIL has no
    mode for them."""
    n = len(bits)
    if len(set(bits)) != 1:
        return None
    b = bits[0]
    if fmt != (1,) or b == 32:
        if n != 1 or extra:
            return None
        if fmt == (3,) and b == 32 and photo in (0, 1):
            return "float", 32
        if photo != 1:
            return None
        if fmt == (2,) and b in (8, 16, 32):
            return ("grey", "int16", "int32")[b // 16], b
        if fmt == (1,) and b == 32 and not big:
            return "uint32", 32
        return None
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
    if photo == 6 and bits == (8,):
        return "grey", 8
    if photo == 8 and bits == (8, 8, 8) and not extra:
        return "lab", 8
    if photo == 6 and bits == (8, 8, 8) and not extra:
        return "ycbcr_rgba", 8
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
    than a letter, but a 32-bit one, fail or misread; an unused extra
    sample fails in strips), and a compressed one through libtiff's RGBA
    reader, which takes four RGB samples without ExtraSamples as colour
    premultiplied by alpha."""
    one_letter = (kind, depth) in (("grey", 1), ("grey", 8), ("palette", 8),
                                   ("float", 32), ("int32", 32),
                                   ("uint32", 32))
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


def _value(e: str, tag: int, typ: int, n: int, raw: bytes):
    """(name, values) of a tag the decoder reads, or None."""
    if tag in _FLOAT_TAGS and typ in _FLOAT_TYPES:
        v = np.array(struct.unpack(e + _FLOAT_TYPES[typ] * n, raw),
                     np.float32)
        if typ in (5, 10):              # libtiff: (float) num / (float) den
            v = v.reshape(-1, 2)
            with np.errstate(all="ignore"):
                v = np.where(v[:, 1] == 0, np.float32(0), v[:, 0] / v[:, 1])
        return _FLOAT_TAGS[tag], tuple(np.float32(x) for x in v)
    if tag not in _TAGS or typ not in _TYPES or (typ == 7) != (tag == 347):
        return None
    return _TAGS[tag], (raw if typ == 7 else
                        struct.unpack(e + _TYPES[typ] * n, raw))


def _ifd(data: bytes) -> dict:
    """The tags of the first IFD that the decoder reads, by name, each a
    tuple of integers (floats for the YCbCr coefficients and reference),
    as PIL's reader leaves them: it skips a tag of a type it does not
    know or of no values, and stops at an entry or a tag's data that runs
    past the end of the file. "lib" holds the same as libtiff reads them
    (every entry, the first of a tag twice; a tag whose data runs past the
    end of the file skipped, a strip or tile array kept as far as it is
    in the file), with libtiff's (type, count, readable) of each tag
    ("entries"); "lib_broken" says whether libtiff can read the directory
    at all."""
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
    big = e == ">"
    tags = {"big": big}
    lib = {"big": big, "entries": {}, "_file": data, "_all": []}
    tags["lib"] = lib
    tags["lib_broken"] = pos + 2 + 12 * count > len(data)
    pil_open = True
    for i in range(count):
        entry = data[pos + 2 + 12 * i:pos + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, typ, n = struct.unpack(e + "HHI", entry[:8])
        size = _PIL_UNITS.get(typ, 0) * n
        whole = True
        if size <= 4:
            raw = entry[8:8 + size]
        else:
            off = struct.unpack(e + "I", entry[8:12])[0]
            raw = data[off:off + size]
            whole = len(raw) == size
        lib["entries"].setdefault(tag, (typ, n, whole))
        lib["_all"].append((typ, n))
        if not whole:
            pil_open = False            # PIL's "Truncated File Read"
            if tag in _STRILES and typ in _TYPES and typ != 7:
                k = struct.calcsize(_TYPES[typ])
                lib[_STRILES[tag]] = struct.unpack(
                    e + _TYPES[typ] * (len(raw) // k), raw[:len(raw) // k * k])
                lib["short_" + _STRILES[tag]] = True
            continue
        if typ not in _PIL_UNITS or n == 0:
            continue
        got = _value(e, tag, typ, n, raw)
        if got is not None and got[0] not in lib and (
                n == 1 or tag not in _SINGLE):
            lib[got[0]] = got[1]        # libtiff: the first of a tag
        if pil_open and tag in _TAGS and tag != 347 and (
                got is None or typ == 1):
            # PIL holds bytes, a string, a ratio or a float where it wants
            # an integer of this tag, and fails
            raise ValueError(f"TIFF tag {tag} of type {typ}")
        if pil_open and got is not None:
            tags[got[0]] = got[1]
    return tags


def _packbits(raw: bytes, need: int) -> bytes:
    """libtiff's PackBitsDecode: a record past `need` is cut to it, a
    literal record the data ends inside is dropped."""
    out = bytearray()
    i = 0
    while i < len(raw) and len(out) < need:
        n = raw[i]
        i += 1
        if n < 128:
            k = min(n + 1, need - len(out))
            if i + k > len(raw):
                break
            out += raw[i:i + k]
            i += n + 1
        elif n > 128:
            if i >= len(raw):
                break
            out += raw[i:i + 1] * min(257 - n, need - len(out))
            i += 1
    return bytes(out)


def _libtiff_directory(tags: dict) -> dict:
    """libtiff's view of the IFD where PIL hands it the file (every
    compressed TIFF): a directory that runs past the end of the file, or
    a tag it needs as one integer (or one a sample) of another type or
    count, or whose data runs past the end of the file, fails the file.
    Where PIL's reader (which stops at such a tag) and libtiff's then
    disagree on what the samples are, the port names the file."""
    lib = tags["lib"]
    if tags["lib_broken"]:
        raise ValueError("libtiff cannot read the TIFF directory")
    if _one(lib, "planar", 1) not in (1, 2) or 0 in (
            _one(lib, "rows_per_strip", 1), _one(lib, "samples", 1)):
        raise ValueError("libtiff refuses the TIFF planar configuration, "
                         "rows per strip or samples per pixel")
    spp = _one(lib, "samples", 1)
    for tag, (typ, n, whole) in lib["entries"].items():
        if tag not in _FATAL:
            continue
        vals = lib.get(_TAGS.get(tag), ())
        per_sample = _FATAL[tag] and n >= max(spp, 1) and \
            len(set(vals[:spp])) <= 1
        if (not whole or typ not in _LIB_INT_TYPES
                or (n != 1 and not per_sample) or any(v < 0 for v in vals)):
            raise ValueError(f"libtiff cannot read TIFF tag {tag}")
    for name, default in (("width", None), ("height", None),
                          ("compression", 1), ("photometric", None),
                          ("samples", 1), ("planar", 1), ("bits", 1),
                          ("extra", None),
                          ("fill_order", 1)):
        if tags.get(name, (default,))[:1] != lib.get(name, (default,))[:1]:
            raise NotImplementedError(
                f"TIFF whose {name} PIL and libtiff read differently (a "
                f"tag before it runs past the end of the file) is not "
                f"decoded by the port")
    return lib


def _striles(lib: dict, name: str, cells: int) -> tuple:
    """A strip or tile array as libtiff reads it: its first `cells` values
    (where those are in the file), padded with zeros where it has
    fewer."""
    v = lib.get(name)
    if v is None and name.endswith("counts") and cells == 1 and \
            lib.get(name.replace("counts", "offsets")):
        # libtiff estimates one strip's byte count: the file less its
        # header and directory, cut at the end of the file
        off = lib[name.replace("counts", "offsets")][0]
        if any(t not in _PIL_UNITS for t, _ in lib["_all"]):
            raise ValueError("libtiff cannot estimate the strip's byte "
                             "count past a tag of an unknown type")
        space = len(lib["_file"]) - 14 - 12 * len(lib["_all"]) - sum(
            _PIL_UNITS.get(t, 0) * c for t, c in lib["_all"]
            if _PIL_UNITS.get(t, 0) * c > 4)
        space = max(space, 0)
        if off + space > len(lib["_file"]):
            space = max(len(lib["_file"]) - off, 0)
        return (space,)
    if v is None:
        raise ValueError(f"TIFF without its {name}")
    if len(v) < cells and ("short_" + name) in lib:
        raise ValueError(f"TIFF {name} past the end of the file")
    return tuple(v[:cells]) + (0,) * (cells - len(v))


def _inflate(raw: bytes, compression: int, need: int) -> bytes:
    """The decompressed bytes of one strip or tile."""
    if compression == 1:
        return raw
    if compression == 5:
        if raw[:1] == b"\x00" and raw[1:2] and raw[1] & 1:
            raise NotImplementedError("TIFF with old-style (least "
                                      "significant bit first) LZW is not "
                                      "decoded by the port")
        if raw[:2] and (raw[0] << 1 | raw[1:2][0] >> 7) != 256:
            # libtiff fails LZW data that does not open with a clear code
            raise ValueError("TIFF LZW data without a clear code first")
        return lzw.decode(raw, 8, True, 1, need)
    if compression == 50000:
        return zstd.tiff_strip(raw, need)
    if compression == 34925:
        try:                            # an xz stream, as libtiff's liblzma
            return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
                raw, max(need, 1))
        except lzma.LZMAError as err:
            raise ValueError(f"corrupt TIFF LZMA data: {err}") from None
    if compression in (8, 32946):
        try:                            # libtiff inflates only what it needs
            return zlib.decompressobj().decompress(raw, max(need, 1))
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
    # the tags of the strips' layout and coding: PIL's, or libtiff's view
    # where libtiff decodes
    lt = tags if compression == 1 else _libtiff_directory(tags)
    photo = _one(tags, "photometric", 0)
    planar = _one(tags, "planar", 1)
    predictor = _one(lt, "predictor", 1)
    if compression in _COMPRESSIONS:
        raise NotImplementedError(f"TIFF with {_COMPRESSIONS[compression]} "
                                  f"compression is not decoded by the port")
    if compression not in (1, 7, 32773) + _CCITT + _PREDICTED:
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
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)                      # as PIL keys unsigned samples
    spp = _one(tags, "samples", 1)
    bits = tags.get("bits", (1,))
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    extra = tags.get("extra", ())
    layout = _layout(tags["big"], photo, bits, extra, fmt)
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
    if photo == 8 and planar == 2:
        raise NotImplementedError("planar LAB TIFF (which PIL reads plane "
                                  "by plane or through libtiff's RGBA "
                                  "reader) is not decoded by the port")
    if layout is None or len(bits) != spp:
        what = {(1,): "unsigned", (2,): "signed",
                (3,): "floating point"}.get(fmt, f"sample format {fmt}")
        raise NotImplementedError(
            f"TIFF with photometric {photo}, bits {bits} ({what}) and extra "
            f"samples {extra} is not decoded by the port")
    kind, depth = layout
    # a predictor applies to LZW and Deflate data only (libtiff): 2 at 8,
    # 16 and 32 bits, 3 (floating point) to samples libtiff reads as float
    if compression in _PREDICTED and not (
            predictor == 1 or (predictor == 2 and depth in (8, 16, 32))
            or (predictor == 3 and depth == 32
                and _one(lt, "sample_format", 1) == 3)):
        raise NotImplementedError(f"TIFF predictor {predictor} at {depth} "
                                  f"bits is not decoded by the port")
    if photo == 6 and kind == "grey" and compression != 1:
        raise ValueError("libtiff reads no YCbCr TIFF of one sample")
    if kind == "ycbcr_rgba" and compression == 1:
        raise NotImplementedError(
            "uncompressed YCbCr TIFF (which PIL reads as RGBX samples) is "
            "not decoded by the port")
    if kind == "ycbcr_rgba" and planar != 1:
        raise NotImplementedError("planar YCbCr TIFF is not decoded by the "
                                  "port")
    if planar == 2:
        kind = _planar_kind(kind, depth, spp, extra, compression,
                            "tile_offsets" in tags)
    if w == 0 or h == 0:
        raise ValueError(f"TIFF of {w}x{h} pixels")
    if kind == "ycbcr_rgba":
        return _orient(_ycbcr_rgba(data, lt, w, h, compression,
                                   predictor), tags)


    if compression == 1:
        px = _raw_pixels(data, tags, w, h, spp, depth, planar)
        return _finish(px, kind, depth, tags, compression, planar)
    if "tile_offsets" in lt:
        tw, th = _one(lt, "tile_width", 0), _one(lt, "tile_length", 0)
        if not tw or not th:
            raise ValueError("TIFF tiles without a width and length")
        names = "tile_offsets", "tile_counts"
        cells = [(x, y, tw, th) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    elif "strip_offsets" in lt:
        rps = min(_one(lt, "rows_per_strip", h), h) or h
        names = "strip_offsets", "strip_counts"
        cells = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
    else:
        raise ValueError("TIFF without strip or tile offsets")
    planes = [list(range(spp))] if planar == 1 else [[s]
                                                     for s in range(spp)]
    offsets, counts = (_striles(lt, n, len(cells) * len(planes))
                       for n in names)

    px = np.zeros((h, w, spp), np.int64 if depth == 32 else np.int32)
    i = 0
    for chans in planes:
        for x, y, cw, ch in cells:
            n = len(chans)
            rowbytes = (cw * n * depth + 7) // 8
            need = ch * rowbytes
            off = offsets[i]
            end = off + counts[i]
            if end == off or end > len(data):
                # libtiff reads a whole strip or tile of the mapped file
                raise ValueError(f"TIFF strip or tile {i} is empty or runs "
                                 f"past the end of the file")
            i += 1
            if compression == 7:
                px[y:y + ch, x:x + cw] = _jpeg_cell(
                    data[off:end], lt, cw, ch, spp,
                    "strip_offsets" in names and y + ch == h)[:h - y, :w - x]
                continue
            if compression in _CCITT:
                px[y:y + ch, x:x + cw, 0] = ccitt.decode(
                    data[off:end], cw, ch, compression,
                    _one(lt, "t4options", 0), fill_order)[:h - y, :w - x]
                continue
            raw = _inflate(data[off:end], compression, need)
            if len(raw) < need:
                raise ValueError(f"TIFF strip or tile {i - 1} holds "
                                 f"{len(raw)} bytes, its rows need {need}")
            rows = np.frombuffer(raw[:need], np.uint8).reshape(ch, rowbytes)
            if predictor == 3 and compression in _PREDICTED:
                s = _fp_acc(rows, n).reshape(ch, cw, n)
            else:
                s = _unpack(rows, cw * n, depth, tags["big"]).reshape(
                    ch, cw, n)
            if predictor == 2 and compression in _PREDICTED:
                s = np.cumsum(s, axis=1) & ((1 << depth) - 1)
            px[y:y + ch, x:x + cw][..., chans] = s[:h - y, :w - x]
    return _finish(px, kind, depth, tags, compression, planar)


def _finish(px, kind, depth, tags, compression, planar) -> np.ndarray:
    if (compression != 1 or planar == 2) and tags["big"] and kind in (
            "int16", "int32", "float"):
        # libtiff hands PIL the samples in native (little-endian) order,
        # which PIL's I;16BS, I;32BS and F;32BF unpackers read as
        # big-endian; PIL reads uncompressed planes with the first letter
        # of these (I or F, native) instead
        px = _swap(px, depth)
    return _orient(_to_rgb(px, kind, depth, tags), tags)


def _raw_pixels(data: bytes, tags: dict, w: int, h: int, spp: int,
                depth: int, planar: int) -> np.ndarray:
    """(h, w, spp) samples of an uncompressed TIFF as PIL's own reader
    lays its tiles: one a strip or tile offset (only the last where one
    strip covers the image), placed left to right and down, wrapping to
    the top (and to the next plane) past the bottom; decoded in file
    order, where a later tile of the same place wins; each row of a tile
    its clipped width's bytes, the tile's full width apart, a tile whose
    rows run past the end of the file truncated (an error)."""
    if "strip_offsets" in tags:
        offsets = tags["strip_offsets"]
        cw, ch, tiled = w, _one(tags, "rows_per_strip", h), False
    elif "tile_offsets" in tags:
        offsets = tags["tile_offsets"]
        cw, ch, tiled = _one(tags, "tile_width"), _one(tags, "tile_length"), \
            True
        if cw is None or ch is None:
            raise ValueError("TIFF tiles without a width and length")
    else:
        raise ValueError("TIFF without strip or tile offsets")
    n = 1 if planar == 2 else spp
    if cw == w and ch == h and planar != 2:
        offsets = offsets[-1:]
    tiles = []
    x = y = layer = 0
    for off in offsets:
        stride = int(cw * spp * depth / 8) if x + cw > w else 0
        if planar == 2:
            stride = int(stride / spp)
        tiles.append((off, (x, y, min(x + cw, w), min(y + ch, h)), stride,
                      layer if planar == 2 else 0))
        x += cw
        if x >= w:
            x, y = 0, y + ch
            if y >= h:
                y, layer = 0, layer + 1
    if planar == 2 and tiles and tiles[-1][3] >= spp:
        raise ValueError("TIFF holds more planes than samples")
    tiles.sort(key=lambda t: t[0])
    # PIL drops a tile when the next in file order has its place and mode
    tiles = [t for i, t in enumerate(tiles)
             if i + 1 == len(tiles) or tiles[i + 1][1:] != t[1:]]
    px = np.zeros((h, w, spp), np.int64 if depth == 32 else np.int32)
    for off, (x0, y0, x1, y1), stride, layer in tiles:
        if x1 <= x0 or y1 <= y0 or off < 0:
            raise ValueError("TIFF tile outside the image")
        rowbytes = ((x1 - x0) * n * depth + 7) // 8
        step = stride or rowbytes
        if off + (y1 - y0 - 1) * step + rowbytes > len(data):
            raise ValueError("TIFF image data truncated")
        at = off + step * np.arange(y1 - y0)[:, None] + np.arange(rowbytes)
        rows = np.frombuffer(data, np.uint8)[at]
        s = _unpack(rows, (x1 - x0) * n, depth, tags["big"]).reshape(
            y1 - y0, x1 - x0, n)
        chans = [layer] if planar == 2 else list(range(spp))
        px[y0:y1, x0:x1][..., chans] = s
    return px


def _orient(rgb: np.ndarray, tags: dict) -> np.ndarray:
    """The image as PIL's exif_transpose leaves it for orientations 2-4
    (mirrored, turned half round, flipped)."""
    o = _one(tags, "orientation", 1)
    if o == 2:
        return rgb[:, ::-1].copy()
    if o == 3:
        return rgb[::-1, ::-1].copy()
    if o == 4:
        return rgb[::-1].copy()
    return rgb


def _unpack(rows: np.ndarray, n: int, depth: int, big: bool) -> np.ndarray:
    """unpack_samples, and 32-bit samples in the file's byte order."""
    if depth != 32:
        return unpack_samples(rows, n, depth, big)
    return rows[:, :4 * n].copy().view(">u4" if big else "<u4").astype(
        np.int64)


def _fp_acc(rows: np.ndarray, stride: int) -> np.ndarray:
    """libtiff's fpAcc: each row's bytes summed with the byte `stride`
    before them, then read as four byte planes, most significant first:
    (h, samples) 32-bit values."""
    acc = np.zeros(rows.shape, np.int64)
    for k in range(stride):
        acc[:, k::stride] = np.cumsum(rows[:, k::stride], axis=1)
    planes = (acc & 0xFF).astype(np.uint8).reshape(len(rows), 4, -1)
    return planes.transpose(0, 2, 1).copy().view(">u4")[..., 0].astype(
        np.int64)


def _swap(px: np.ndarray, depth: int) -> np.ndarray:
    """The samples with their bytes reversed."""
    if depth == 16:
        return (px & 0xFF) << 8 | (px >> 8) & 0xFF
    return px.astype("<u4").byteswap().astype(np.int64)


def _ycc_tables(luma: tuple, ref: tuple) -> tuple:
    """libtiff's TIFFYCbCrToRGBInit: the tables (Y, Cr to red, Cb to blue,
    Cr and Cb to green) indexed by the 8-bit samples, in its float32 and
    16.16 fixed-point arithmetic."""
    f32 = np.float32

    def fix(v):
        return int(float(f32(v) * f32(65536)) + 0.5)

    def clamp(v, lo, hi):
        return lo if v < lo else hi if v > hi else v

    def code2v(c, rb, rw, cr):
        d = f32(rw) - f32(rb)
        v = f32(c - int(rb)) * f32(cr) / (d if d != 0 else f32(1))
        v = f32(-4096) if v < -4096 else f32(4096) if v > 4096 else v
        return int(v) if v == v else -(1 << 31)

    lr, lg, lb = (f32(v) for v in luma)
    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    with np.errstate(all="ignore"):
        d1 = fix(clamp(f1, 0, 2))
        d2 = -fix(clamp(lr * f1 / lg, 0, 2))
        d3 = fix(clamp(f3, 0, 2))
        d4 = -fix(clamp(lb * f3 / lg, 0, 2))
    x = range(-128, 128)
    cr = np.array([code2v(i, f32(ref[4]) - f32(128), f32(ref[5]) - f32(128),
                          127) for i in x], np.int64)
    cb = np.array([code2v(i, f32(ref[2]) - f32(128), f32(ref[3]) - f32(128),
                          127) for i in x], np.int64)
    y = np.array([code2v(i + 128, ref[0], ref[1], 255) for i in x],
                 np.int64)
    return (y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr,
            d4 * cb + 32768)


def _ycc_params(tags: dict) -> tuple:
    """(horizontal, vertical subsampling, tables) as libtiff's RGBA reader
    takes them: a tag of the wrong count is ignored (the defaults are
    2x2, Rec. 601 coefficients and the YCbCr ReferenceBlackWhite); NaN
    coefficients, a green one of 0 and a ReferenceBlackWhite value out
    of range fail."""
    ss = tags.get("ycbcr_subsampling", ())
    hs, vs = ss if len(ss) == 2 else (2, 2)
    if (hs, vs) not in _SUBSAMPLINGS:
        raise ValueError(f"libtiff's RGBA reader converts no YCbCr "
                         f"subsampling {hs}x{vs}")
    luma = tags.get("ycbcr_coefficients", ())
    luma = luma if len(luma) == 3 else _LUMA
    ref = tags.get("reference_black_white", ())
    ref = ref if len(ref) == 6 else _REF_BW
    if any(v != v for v in luma) or luma[1] == 0:
        raise ValueError("TIFF YCbCrCoefficients invalid")
    lo, hi = np.float32(-0x7FFFFFFF + 128), np.float32(0x7FFFFFFF)
    if not all(lo < np.float32(v) < hi for v in ref):
        raise ValueError("TIFF ReferenceBlackWhite invalid")
    return hs, vs, _ycc_tables(luma, ref)


def _lib_inflate(raw: bytes, compression: int, need: int) -> tuple:
    """(bytes, whole) of one strip or tile as libtiff decodes it into a
    buffer: what it decoded before its data ended, and whether that is
    all `need` bytes (libtiff reports an error where it is not, and keeps
    them). Data that fails part way, which libtiff also keeps part of,
    is not decoded by the port."""
    try:
        out = _inflate(raw, compression, need)
    except ValueError as e:
        raise NotImplementedError(
            f"YCbCr TIFF whose compressed data fails part way (libtiff "
            f"converts what it decoded) is not decoded by the port: "
            f"{e}") from None
    return out[:need], len(out) >= need


def _hor_acc(buf: np.ndarray, size: int, rowsize: int) -> None:
    """libtiff's horAcc8 over `size` bytes of buf, rowsize bytes a row,
    stride 3 (nothing where the sizes do not divide, as libtiff)."""
    if rowsize <= 0 or size % rowsize or rowsize % 3:
        return
    rows = buf[:size].reshape(-1, rowsize // 3, 3).astype(np.int64)
    buf[:size] = (np.cumsum(rows, axis=1) & 0xFF).astype(np.uint8).reshape(
        -1)


def _ycbcr_rgba(data: bytes, tags: dict, w: int, h: int,
                compression: int, predictor: int) -> np.ndarray:
    """(h, w, 3) uint8 of a YCbCr TIFF not under JPEG compression, as PIL
    reads it through libtiff's RGBA reader (TIFFRGBAImageGet, a strip or
    a row of tiles a call): each cell's data decoded into a zeroed buffer
    (what data that ends short leaves stays 0), blocks of hs x vs luma
    samples and their Cb and Cr, every pixel converted with its block's
    chroma by libtiff's tables. A strip, or a row's first tile, that
    libtiff cannot read (past the end of the file, or empty) fails the
    file; a row's later tile then converts a buffer of zeros."""
    hs, vs, (ytab, crr, cbb, crg, cbg) = _ycc_params(tags)
    bs = hs * vs + 2
    tiled = "tile_offsets" in tags
    if tiled:
        tw, th = _one(tags, "tile_width", 0), _one(tags, "tile_length", 0)
        if not tw or not th:
            raise ValueError("TIFF tiles without a width and length")
        names = "tile_offsets", "tile_counts"
        rowsize = 3 * tw
    else:
        rps = _one(tags, "rows_per_strip", 0xFFFFFFFF)
        if rps != 0xFFFFFFFF and (2 ** 31 - 1) // (4 * w) < rps:
            raise ValueError("PIL's RGBA buffer for a strip overflows")
        tw, th = w, min(rps, h) or h
        names = "strip_offsets", "strip_counts"
        rowsize = (-(-w // hs) * bs) // vs
    across = -(-w // tw)
    cells = -(-h // th) * across
    offsets, counts = (_striles(tags, n, cells) for n in names)
    blocks = -(-tw // hs) * bs          # the bytes of a row of blocks
    full = -(-th // vs) * blocks
    py, px = np.mgrid[0:th, 0:tw]
    out = np.zeros((h, w, 3), np.uint8)
    for ty in range(0, h, th):
        nrow = min(th, h - ty)
        for tx in range(0, w, tw):
            i = (ty // th) * across + tx // tw
            off, cnt = offsets[i], counts[i]
            # a strip's rows rounded up to whole blocks, as libtiff's
            # scanline size (a block row over vs, rounded down) counts them
            size = full if tiled else min(-(-nrow // vs) * vs * rowsize,
                                          -(-nrow // vs) * blocks)
            buf = np.zeros(full, np.uint8)
            if cnt == 0 or off + cnt > len(data):
                if tx == 0:
                    raise ValueError(f"TIFF strip or tile {i} runs past the "
                                     f"end of the file")
            else:
                raw, whole = _lib_inflate(data[off:off + cnt], compression,
                                          size)
                buf[:len(raw)] = np.frombuffer(raw, np.uint8)
                if whole and predictor == 2 and compression in _PREDICTED:
                    _hor_acc(buf, size, rowsize)
            cw = min(tw, w - tx)
            # a clipped tile's blocks past the image are skipped at each
            # row's end; libtiff's 4x4 routine skips 10 bytes a block
            skip = (tw - cw) // hs * (10 if (hs, vs) == (4, 4) else bs)
            stride = -(-cw // hs) * bs + skip
            yy, xx = py[:nrow, :cw], px[:nrow, :cw]
            at = (yy // vs) * stride + (xx // hs) * bs
            yv = buf[at + (yy % vs) * hs + xx % hs].astype(np.int64)
            cb = buf[at + hs * vs].astype(np.int64)
            cr = buf[at + hs * vs + 1].astype(np.int64)
            y = ytab[yv]
            out[ty:ty + nrow, tx:tx + cw] = np.clip(np.stack([
                y + crr[cr], y + ((cbg[cb] + crg[cr]) >> 16), y + cbb[cb]],
                -1), 0, 255)
    return out


def _jpeg_cell(stream: bytes, tags: dict, cw: int, ch: int, spp: int,
               last_strip: bool = False) -> np.ndarray:
    """(ch, cw, spp) int32 of one JPEG-compressed strip or tile, as
    libtiff hands it to PIL: its JPEGTables read first; under photometric
    YCbCr libjpeg's conversion to RGB (upsampled as libjpeg upsamples),
    under any other the decoded components as they are."""
    planes, _, _ = decode_planes(stream, tags.get("jpeg_tables", b""),
                                 tiff=True)
    if len(planes) != spp:
        raise ValueError(f"TIFF JPEG strip or tile of {len(planes)} "
                         f"components, the image has {spp} samples")
    jh, jw = planes[0][0].shape
    # libtiff's JPEGPreDecode: a larger stream is refused, but for the
    # last strip's rows where its width is the image's
    if jh < ch or jw < cw or jw > cw or (jh > ch and not last_strip):
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
    if kind == "float":
        return float_to_rgb(px[..., 0].astype("<u4").view("<f4"))
    if kind in ("int16", "int32", "uint32"):
        # mode I (signed 32 bits) clipped to 0..255
        v = px[..., 0]
        v = np.where(v >= 1 << (depth - 1), v - (1 << depth), v)
        g = np.clip(v, 0, 255)
        return np.repeat(g[..., None], 3, axis=2).astype(np.uint8)
    if kind == "ycbcr":
        return px.astype(np.uint8)
    if kind == "lab":
        # PIL's LAB unpacker flips the sign bit of TIFF's signed a* and b*
        return lab.to_rgb((px[..., :3] ^ np.array([0, 128, 128])).astype(
            np.uint8))
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
