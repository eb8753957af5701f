"""JPEG 2000 files (J2K codestreams and JP2 boxes), equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`.
PIL 12.1 opens a file that starts with a J2K codestream (SOC, SIZ) or the
JP2 signature box, takes its size and mode from its own reading of the
header, has OpenJPEG decode it tile by tile, and unpacks each tile into
that mode (Pillow's Jpeg2KDecode.c). `decode_jpeg2000` returns the
bytes of `convert("RGB")` of that image:

* A J2K codestream's size is SIZ's image area and its mode comes from its
  component count: L (or I;16 past 8 bits), LA, RGB, RGBA.
* A JP2 file's come from its header box as PIL's `_parse_jp2_header`
  reads it: `ihdr` gives the size and L, I;16, LA, RGB or RGBA, a `colr`
  box with enumerated space 12 makes four components CMYK, and a `pclr`
  box (with its `cmap`) makes L and LA into P and PA, whose palette PIL
  builds colour by colour with `ImagePalette.getcolor`, which keeps one
  index for a colour listed twice (so later entries move down). OpenJPEG
  reads the boxes too, with its own checks (`_jp2_boxes`), and takes the
  codestream from the `jp2c` box to the end of the file; the colour space
  is the `colr` box's enumerated one (sRGB, greyscale, sYCC, eYCC, CMYK),
  else (no box, an ICC profile, another space) one Pillow sets by the
  component count: greyscale for one or two, sRGB for three or four.
  PIL's size must be the codestream's.
* Pillow picks its unpacker by mode, colour space and component count
  (`_UNPACKERS`; none for eYCC, or for P without sRGB) and shifts each
  component to 8 bits (16 for I;16) with its rounding offset, and turns
  sYCC into RGB with its own YCbCr conversion (im.py); `convert("RGB")`
  then drops alpha, clamps I;16 to 255, looks P and PA up in the palette
  (black past its end) and turns CMYK into RGB as Pillow's cmyk2rgb.

Palettes of other than three or four columns raise NotImplementedError
naming them, as does what
j2k.py refuses; malformed data, and an image past PIL's decompression
bomb limit, raise ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb
from .im import ycbcr_to_rgb
from .j2k import decode_codestream, read_header
from .jpeg import muldiv255

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# OpenJPEG's colour spaces, from the colr box's enumerated space
GRAY, SRGB, SYCC, EYCC, CMYK, UNKNOWN = ("gray", "srgb", "sycc", "eycc",
                                         "cmyk", "unknown")
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}
# Pillow's unpackers: (mode, colour space, components) -> what they read
# ("l": component 0 as grey, "la": 0 and 1, "rgb": 0-2, "rgba": 0-3,
# "i": component 0 as 16 bits, "ycc": sYCC)
_UNPACKERS = {
    ("L", GRAY, 1): "l", ("P", SRGB, 1): "l", ("PA", SRGB, 2): "la",
    ("I;16", GRAY, 1): "i", ("LA", GRAY, 2): "la",
    ("RGB", GRAY, 1): "l", ("RGB", GRAY, 2): "l", ("RGB", SRGB, 3): "rgb",
    ("RGB", SYCC, 3): "ycc", ("RGB", SRGB, 4): "rgb", ("RGB", SYCC, 4): "ycc",
    ("RGBA", GRAY, 1): "l", ("RGBA", GRAY, 2): "la",
    ("RGBA", SRGB, 3): "rgb", ("RGBA", SYCC, 3): "ycc",
    ("RGBA", SRGB, 4): "rgba", ("RGBA", SYCC, 4): "ycc",
    ("CMYK", CMYK, 4): "rgba",
}


def accept(data: bytes) -> bool:
    """PIL's test of a JPEG 2000 file's first bytes."""
    return data.startswith((J2K_MAGIC, JP2_MAGIC))


class _Box:
    """PIL's BoxReader over bytes: a box's fields, and the boxes in it."""

    def __init__(self, data: bytes, bounded: bool):
        self.data, self.pos, self.bounded = data, 0, bounded
        self.left = -1                  # bytes left in the current box

    def _can(self, n: int) -> bool:
        if self.bounded and self.pos + n > len(self.data):
            return False
        return n <= self.left if self.left >= 0 else True

    def take(self, n: int) -> bytes:
        if not self._can(n):
            raise ValueError("JP2 header box ends early")
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise ValueError("JP2 file ends in its header")
        self.pos += n
        if self.left > 0:
            self.left -= n
        return out

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))

    def more(self) -> bool:
        return not self.bounded or self.pos + self.left < len(self.data)

    def next(self) -> bytes:
        if self.left > 0:
            self.pos += self.left
        self.left = -1
        lbox, tbox = self.fields("I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields("Q")[0], 16
        if lbox < hlen or not self._can(lbox - hlen):
            raise ValueError("JP2 box of an invalid length")
        self.left = lbox - hlen
        return tbox

    def inner(self) -> "_Box":
        return _Box(self.take(self.left), True)


def _getcolor(colors: dict, palette: list, colour: tuple) -> None:
    """ImagePalette.getcolor: a colour already listed keeps its index."""
    if colour not in colors:
        if len(colors) >= 256:
            raise ValueError("JP2 palette of more than 256 colours")
        colors[colour] = len(palette)
        palette.append(colour)


def pil_header(data: bytes) -> tuple:
    """((width, height), mode, palette) as PIL's Jpeg2KImagePlugin reads
    them, palette a list of RGB or RGBA tuples or None."""
    if data.startswith(J2K_MAGIC):
        if len(data) < 6:
            raise ValueError("J2K file ends in its SIZ marker")
        lsiz = struct.unpack_from(">H", data, 4)[0]
        siz = data[4:4 + lsiz]
        if len(siz) < 40:
            raise ValueError("J2K SIZ marker ends early")
        _, _, xsiz, ysiz, xo, yo, _, _, _, _, csiz = struct.unpack_from(
            ">HHIIIIIIIIH", siz)
        if csiz == 1:
            if len(siz) < 39:
                raise ValueError("J2K SIZ marker ends early")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = ("LA", "RGB", "RGBA")[csiz - 2]
        else:
            raise ValueError(f"J2K image of {csiz} components")
        return (xsiz - xo, ysiz - yo), mode, None
    reader = _Box(data[12:], False)
    header = None
    while reader.more():
        tbox = reader.next()
        if tbox == b"jp2h":
            header = reader.inner()
            break
        if tbox == b"ftyp":
            reader.fields("4s")
    size = mode = nc = None
    palette = None
    while header.more():
        tbox = header.next()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields("IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = ("L", "LA", "RGB", "RGBA")[nc - 1]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields("BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields("HB")
            depths = header.fields("B" * npc)
            if max(depths, default=0) <= 8:
                if npc not in (3, 4):
                    raise NotImplementedError(
                        f"JPEG 2000 palettes of {npc} columns are not "
                        f"decoded by the port")
                colors, palette = {}, []
                for _ in range(ne):
                    colour = header.fields("B" * npc)
                    _getcolor(colors, palette, colour)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.inner()
            while res.more():
                if res.next() == b"resc":
                    res.fields("HHHHBB")
                    break
    if size is None or mode is None:
        raise ValueError("Malformed JP2 header")
    return size, mode, palette


def _jp2_boxes(data: bytes) -> tuple:
    """(where the codestream starts, the colour space) as OpenJPEG's JP2
    reader finds them: the signature, then ftyp, then boxes up to jp2c,
    with the header box's ihdr and colour boxes checked as it checks
    them."""
    pos, state, space = 0, set(), None
    while len(data) - pos >= 8:
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if len(data) - pos < 16:
                break
            hi, length = struct.unpack_from(">II", data, pos + 8)
            if hi:
                raise ValueError("JP2 box larger than 4 GiB")
            head = 16
        elif length == 0:
            length = len(data) - pos
        if kind == b"jp2c":
            if "jp2h" not in state:
                raise ValueError("JP2 codestream box before the header box")
            return pos + head, space
        if length < head:
            raise ValueError("JP2 box of an invalid length")
        body = data[pos + head:pos + length]
        if kind in (b"jP  ", b"ftyp", b"jp2h"):
            if length - head > len(data) - pos - head:
                raise ValueError("JP2 box runs past the file")
            if kind == b"jP  ":
                if state or body != b"\x0d\x0a\x87\x0a":
                    raise ValueError("JP2 signature box is not the first")
            elif kind == b"ftyp":
                if state != {"jP  "}:
                    raise ValueError("JP2 file-type box is not the second")
                if len(body) < 8 or len(body) % 4:
                    raise ValueError("JP2 file-type box of a wrong size")
            else:
                if "jp2h" in state:
                    raise ValueError("JP2 file with two header boxes")
                if not state >= {"jP  ", "ftyp"}:
                    raise ValueError("JP2 header box before the file type")
                space = _jp2h(body)
            state.add(kind.decode("latin-1"))
        elif kind in (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef"):
            if "jp2h" in state:
                raise NotImplementedError(
                    f"JP2 {kind.decode('latin-1')} box outside the header "
                    f"box is not decoded by the port")
        else:
            if not state >= {"jP  ", "ftyp"}:
                raise ValueError("JP2 file without its signature and "
                                 "file-type boxes")
            if length - head > len(data) - pos - head:
                raise ValueError("JP2 box runs past the file")
        pos += length
    raise ValueError("JP2 file without a codestream box")


def _jp2h(body: bytes) -> str:
    """The colour space of a JP2 header box, read as OpenJPEG reads it."""
    pos, ihdr, colr, pclr, cmap, cdef, enumcs = 0, False, False, None, \
        False, False, 0
    while pos < len(body):
        if len(body) - pos < 8:
            raise ValueError("JP2 header box ends in a box header")
        length, kind = struct.unpack_from(">I4s", body, pos)
        head = 8
        if length == 1:
            if len(body) - pos < 16:
                raise ValueError("JP2 header box ends in a box header")
            hi, length = struct.unpack_from(">II", body, pos + 8)
            if hi:
                raise ValueError("JP2 box larger than 4 GiB")
            head = 16
        if length == 0 or length < head or length > len(body) - pos:
            raise ValueError("JP2 box in the header box of an invalid length")
        box = body[pos + head:pos + length]
        if kind == b"ihdr" and not ihdr:
            if len(box) != 14:
                raise ValueError("JP2 ihdr box of a wrong size")
            h, w, nc = struct.unpack_from(">IIH", box)
            if not h or not w or not nc or nc > 16384:
                raise ValueError("JP2 ihdr box of a zero size")
            ihdr = True
        elif kind == b"colr" and not colr:
            if len(box) < 3:
                raise ValueError("JP2 colr box of a wrong size")
            meth = box[0]
            if meth == 1:
                if len(box) < 7:
                    raise ValueError("JP2 colr box of a wrong size")
                enumcs = struct.unpack_from(">I", box, 3)[0]
                colr = True
            elif meth == 2:
                colr = True
        elif kind == b"pclr":
            if pclr is not None:
                raise ValueError("JP2 file with two palettes")
            pclr = _pclr(box)
        elif kind == b"cmap":
            if pclr is None:
                raise ValueError("JP2 cmap box before its palette")
            if cmap:
                raise ValueError("JP2 file with two cmap boxes")
            if len(box) < 4 * pclr:
                raise ValueError("JP2 cmap box ends early")
            cmap = True
        elif kind == b"cdef":
            if cdef or len(box) < 2:
                raise ValueError("JP2 cdef box of a wrong size")
            n = struct.unpack_from(">H", box)[0]
            if not n or len(box) < 2 + 6 * n:
                raise ValueError("JP2 cdef box of a wrong size")
            cdef = True
        pos += length
    if not ihdr:
        raise ValueError("JP2 header box without ihdr")
    return _ENUMCS.get(enumcs, UNKNOWN)


def _pclr(box: bytes) -> int:
    """A palette box's column count, after OpenJPEG's checks."""
    if len(box) < 3:
        raise ValueError("JP2 pclr box of a wrong size")
    ne, npc = struct.unpack_from(">HB", box)
    if not ne or ne > 1024 or not npc or len(box) < 3 + npc:
        raise ValueError("JP2 pclr box of a wrong size")
    need = 3 + npc + ne * sum(min((((b & 0x7F) + 1) + 7) >> 3, 4)
                              for b in box[3:3 + npc])
    if len(box) < need:
        raise ValueError("JP2 pclr box ends early")
    return npc


def _to8(plane: np.ndarray, prec: int, sgnd: bool, bits: int) -> np.ndarray:
    """Pillow's j2ku_shift of a component to `bits` bits, with its
    offsets, as the unpackers store it."""
    word = plane.astype(np.int64) & ((1 << (8 * ((prec + 7) >> 3))) - 1)
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        v = (offset + word) >> -shift
    else:
        v = (offset + word) << shift
    return v & ((1 << bits) - 1)


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a J2K or JP2 file, PIL's `convert("RGB")` of it
    byte for byte."""
    if not accept(data):
        raise ValueError("not a JPEG 2000 file")
    (w, h), mode, palette = pil_header(data)
    bomb.check("JPEG 2000", w, h)
    if data.startswith(JP2_MAGIC):
        start, space = _jp2_boxes(data)
    else:
        start, space = 0, UNKNOWN
    stream = data[start:]
    siz = read_header(stream).siz
    n = len(siz.comps)
    if space == UNKNOWN:
        space = GRAY if n <= 2 else SRGB
    if not 1 <= n <= 4:
        raise ValueError(f"JPEG 2000 image of {n} components")
    kind = _UNPACKERS.get((mode, space, n))
    if kind is None:
        raise ValueError(f"JPEG 2000 {mode} image of {n} components in "
                         f"colour space {space}: no Pillow unpacker")
    if w <= 0 or h <= 0:
        raise ValueError("JPEG 2000 image of zero size")
    if (w, h) != (siz.x1 - siz.x0, siz.y1 - siz.y0):
        raise ValueError("JPEG 2000 header and codestream sizes differ")
    img = decode_codestream(stream)
    comps = siz.comps
    bits = 16 if kind == "i" else 8

    def chan(c: int) -> np.ndarray:
        return _to8(img.planes[c], comps[c].prec, comps[c].sgnd, bits)

    if kind == "i":
        grey = np.minimum(chan(0), 255)
        rgb = np.stack([grey] * 3, -1)
    elif kind in ("l", "la"):
        rgb = np.stack([chan(0)] * 3, -1)
    elif kind == "ycc":
        # Pillow's sYCC unpackers: the samples to 8 bits as for sRGB, then
        # its own YCbCr to RGB (an alpha component is only copied)
        rgb = ycbcr_to_rgb(np.stack([chan(c) for c in range(3)], -1))
    else:
        rgb = np.stack([chan(c) for c in range(3)], -1)
        if mode == "CMYK":
            nk = 255 - chan(3)
            rgb = np.clip(nk[..., None] - muldiv255(rgb, nk[..., None]), 0,
                          255)
    if mode in ("P", "PA"):
        lut = np.zeros((256, 3), np.int64)
        for i, colour in enumerate(palette):
            lut[i] = colour[:3]
        rgb = lut[rgb[..., 0]]
    return rgb.astype(np.uint8)
