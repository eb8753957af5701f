"""IPTC/NAA image decoding, equal to PIL's decode.

PIL's IptcImagePlugin has no test of a file's first bytes: its `_open`
reads every file the plugins before it (IMT the last) refuse. It reads
IPTC fields (0x1C, a record of 1-9 or 240, a dataset number, a 2-byte
size, or 0x80 + n and an n-byte size) up to the image data's field (8,
10): (3, 60) gives the layers and component flag (1 layer and no flag
is "L", 3 and 4 layers with the flag "RGB" and "CMYK"), (3, 20) and
(3, 30) the size, (3, 120) the compression (1 raw, 5 JPEG; any other
fails), (3, 65) the band an "RGB" or "CMYK" image's data fills (1 by
default). A field that is not one passes the file to the next plugin, as
does a missing field or no mode; a size byte past 132 fails.

`load` joins the data of the consecutive (8, 10) fields (each as far as
the file holds it) and opens the result as PIL's `Image.open` would:
raw data behind PIL's "P5" header (a PGM of the image's size), JPEG data
through the port's own plugin order (`texture.decode_image`). An "L"
image is that image as it decodes (a colour JPEG stays colour); an "RGB"
or "CMYK" image is `Image.merge` of black bands and the decoded image in
its band (a negative band counts from the last, as Python's indexing
does), which fails unless that image is "L" (a grey PGM or a
one-component JPEG; other grey formats are not followed and raise
NotImplementedError). CMYK becomes RGB as Pillow's cmyk2rgb makes it.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, rawtile
from .jpeg import muldiv255

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
_COMPRESSION = {1: "raw", 5: "jpeg"}


def _i(v) -> int:
    """IptcImagePlugin's _i: the last four bytes, big-endian."""
    return struct.unpack(">I", (bytes(4) + v)[-4:])[0]


class _Syntax(Exception):
    """IptcImageFile.field's SyntaxError."""


def _field(data: bytes, pos: int) -> tuple:
    """IptcImageFile.field at `pos`: (tag or None, size, position after
    the header)."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\x00"):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _RECORDS:
        raise _Syntax("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        raw = data[pos:pos + size - 128]
        pos += len(raw)
        size = _i(raw)
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size, pos


def _fields(data: bytes) -> tuple:
    """IptcImageFile._open, statement for statement: (w, h, mode, band,
    compression, offset of the first (8, 10) field or None)."""
    pos, info = 0, {}
    while True:
        offset = pos
        tag, size, pos = _field(data, pos)
        if not tag or tag == (8, 10):
            break
        value = None
        if size:
            value = data[pos:pos + size]
            pos += len(value)
        if tag in info:
            old = info[tag]
            info[tag] = old + [value] if isinstance(old, list) else \
                [old, value]
        else:
            info[tag] = value
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    w, h = _i(info[(3, 20)]), _i(info[(3, 30)])
    compression = _COMPRESSION.get(_i(info[(3, 120)]))
    if compression is None:
        raise ValueError("Unknown IPTC image compression")
    if not mode or w <= 0 or h <= 0:
        raise rawtile.Next("IPTC image PIL does not open")
    return w, h, mode, band, compression, offset if tag == (8, 10) else None


def _open(data: bytes) -> tuple:
    """_fields where PIL's IPTC plugin opens the file; Next where it
    passes the file on (its errors PIL's ImageFile turns into that),
    ValueError where it fails (OSError in PIL)."""
    try:
        return _fields(data)
    except (_Syntax, KeyError, IndexError, TypeError, struct.error) as e:
        raise rawtile.Next(f"not an IPTC file ({e!r})") from None


def accept(data: bytes) -> bool:
    """Whether PIL's IPTC plugin takes the file (opens it, or fails)."""
    return rawtile.takes(_open, data)


def _load(data: bytes, pos: int) -> bytes:
    """The data of the consecutive (8, 10) fields from `pos`."""
    out = []
    while True:
        try:
            tag, size, pos = _field(data, pos)
        except (_Syntax, IndexError, struct.error) as e:
            raise ValueError(f"IPTC image data field PIL fails on: "
                             f"{e!r}") from None
        if tag != (8, 10):
            return b"".join(out)
        chunk = data[pos:pos + size]
        pos += len(chunk)
        out.append(chunk)


def _grey(inner: bytes) -> np.ndarray:
    """The (h, w) samples of a nested image PIL opens as mode "L"."""
    from . import pnm, texture
    from .jpeg import decode_planes
    fmt = texture.image_format(inner)
    if fmt == "JPEG":
        planes = decode_planes(inner)[0]
        if len(planes) != 1:
            raise ValueError("IPTC band image of more than one band (PIL: "
                             "mode mismatch)")
        return planes[0][0]
    if fmt == "PPM" and pnm.magic(inner) in (b"P2", b"P5"):
        return pnm.decode_pnm(inner)[..., 0]
    if fmt == "PPM" or fmt == "an unknown format":
        texture.decode_image(inner, "IPTC image data")
        raise ValueError("IPTC band image of more than one band (PIL: "
                         "mode mismatch)")
    raise NotImplementedError(f"IPTC band image data in {fmt} is not "
                              f"decoded by the port (PGM and JPEG only)")


def decode_iptc(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an IPTC/NAA image, PIL's `convert("RGB")` of it
    byte for byte."""
    from . import texture
    w, h, mode, band, compression, offset = _open(data)
    bomb.check("IPTC", w, h)
    if offset is None:
        raise ValueError("IPTC file without image data (PIL: cannot load "
                         "this image)")
    inner = _load(data, offset)
    if compression == "raw":
        inner = b"P5\n%d %d\n255\n" % (w, h) + inner
    if band is None:
        return texture.decode_image(inner, "IPTC image data")
    grey = _grey(inner)
    n = len(mode)
    if not -n <= band < n:
        raise ValueError(f"IPTC band {band + 1} of a {mode} image")
    bands = np.zeros((n,) + grey.shape, np.int32)
    bands[band] = grey
    if mode == "RGB":
        return np.moveaxis(bands, 0, -1).astype(np.uint8)
    return np.stack([muldiv255(255 - bands[c], 255 - bands[3])
                     for c in range(3)], -1).astype(np.uint8)
