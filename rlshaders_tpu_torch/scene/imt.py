"""IMT (IM Tools) decoding, equal to PIL's decode, and the checks of the
IPTC/NAA plugin PIL tries after it.

PIL's ImtImagePlugin has no test of a file's first bytes: its `_open`
runs on every file the plugins before it refuse. It needs a newline in
the first 100 bytes, then reads "key value" lines (a line of one
character, or of more than 100, or one the pattern `[a-z]* [^ \\r\\n]*`
does not match, ends the header; a "*" starts a comment) until a 0x0C
byte, after which the rows start: "width" and "height" give the size
(an integer PIL's int() refuses fails the file), "pixel n8" the mode
"L", the only one it opens. Without the mode or a size it passes the
file on; with them and no 0x0C PIL opens it and cannot load it.

PIL's IptcImagePlugin, next in its order, also reads every file that
comes to it: IPTC fields (0x1C, a record and a dataset number, a size)
up to the image data's field (8, 10). `iptc_opens` follows it; the port
does not decode IPTC images yet.
"""
from __future__ import annotations

import re
import struct

import numpy as np

from . import bomb, rawtile

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _header(data: bytes) -> tuple:
    """(w, h, offset of the rows or None); Next where PIL tries the next
    plugin, ValueError where its int() fails."""
    buf = data[:100]
    pos = len(buf)
    if b"\n" not in buf:
        raise rawtile.Next("not an IMT file")
    w = h = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buf:
            s, buf = buf[:1], buf[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buf)
            break
        if b"\n" not in buf:
            more = data[pos:pos + 100]
            buf += more
            pos += len(more)
        lines = buf.split(b"\n")
        s += lines.pop(0)
        buf = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
            size = w, h
        elif k == b"height":
            h = int(v)
            size = w, h
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise rawtile.Next("IMT header PIL does not open")
    return size[0], size[1], offset


def accept(data: bytes) -> bool:
    """Whether PIL's IMT plugin takes the file (opens it, or fails in
    its header)."""
    return rawtile.takes(_header, data)


def decode_imt(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an IMT file, PIL's `convert("RGB")` of it byte
    for byte."""
    w, h, offset = _header(data)
    bomb.check("IMT", w, h)
    if offset is None:
        raise ValueError("IMT header without the 0x0C that starts its data "
                         "(PIL cannot load the image)")
    return rawtile.grey(rawtile.rows(data, offset, h, w, fmt="IMT"))


_IPTC_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _i(v) -> int:
    """IptcImagePlugin's _i: the last four bytes, big-endian."""
    return struct.unpack(">I", (bytes(4) + v)[-4:])[0]


def _iptc_fields(data: bytes) -> tuple:
    """IptcImageFile._open, statement for statement: (w, h)."""
    pos, info = 0, {}
    while True:
        s = data[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\x00"):
            break
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in _IPTC_RECORDS:
            raise rawtile.Next("not an IPTC file")
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
        if tag == (8, 10):
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
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:
            band = info[(3, 65)][0] - 1     # fails where not bytes
            del band
    w, h = _i(info[(3, 20)]), _i(info[(3, 30)])
    if _i(info[(3, 120)]) not in (1, 5):
        raise ValueError("Unknown IPTC image compression")
    if not mode or w <= 0 or h <= 0:
        raise rawtile.Next("IPTC image PIL does not open")
    return w, h


def _iptc_open(data: bytes) -> tuple:
    """(w, h) where PIL's IPTC plugin opens the file; Next where it
    passes the file on (its errors PIL's ImageFile turns into that),
    ValueError where it fails (OSError in PIL)."""
    try:
        return _iptc_fields(data)
    except (KeyError, IndexError, TypeError, struct.error) as e:
        raise rawtile.Next(f"not an IPTC file ({e!r})") from None


def iptc_accept(data: bytes) -> bool:
    """Whether PIL's IPTC plugin takes the file (opens it, or fails)."""
    return rawtile.takes(_iptc_open, data)


def refuse_iptc(data: bytes) -> np.ndarray:
    """An IPTC file: ValueError where PIL fails it, else the port's
    refusal (IPTC is not decoded yet)."""
    bomb.check("IPTC", *_iptc_open(data))
    raise NotImplementedError("IPTC images are not decoded by the port")
