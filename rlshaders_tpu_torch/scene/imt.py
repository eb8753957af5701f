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

PIL's IptcImagePlugin, next in its order, is scene/iptc.py.
"""
from __future__ import annotations

import re

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
