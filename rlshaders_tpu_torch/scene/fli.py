"""Autodesk FLI/FLC animation decoding (the first frame), equal to PIL's
decode.

PIL's FliImagePlugin takes a file of at least 16 bytes whose magic at
byte 4 is 0xAF11 (FLI) or 0xAF12 (FLC) and whose flags at byte 14 are 0
or 3; its `_open` also needs zeros at bytes 20-21, 42-79 and 88-127 and
at least one frame, else PIL tries the next plugin. The size is at bytes
8 and 10, the mode "P". The palette is the grey ramp unless the first
frame chunk after the header (past a 0xF100 prefix chunk) holds a colour
chunk among its first sub-chunks: chunk 11 (FLI COLOR, 6-bit values
shifted left by 2, kept to 8 bits as Pillow's o8 keeps them) or chunk 4
(FLC COLOR_256), read as packets of (skip, count) from entry 0. A header
or palette that ends early, or a palette past 256 entries, passes the
file on.

The first frame is read from byte 128 (where PIL's `seek(0)` points,
the prefix chunk included) and decoded as Pillow's `FliDecode.c` decodes
it, on the frame's own bytes (its size field is how many PIL reads,
allowing one pad byte): a frame chunk (0xF1FA) of sub-chunks 4 and 11
(passed over), 7 (FLC word-delta lines, with skip and last-byte flag
words), 12 (FLI byte-delta lines), 13 (black), 15 (byte runs), 16 (a
copy) and 18 (a stamp, skipped), each checked against the frame's end
as Pillow checks it; any other chunk, a chunk size of 0, or past the
frame, and a line that does not finish fail. The image starts black
and is converted to RGB through the palette. Each rule was settled by
hand-built files held to PIL (the tests' sweeps and fuzz).
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, rawtile

MAGICS = (0xAF11, 0xAF12)


def _u16(d: bytes, o: int) -> int:
    return struct.unpack_from("<H", d, o)[0]


def _u32(d: bytes, o: int) -> int:
    return struct.unpack_from("<I", d, o)[0]


def _i32(d: bytes, o: int) -> int:
    return struct.unpack_from("<i", d, o)[0]


def _accept(data: bytes) -> bool:
    return (len(data) >= 16 and _u16(data, 4) in MAGICS
            and _u16(data, 14) in (0, 3))


def _palette(data: bytes, pos: int, shift: int) -> np.ndarray:
    """FliImageFile._palette from `pos`: (256, 3) uint8 over the grey
    ramp."""
    pal = [(a, a, a) for a in range(256)]
    i = 0
    count = _u16(data[pos:pos + 2], 0)
    pos += 2
    for _ in range(count):
        s = data[pos:pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            pal[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1
    return np.array(pal, np.int64).astype(np.uint8)


def _open(data: bytes) -> tuple:
    """FliImageFile._open: (w, h, palette, frame size)."""
    s = data[:128]
    if not (_accept(s) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise rawtile.Next("not an FLI/FLC file")
    if _u16(s, 6) == 0:
        raise rawtile.Next("FLI/FLC file of no frames")
    w, h = _u16(s, 8), _u16(s, 10)
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    pos = 128
    s = data[pos:pos + 16]
    if _u16(s, 4) == 0xF100:
        pos = 128 + _u32(s, 0)
        s = data[pos:pos + 16]
    pos += len(s)
    if _u16(s, 4) == 0xF1FA:
        size = None
        for _ in range(_u16(s, 6)):
            if size is not None:
                pos = max(pos + size - 6, 0)
            s = data[pos:pos + 6]
            pos += len(s)
            kind = _u16(s, 4)
            if kind in (4, 11):
                pal = _palette(data, pos, 2 if kind == 11 else 0)
                break
            size = _u32(s, 0)
            if not size:
                break
    frame = data[128:132]
    if not frame:
        raise rawtile.Next("FLI/FLC file without a frame size")
    return w, h, pal, _u32(frame, 0)


def _header(data: bytes) -> tuple:
    try:
        return _open(data)
    except (IndexError, struct.error):
        raise rawtile.Next("FLI/FLC header PIL passes on") from None


def accept(data: bytes) -> bool:
    return _accept(data) and rawtile.takes(_header, data)


def _frame(buf: bytes, w: int, h: int) -> np.ndarray:
    """ImagingFliDecode over the frame's bytes: (h, w) uint8 indices."""
    im = np.zeros((h, w), np.uint8)
    n = len(buf)
    if n < 8:
        raise ValueError("FLI frame overruns its data")
    if _u16(buf, 4) != 0xF1FA:
        raise ValueError("FLI frame of an unknown chunk type")
    chunks = _u16(buf, 6)
    ptr, left = 16, n - 16
    for _ in range(chunks):
        if left < 10:
            raise ValueError("FLI sub-chunk overruns the frame")
        end = ptr + left               # data past this is out of bounds

        def oob(at: int, k: int) -> None:
            if at + k > end:
                raise ValueError("FLI chunk data overruns the frame")

        d = ptr + 6
        kind = _u16(buf, ptr + 4)
        if kind == 7:                                   # FLC SS2 (words)
            lines = _u16(buf, d)
            d += 2
            line = y = 0
            while line < lines and y < h:
                oob(d, 2)
                packets = _u16(buf, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise ValueError("FLI line skip past the image")
                    else:
                        im[y, w - 1] = packets & 0xFF
                    oob(d, 2)
                    packets = _u16(buf, d)
                    d += 2
                x = p = 0
                while p < packets:
                    oob(d, 2)
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        oob(d, 4)
                        i = 256 - buf[d + 1]
                        if x + 2 * i > w:
                            break
                        im[y, x:x + 2 * i] = np.tile(
                            np.frombuffer(buf, np.uint8, 2, d + 2), i)
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * buf[d + 1]
                        if x + i > w:
                            break
                        oob(d, 2 + i)
                        im[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                line += 1
                y += 1
            if line < lines:
                raise ValueError("FLI word-delta lines overrun")
        elif kind == 12:                                # FLI LC (bytes)
            y = _u16(buf, d)
            ymax = y + _u16(buf, d + 2)
            d += 4
            while y < ymax and y < h:
                oob(d, 1)
                packets = buf[d]
                d += 1
                x = p = 0
                while p < packets:
                    oob(d, 2)
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        i = 256 - buf[d + 1]
                        if x + i > w:
                            break
                        oob(d, 3)
                        im[y, x:x + i] = buf[d + 2]
                        d += 3
                    else:
                        i = buf[d + 1]
                        if x + i > w:
                            break
                        oob(d, 2 + i)
                        im[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += 2 + i
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise ValueError("FLI byte-delta lines overrun")
        elif kind == 13:                                # BLACK
            im[:] = 0
        elif kind == 15:                                # BRUN
            for y in range(h):
                d += 1
                x = 0
                while x < w:
                    oob(d, 2)
                    if buf[d] & 0x80:
                        i = 256 - buf[d]
                        if x + i > w:
                            break
                        oob(d, i + 1)
                        im[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 1)
                        d += i + 1
                    else:
                        i = buf[d]
                        if x + i > w:
                            break
                        im[y, x:x + i] = buf[d + 1]
                        d += 2
                    x += i
                if x != w:
                    raise ValueError("FLI byte-run line does not finish")
        elif kind == 16:                                # COPY
            if d + w * h > end:
                raise ValueError("FLI copy chunk overruns the frame")
            im[:] = np.frombuffer(buf, np.uint8, w * h, d).reshape(h, w)
        elif kind not in (4, 11, 18):
            raise ValueError("FLI frame of an unknown sub-chunk type")
        advance = _i32(buf, ptr)
        if advance == 0:
            raise ValueError("FLI sub-chunk of size 0")
        if advance < 0 or advance > left:
            raise ValueError("FLI sub-chunk past the frame")
        ptr += advance
        left -= advance
    return im


def decode_fli(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an FLI/FLC file's first frame, PIL's
    `convert("RGB")` of it byte for byte."""
    w, h, pal, size = _header(data)
    bomb.check("FLI", w, h)
    buf = data[128:128 + size]
    signed = struct.unpack("<i", struct.pack("<I", size))[0]
    if not buf or len(buf) < 4 or len(buf) + len(buf) % 2 < signed:
        raise ValueError("FLI frame truncated (PIL: image file is "
                         "truncated)")
    return pal[_frame(buf, w, h)]
