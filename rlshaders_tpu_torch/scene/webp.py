"""WebP decoding (the RIFF container), equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`.
PIL 12.1 takes a file as WebP where it starts "RIFF", then 4 bytes, then
"WEBP" and a first chunk "VP8 ", "VP8L" or "VP8X", and reads it through
libwebp's demuxer and animation decoder, which give it the first frame's
RGBA without premultiplying: its RGB is the image's own. `decode_webp`
returns those bytes, checking the container as the demuxer does:

* the RIFF size is at least 8 and the file holds all of it (bytes past
  it are ignored); every chunk the demuxer reads has a size that, padded
  to even, fits in the RIFF, and no 1-7 bytes follow it in the RIFF;
* a simple file is a "VP8 " (lossy, vp8.py) or "VP8L" (lossless,
  vp8l.py) chunk; the demuxer reads one ALPH chunk after it (dropped)
  and the header of the next chunk, and stops there;
* "VP8X" (at least 10 bytes: flags, 24-bit canvas width and height less
  one; no flag bits outside alpha, animation, ICC, EXIF and XMP) is read
  chunk by chunk (`_demux`, libwebp's ParseVP8XChunks): ICCP, EXIF, XMP
  and unknown chunks are skipped (`convert("RGB")` applies no profile).
  A still file holds one image: an ALPH chunk (decoded where the alpha
  flag is set, as libwebp fails a file on broken alpha, then dropped)
  then at once a VP8 chunk, or a VP8L chunk, as large as the canvas. An
  animated file (the animation flag) holds ANIM and then ANMF chunks,
  each a frame (its offset, twice the stored one, and ALPH and VP8, or
  VP8L, chunks); the demuxer checks every frame, its bitstream's header
  and its place inside the canvas, before the first is drawn. That frame
  is a key frame, drawn without blending into a zero (transparent black)
  canvas, its ALPH chunk decoded whatever the flags; ANIM's background
  colour is not painted and later frames are not drawn.

The decoders get the image chunk with its pad byte, as libwebp's do: a
stream of odd length may read its pad byte. Malformed data, and an image
past PIL's decompression bomb limit, raise ValueError.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import bomb
from .vp8 import START_CODE, decode_vp8
from .vp8l import decode_alpha, decode_vp8l
from .vp8l import header as _vp8l_header

KINDS = (b"VP8 ", b"VP8L", b"VP8X")
ANIMATION, ALPHA_FLAG = 0x02, 0x10
VALID_FLAGS = 0x3E             # alpha, animation, ICC, EXIF, XMP
MAX_PAYLOAD = 0xFFFFFFF6
MAX_AREA = 1 << 32             # libwebp's MAX_IMAGE_AREA


def accept(data: bytes) -> bool:
    """PIL's test of a WebP file's first 16 bytes."""
    return (data.startswith(b"RIFF") and data[8:12] == b"WEBP"
            and data[12:16] in KINDS)


def _chunk(data: bytes, pos: int) -> tuple:
    """(fourcc, payload start, payload size) of the chunk at pos, whose
    size padded to even must fit in the RIFF (data's end)."""
    if len(data) - pos < 8:
        raise ValueError("WebP chunk header runs past the RIFF")
    fourcc = data[pos:pos + 4]
    size = int.from_bytes(data[pos + 4:pos + 8], "little")
    if size > MAX_PAYLOAD or size + (size & 1) > len(data) - pos - 8:
        raise ValueError(f"WebP {fourcc!r} chunk runs past the RIFF")
    return fourcc, pos + 8, size


def _after(at: int, size: int) -> int:
    return at + size + (size & 1)


def _image(data: bytes, fourcc: bytes, at: int, size: int) -> tuple:
    """(fourcc, the bitstream, its chunk's size) of an image chunk. The
    bitstream runs on over the chunk's pad byte: libwebp hands its
    decoders the padded chunk, so a stream may read that byte."""
    return fourcc, data[at:at + size + (size & 1)], size


def _size(fourcc: bytes, payload: bytes, size: int) -> tuple:
    """(width, height) of an image chunk, checked as libwebp's feature
    reader checks it."""
    if fourcc == b"VP8L":
        return _vp8l_header(payload)
    if len(payload) < 10:
        raise ValueError("VP8 frame header ends early")
    bits = payload[0] | payload[1] << 8 | payload[2] << 16
    if payload[3:6] != START_CODE or bits & 1 or (bits >> 1) & 7 > 3 \
            or not (bits >> 4) & 1 or bits >> 5 >= size:
        raise ValueError("VP8 frame header is not a shown key frame")
    w = (payload[6] | payload[7] << 8) & 0x3FFF
    h = (payload[8] | payload[9] << 8) & 0x3FFF
    if not w or not h:
        raise ValueError("VP8 frame of zero size")
    return w, h


def _alpha_ok(payload: bytes, w: int, h: int) -> None:
    """Where libwebp fails an ALPH chunk: its header byte, raw alpha
    shorter than the image, lossless alpha that does not decode."""
    if len(payload) <= 1:
        raise ValueError("WebP ALPH chunk is empty")
    method, pre, rsrv = payload[0] & 3, (payload[0] >> 4) & 3, \
        payload[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError("WebP ALPH header is not one libwebp reads")
    if method == 0 and len(payload) - 1 < w * h:
        raise ValueError("WebP ALPH data ends early")
    if method == 1:
        decode_alpha(payload[1:], w, h)


def decode_webp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a still WebP file, PIL's `convert("RGB")` of it
    byte for byte."""
    if not accept(data):
        raise ValueError("not a WebP file")
    if len(data) < 20:
        raise ValueError("WebP file ends early")
    riff = int.from_bytes(data[4:8], "little")
    if riff < 8 or riff > MAX_PAYLOAD:
        raise ValueError(f"WebP RIFF size {riff}")
    if len(data) < riff + 8:
        raise ValueError("WebP file is shorter than its RIFF size")
    data = data[:riff + 8]
    fourcc, at, size = _chunk(data, 12)
    if fourcc != b"VP8X":
        # a simple file: the image, then at most one ALPH chunk read
        # (dropped) before the demuxer stops at the next chunk
        image = _image(data, fourcc, at, size)
        bomb.check("WebP", *_size(*image))
        pos, alpha = _after(at, size), False
        while pos < len(data):
            fourcc, at, size = _chunk(data, pos)
            if fourcc != b"ALPH" or alpha:
                break
            pos, alpha = _after(at, size), True
        return _decode(*image)
    if size < 10:
        raise ValueError("WebP VP8X chunk is shorter than 10 bytes")
    flags = data[at]
    cw = 1 + int.from_bytes(data[at + 4:at + 7], "little")
    ch = 1 + int.from_bytes(data[at + 7:at + 10], "little")
    if cw * ch >= MAX_AREA:
        raise ValueError("WebP canvas too large")
    bomb.check("WebP", cw, ch)
    frames = _demux(data, _after(at, size), flags)
    if flags & ~VALID_FLAGS & 0xFF:
        raise ValueError(f"WebP VP8X flags {flags:#04x}")
    animated = bool(flags & ANIMATION)
    for f in frames:
        if f.alpha is not None and (f.image is None
                                    or f.alpha[0] > f.image[0]):
            raise ValueError("WebP ALPH chunk after its image")
        if animated:
            if f.x + f.w > cw or f.y + f.h > ch:
                raise ValueError("WebP frame outside its canvas")
        elif (f.x, f.y, f.w, f.h) != (0, 0, cw, ch):
            raise ValueError("WebP image is not the size of its canvas")
    first = frames[0]
    if first.alpha is not None and (animated or flags & ALPHA_FLAG):
        _alpha_ok(data[first.alpha[1]:first.alpha[1] + first.alpha[2]],
                  first.w, first.h)
    rgb = _decode(*first.image[1:])
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[first.y:first.y + first.h, first.x:first.x + first.w] = rgb
    return canvas


class _Frame(NamedTuple):
    """A frame the demuxer keeps: its place on the canvas and its chunks,
    (chunk start, payload start, payload size) for ALPH and (chunk start,
    fourcc, bitstream, chunk size) for the image."""
    x: int
    y: int
    w: int
    h: int
    alpha: tuple
    image: tuple


def _frame(data: bytes, pos: int, x: int, y: int, w: int, h: int) -> tuple:
    """libwebp's StoreFrame from pos: at most one ALPH and one image chunk
    (VP8L not after ALPH), stopping at any other chunk. Returns (the
    frame or None, the position after its chunks)."""
    alpha = image = None
    end = len(data)
    if end - pos < 8:
        raise ValueError("WebP frame ends early")
    while pos < end:
        fourcc, at, size = _chunk(data, pos)
        if fourcc == b"ALPH" and alpha is None:
            alpha = (pos, at, size)
        elif fourcc in (b"VP8 ", b"VP8L") and image is None:
            if fourcc == b"VP8L" and alpha is not None:
                raise ValueError("WebP VP8L image after an ALPH chunk")
            image = (pos,) + _image(data, fourcc, at, size)
            w, h = _size(*image[1:])
        else:
            break
        pos = _after(at, size)
        if pos < end and end - pos < 8:
            raise ValueError("WebP chunk header runs past the RIFF")
    if alpha is None and image is None:
        return None, pos
    return _Frame(x, y, w, h, alpha, image), pos


def _demux(data: bytes, pos: int, flags: int) -> list:
    """The frames of a VP8X file as libwebp's demuxer (ParseVP8XChunks)
    reads its chunks: a still image is one ALPH and image pair at the top
    level, an animation an ANIM chunk and then ANMF chunks, each a frame
    whose image chunks StoreFrame reads; ICCP, EXIF, XMP and unknown
    chunks are skipped. Every frame is checked, however many are drawn."""
    animated, anim, frames = bool(flags & ANIMATION), False, []
    end = len(data)
    if end - pos < 8:
        raise ValueError("WebP VP8X file holds no image")
    while pos < end:
        fourcc, at, size = _chunk(data, pos)
        padded = size + (size & 1)
        if fourcc == b"VP8X":
            raise ValueError("WebP file holds a second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animated:
                raise ValueError("WebP animation with an image outside "
                                 "its frames")
            if frames:
                raise ValueError("WebP file holds a second image")
            frame, pos = _frame(data, pos, 0, 0, 0, 0)
            if not flags & ALPHA_FLAG:
                frame = frame._replace(alpha=None)
            frames.append(frame)
        elif fourcc == b"ANIM":
            if padded < 6:
                raise ValueError("WebP ANIM chunk is shorter than 6 bytes")
            anim, pos = True, _after(at, size)
        elif fourcc == b"ANMF":
            if not anim:
                raise ValueError("WebP ANMF chunk before ANIM")
            if padded < 16:
                raise ValueError("WebP ANMF chunk is shorter than 16 bytes")
            x = 2 * int.from_bytes(data[at:at + 3], "little")
            y = 2 * int.from_bytes(data[at + 3:at + 6], "little")
            w = 1 + int.from_bytes(data[at + 6:at + 9], "little")
            h = 1 + int.from_bytes(data[at + 9:at + 12], "little")
            if w * h >= MAX_AREA:
                raise ValueError("WebP frame too large")
            if end - (at + 16) < max(8, padded - 16):
                raise ValueError("WebP ANMF chunk ends early")
            frame, pos = _frame(data, at + 16, x, y, w, h)
            if pos - (at + 16) > padded - 16:
                raise ValueError("WebP frame runs past its ANMF chunk")
            if frame is not None and animated:
                frames.append(frame)
        else:
            pos = _after(at, size)
        if pos < end and end - pos < 8:
            raise ValueError("WebP chunk header runs past the RIFF")
    if not frames:
        raise ValueError("WebP VP8X file holds no image")
    return frames


def _decode(fourcc: bytes, payload: bytes, size: int) -> np.ndarray:
    if fourcc == b"VP8L":
        return np.ascontiguousarray(decode_vp8l(payload)[..., :3])
    return decode_vp8(payload)
