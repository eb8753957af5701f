"""WebP decoding (the RIFF container), equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`.
PIL 12.1 takes a file as WebP where it starts "RIFF", then 4 bytes, then
"WEBP" and a first chunk "VP8 ", "VP8L" or "VP8X", and reads it through
libwebp's demuxer and animation decoder, which give it RGBA without
premultiplying: its RGB is the image's own. `decode_webp` returns those
bytes for a still image, checking the container as the demuxer does:

* the RIFF size is at least 8 and the file holds all of it (bytes past
  it are ignored); every chunk the demuxer reads has a size that, padded
  to even, fits in the RIFF, and no 1-7 bytes follow it in the RIFF;
* a simple file is a "VP8 " (lossy, vp8.py) or "VP8L" (lossless,
  vp8l.py) chunk; the demuxer reads one ALPH chunk after it (dropped)
  and the header of the next chunk, and stops there;
* "VP8X" (at least 10 bytes: flags, 24-bit canvas width and height less
  one) may be followed by ICCP, EXIF, XMP and unknown chunks (skipped:
  `convert("RGB")` applies no profile) and holds one image: an optional
  ALPH chunk (decoded where the alpha flag is set, as libwebp fails a
  file on broken alpha, then dropped) then at once a VP8 chunk, or a
  VP8L chunk, as large as the canvas; no flag bits outside alpha,
  animation, ICC, EXIF and XMP.

The decoders get the image chunk with its pad byte, as libwebp's do: a
stream of odd length may read its pad byte.

An animated file (the VP8X animation flag; ANIM and ANMF chunks) raises
NotImplementedError naming animated WebP. Malformed data raises
ValueError.
"""
from __future__ import annotations

import numpy as np

from .vp8 import START_CODE, decode_vp8
from .vp8l import decode_alpha, decode_vp8l
from .vp8l import header as _vp8l_header

KINDS = (b"VP8 ", b"VP8L", b"VP8X")
ANIMATION, ALPHA_FLAG = 0x02, 0x10
VALID_FLAGS = 0x3E             # alpha, animation, ICC, EXIF, XMP
MAX_PAYLOAD = 0xFFFFFFF6


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


def _animated(fourcc: bytes) -> None:
    if fourcc in (b"ANIM", b"ANMF"):
        raise NotImplementedError(f"WEBP: animated WebP images (an "
                                  f"{fourcc.decode()} chunk) are not "
                                  f"decoded by the port")


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
        _size(*image)
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
    if cw * ch >= 1 << 32:
        raise ValueError("WebP canvas too large")
    if flags & ANIMATION:
        raise NotImplementedError("WEBP: animated WebP images are not "
                                  "decoded by the port")
    if flags & ~VALID_FLAGS & 0xFF:
        raise ValueError(f"WebP VP8X flags {flags:#04x}")
    pos = _after(at, size)
    if pos >= len(data):
        raise ValueError("WebP VP8X file holds no image")
    alpha = image = None
    while pos < len(data):
        fourcc, at, size = _chunk(data, pos)
        pos = _after(at, size)
        _animated(fourcc)
        if fourcc == b"VP8X":
            raise ValueError("WebP file holds a second VP8X chunk")
        if fourcc not in (b"ALPH", b"VP8 ", b"VP8L"):
            continue                         # ICCP, EXIF, XMP and others
        if image is not None:
            raise ValueError("WebP file holds a second image")
        if fourcc == b"ALPH":
            # the frame: the image chunk must follow at once
            alpha = data[at:at + size]
            fourcc, at, size = _chunk(data, pos) if pos < len(data) \
                else (b"", pos, 0)
            if fourcc != b"VP8 ":
                raise ValueError("WebP ALPH chunk not followed by a VP8 "
                                 "image")
            pos = _after(at, size)
        image = _image(data, fourcc, at, size)
        if pos < len(data) and data[pos:pos + 4] == b"ALPH":
            raise ValueError("WebP ALPH chunk after the image")
    if image is None:
        raise ValueError("WebP VP8X file holds no image")
    if _size(*image) != (cw, ch):
        raise ValueError("WebP image is not the size of its canvas")
    if alpha is not None and flags & ALPHA_FLAG:
        _alpha_ok(alpha, cw, ch)
    return _decode(*image)


def _decode(fourcc: bytes, payload: bytes, size: int) -> np.ndarray:
    if fourcc == b"VP8L":
        return np.ascontiguousarray(decode_vp8l(payload)[..., :3])
    return decode_vp8(payload)
