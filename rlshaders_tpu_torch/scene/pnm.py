"""PNM (PBM, PGM, PPM) and PFM decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_pnm` returns those bytes for every file PIL's PpmImagePlugin
reads, following its header reader and its three decoders:

* P4, P5 and P6 (binary) and P1, P2 and P3 (plain, ASCII); a header token
  is at most 10 characters, a `#` comment runs to the end of its line
  (and may sit inside a token, which goes on after it);
* bit maps: a 1 is black; maxval 255 is the raw bytes; maxval 65535 of a
  grey map is mode "I" (16-bit big-endian); any other maxval scales each
  sample as round(v / maxval * top) (Python's round, halves to even),
  top 65535 for a grey map whose maxval is above 255 (mode "I") and 255
  otherwise; mode "I" converts to RGB clamped to 255;
* plain data: comments are cut out, then the whitespace-separated tokens
  are the samples (a plain bit map's 0 and 1 need no spaces between
  them); a sample above maxval raises;
* PFM grey ("Pf"): float32 samples, little-endian under a negative scale
  and big-endian under a positive one, rows from the bottom up; PIL's
  mode "F" converts to RGB truncating toward zero and clamping to 0..255
  (0.6 -> 0, 2.5 -> 2, 300 -> 255).

PIL's own extensions (P0CMYK, PyP, PyRGBA, PyCMYK) raise
NotImplementedError naming them; PAM (P7) and colour PFM ("PF") are not
PNM files to PIL, which opens neither. Malformed data raises ValueError.
"""
from __future__ import annotations

import math

import numpy as np

from . import bomb
from .png import unpack_samples

_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
# magic -> PIL's mode (PpmImagePlugin.MODES)
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_EXTENSIONS = (b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK")


def magic(data: bytes) -> bytes:
    """The magic number as PIL reads it: up to 6 bytes, ended by
    whitespace."""
    out = b""
    for c in data[:6]:
        if c in _WHITESPACE:
            break
        out += bytes([c])
    return out


def header_ok(data: bytes) -> bool:
    """Whether PIL's PpmImageFile._open takes the file (a magic number it
    has a mode for; anything else PIL tries next)."""
    return magic(data) in MODES


class _Reader:
    """PIL's header token reader over the bytes."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def _read(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def token(self) -> bytes:
        token = b""
        while len(token) <= 10:
            c = self._read()
            if not c:
                break
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self._read() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise ValueError("PNM header ends early")
        if len(token) > 10:
            raise ValueError(f"PNM header token too long: {token!r}")
        return token

    def number(self, kind=int):
        tok = self.token()
        try:
            return kind(tok)
        except ValueError:
            raise ValueError(f"PNM header token {tok!r} is not a "
                             f"number") from None


def _plain_tokens(block: bytes) -> list:
    """The whitespace-separated tokens of plain data with its comments (a
    `#` to the next CR or LF) cut out."""
    while True:
        start = block.find(b"#")
        if start == -1:
            break
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        end = min(a, b) if a * b > 0 else max(a, b)
        block = block[:start] if end == -1 else (block[:start]
                                                 + block[end + 1:])
    return block.split()


def _scale(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """PIL's round(v / maxval * top) in float64, halves to even."""
    return np.round(v.astype(np.float64) / maxval * top).astype(np.int64)


def float_to_rgb(f: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 of (H, W) mode "F" samples as PIL's
    `convert("RGB")` makes them: truncated toward zero and clamped to
    0..255 (NaN 0, -inf 0, inf 255)."""
    with np.errstate(invalid="ignore"):         # signalling NaNs too
        f = np.asarray(f, np.float64)
        g = np.where(f >= 255.0, 255, np.where(
            f > 0.0, np.trunc(np.nan_to_num(f)), 0)).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=2)


def decode_pnm(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a PNM or PFM file, PIL's `convert("RGB")` of it
    byte for byte."""
    m = magic(data)
    if m not in MODES:
        raise ValueError("not a PNM file")
    if m in _EXTENSIONS:
        raise NotImplementedError(f"PPM (PNM) of PIL's own {m.decode()} "
                                  f"extension is not decoded by the port")
    mode = MODES[m]
    rd = _Reader(data, len(m) + 1)
    w, h = rd.number(), rd.number()
    if w <= 0 or h <= 0:
        raise ValueError(f"PNM of {w}x{h} pixels")
    bomb.check("PPM", w, h)
    bands = 3 if mode == "RGB" else 1
    if mode == "F":
        scale = rd.number(float)
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PFM scale must be finite and non-zero")
        raw = data[rd.pos:rd.pos + 4 * w * h]
        if len(raw) < 4 * w * h:
            raise ValueError("PFM pixel data ends early")
        f = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(h, w)
        return float_to_rgb(f[::-1])
    maxval = 1 if mode == "1" else rd.number()
    if not 0 < maxval < 65536:
        raise ValueError("PNM maxval must be greater than 0 and less than "
                         "65536")
    grey_i = mode == "L" and maxval > 255         # PIL's mode "I"
    top = 65535 if grey_i else 255
    n = w * h * bands
    body = data[rd.pos:]
    if m in (b"P1", b"P2", b"P3"):
        toks = _plain_tokens(body)
        if mode == "1":
            bits = b"".join(toks)
            if bits.strip(b"01"):
                raise ValueError("PBM plain data holds a token other than "
                                 "0 and 1")
            if len(bits) < n:
                raise ValueError("PNM pixel data ends early")
            v = np.frombuffer(bits[:n], np.uint8) == ord("0")
            return np.repeat((v * 255).astype(np.uint8).reshape(h, w, 1), 3,
                             axis=2)
        if len(toks) < n:
            raise ValueError("PNM pixel data ends early")
        if any(len(t) > 10 for t in toks[:n]):
            raise ValueError("PNM data token too long")
        try:
            v = np.array([int(t) for t in toks[:n]], np.int64)
        except ValueError:
            raise ValueError("PNM plain data holds a token that is not a "
                             "number") from None
        if (v < 0).any() or (v > maxval).any():
            raise ValueError("PNM sample out of 0..maxval")
        v = _scale(v, maxval, top)
    elif mode == "1":
        stride = (w + 7) // 8
        raw = body[:stride * h]
        if len(raw) < stride * h:
            raise ValueError("PNM pixel data ends early")
        bits = unpack_samples(np.frombuffer(raw, np.uint8).reshape(h, stride),
                              w, 1)
        return np.repeat(((1 - bits) * 255).astype(np.uint8)[..., None], 3,
                         axis=2)
    else:
        wide = maxval > 255
        raw = body[:n * (2 if wide else 1)]
        if len(raw) < n * (2 if wide else 1):
            raise ValueError("PNM pixel data ends early")
        v = np.frombuffer(raw, ">u2" if wide else np.uint8).astype(np.int64)
        if maxval != 255 and not (grey_i and maxval == 65535):
            v = np.minimum(_scale(v, maxval, top), top)
    v = np.minimum(v, 255).reshape(h, w, bands)
    if bands == 1:
        v = np.repeat(v, 3, axis=2)
    return v.astype(np.uint8)
