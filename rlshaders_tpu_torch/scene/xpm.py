"""XPM (X PixMap) decoding, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`;
`decode_xpm` returns those bytes for every file PIL's XpmImagePlugin
opens, read line by line as it reads them:

* after "/* XPM */", the first line PIL's pattern `"w h colours bpp`
  matches gives the size, the number of colour lines and the characters
  a pixel;
* each colour line: its key (the `bpp` characters after its first), then
  the words up to its last two characters in pairs, of which the first
  "c" pair counts: "None" (transparent: the key gets no colour) or
  "#" and hexadecimal digits (the low 24 bits are the colour); anything
  else, or no "c" pair, fails;
* up to 256 colours make a palette ("P"), more an RGB image; a key given
  twice keeps its first place and its last colour;
* the pixels: every later line but a first "/* pixels */", the text
  between its first and last double quote cut into keys of `bpp`
  characters, until the image is full; a key that has no colour fails,
  as does data that ends before the last pixel.

A header PIL's plugin refuses passes the file on (see `accept`).
"""
from __future__ import annotations

import re

import numpy as np

from . import bomb, rawtile

MAGIC = b"/* XPM */"
_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


class _File:
    """The file's readline, as PIL's plugin reads it."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        line = self.data[self.pos:end]
        self.pos = end
        return line


def _header(data: bytes) -> tuple:
    """(w, h, bpp, palette {key: colour or None}, file at the pixels);
    Next where PIL tries the next plugin, ValueError where it fails."""
    if not data.startswith(MAGIC):
        raise rawtile.Next("not an XPM file")
    f = _File(data, len(MAGIC))
    while True:
        line = f.readline()
        if not line:
            raise rawtile.Next("broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    w, h, n, bpp = (int(g) for g in m.groups())
    pal = {}
    for _ in range(n):
        line = f.readline().rstrip()
        key = line[1:bpp + 1]
        words = line[bpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise rawtile.Next("XPM colour line cut")
                rgb = words[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    pal[key] = (v >> 16 & 255, v >> 8 & 255, v & 255)
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    if w <= 0 or h <= 0:
        raise rawtile.Next("XPM of no pixels")
    return w, h, bpp, pal, f


def accept(data: bytes) -> bool:
    """PIL's _accept and the checks of its _open (a header it fails is
    still its file: the decoder raises)."""
    return rawtile.takes(_header, data)


def decode_xpm(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an XPM file, PIL's `convert("RGB")` of it byte
    for byte."""
    w, h, bpp, pal, f = _header(data)
    bomb.check("XPM", w, h)
    keys = list(pal)
    index = {k: i for i, k in enumerate(keys)}
    out = []
    seen_pixels = False
    while len(out) < w * h:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not seen_pixels:
            seen_pixels = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(text), bpp):
            key = text[i:i + bpp]
            if key not in index:
                raise ValueError("XPM pixel of a key with no colour")
            out.append(index[key])
    if len(out) < w * h:
        raise ValueError("XPM pixel data ends early")
    colours = np.array([pal[k] for k in keys] or np.zeros((0, 3)),
                       np.uint8).reshape(-1, 3)
    return colours[np.array(out[:w * h]).reshape(h, w)]
