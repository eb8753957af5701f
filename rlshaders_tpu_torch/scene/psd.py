"""PSD (Adobe Photoshop) decoding in numpy, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`.
PIL's PsdImagePlugin opens the merged image of a PSD file (version 1),
reading it as its `_open` does:

* the 26-byte header: signature, version 1, channels, size, depth and
  colour mode, which with the depth picks PIL's mode (`MODES`): bitmap
  at 1 bit as "1", bitmap, grey, multichannel and duotone at 8 bits as
  "L", indexed as "P", RGB as "RGB" (or "RGBA" with four channels
  exactly), CMYK as "CMYK" and Lab as "LAB"; fewer channels than the mode
  needs fail, more are left unread;
* the colour mode data, whose 768 bytes are an indexed image's palette
  (256 reds, then greens, then blues; without them every index is
  black);
* the image resources, walked block by block from their own sizes (so a
  block that claims more moves every later read);
* the layer and mask section, skipped by its size once its layer info
  length is read (PIL reads the layers only for `seek`);
* the merged image: its compression, then raw channels, or (1) a table
  of every row's byte count and PackBits rows. PIL decodes each channel
  from its offset in the file with its own PackBits decoder: a no-op
  record (0x80) is skipped, a record that runs past a row's end is cut
  there, and a channel reads on past its own rows' bytes where those
  decode short; data that ends first is truncated (an error).

CMYK is stored inverted (PIL's "C;I" raw modes) and converted as Pillow's
cmyk2rgb; bitmap pixels are white where set; LAB (colour mode 9), stored
with a* and b* offset by 128 as Pillow keeps them, converts through
LittleCMS's transform as `lab.py` evaluates it. Depths PIL does not open
raise NotImplementedError naming them; malformed data and an image past
PIL's decompression-bomb limit raise ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bomb, lab
from .jpeg import muldiv255

MAGIC = b"8BPS"
# (colour mode, bits) -> (PIL's mode, the channels it needs)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


class _File:
    """PIL's file reads: short at the end of the file, a position that a
    seek may put past it."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos = min(self.pos + max(n, 0), max(self.pos, len(self.data)))
        return out

    def u(self, n: int) -> int:
        b = self.read(n)
        if len(b) != n:
            raise ValueError("PSD header ends early")
        return int.from_bytes(b, "big")


def _header(data: bytes) -> tuple:
    """(mode, channels read, width, height, palette, compression, offsets
    of the channels' data) as PIL's `_open` leaves them."""
    f = _File(data)
    s = f.read(26)
    if len(s) < 26 or not s.startswith(MAGIC) or \
            struct.unpack_from(">H", s, 4)[0] != 1:
        raise ValueError("not a PSD file (or not version 1)")
    nch, h, w, bits, cmode = struct.unpack_from(">HIIHH", s, 12)
    if (cmode, bits) not in MODES:
        raise NotImplementedError(
            f"PSD of colour mode {cmode} at {bits} bits (which PIL does not "
            f"open either) is not decoded by the port")
    mode, channels = MODES[(cmode, bits)]
    if channels > nch:
        raise ValueError("PSD with fewer channels than its mode needs")
    if mode == "RGB" and nch == 4:
        mode, channels = "RGBA", 4
    size = f.u(4)
    palette = None
    if size:
        cmd = f.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(cmd, np.uint8).reshape(3, 256).T
    size = f.u(4)
    if size:
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            f.u(2)
            n = f.u(1)
            name = f.read(n)
            if not len(name) & 1:
                f.read(1)
            block = f.read(f.u(4))
            if len(block) & 1:
                f.read(1)
    size = f.u(4)
    if size:
        end = f.pos + size
        f.u(4)
        f.pos = end
    compression = f.u(2)
    offsets = []
    if compression == 0:
        plane = w * h
        offsets = [f.pos + k * plane for k in range(channels)]
    elif compression == 1:
        table = f.read(2 * channels * h)
        if len(table) < 2 * channels * h:
            raise ValueError("PSD row byte counts end early")
        counts = np.frombuffer(table, ">u2").astype(np.int64).reshape(
            channels, h)
        start = f.pos + np.concatenate([[0], np.cumsum(counts.sum(1))])
        offsets = [int(v) for v in start[:channels]]
    return mode, channels, w, h, palette, compression, offsets


def _packbits(data: bytes, at: int, rows: int, rowbytes: int) -> np.ndarray:
    """(rows, rowbytes) uint8: PIL's PackBits decoder from `at` in the
    file: records cut at a row's end, a no-op record (0x80) skipped."""
    out = np.zeros(rows * rowbytes, np.uint8)
    buf = np.frombuffer(data, np.uint8)
    y = x = 0
    i = at
    n = len(data)
    while y < rows:
        if i >= n:
            raise ValueError("PSD image data truncated")
        c = data[i]
        if c == 0x80:
            i += 1
            continue
        if c & 0x80:
            if i + 2 > n:
                raise ValueError("PSD image data truncated")
            k = min(257 - c, rowbytes - x)
            out[y * rowbytes + x:y * rowbytes + x + k] = data[i + 1]
            i += 2
        else:
            if i + c + 2 > n:
                raise ValueError("PSD image data truncated")
            k = min(c + 1, rowbytes - x)
            out[y * rowbytes + x:y * rowbytes + x + k] = buf[i + 1:i + 1 + k]
            i += c + 2
        x += k
        if x >= rowbytes:
            x, y = 0, y + 1
    return out.reshape(rows, rowbytes)


def decode_psd(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a PSD file's merged image, PIL's
    `convert("RGB")` of it byte for byte."""
    mode, channels, w, h, palette, compression, offsets = _header(data)
    bomb.check("PSD", w, h)
    if w == 0 or h == 0:
        raise ValueError(f"PSD of {w}x{h} pixels")
    if compression not in (0, 1):
        raise ValueError(f"PSD compression {compression}: PIL cannot load "
                         f"the image")
    rowbytes = (w + 7) // 8 if mode == "1" else w
    planes = []
    for off in offsets:
        if compression == 0:
            if off + h * rowbytes > len(data):
                raise ValueError("PSD image data truncated")
            plane = np.frombuffer(data, np.uint8, h * rowbytes, off).reshape(
                h, rowbytes)
        else:
            plane = _packbits(data, off, h, rowbytes)
        planes.append(plane)
    if mode == "1":
        g = np.unpackbits(planes[0], axis=1)[:, :w] * np.uint8(255)
        return np.repeat(g[..., None], 3, axis=2)
    if mode == "L":
        return np.repeat(planes[0][..., None], 3, axis=2)
    if mode == "P":
        if palette is None:
            return np.zeros((h, w, 3), np.uint8)
        return palette[planes[0]]
    if mode == "LAB":
        return lab.to_rgb(np.stack(planes[:3], -1))
    px = np.stack(planes[:3], -1).astype(np.int64)
    if mode == "CMYK":
        k = planes[3].astype(np.int64)[..., None]    # stored inverted
        return muldiv255(px, k).astype(np.uint8)
    return px.astype(np.uint8)
