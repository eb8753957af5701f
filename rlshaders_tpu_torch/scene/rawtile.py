"""PIL's "raw" tile decoder, which most of its simple plugins use.

A raw tile is rows of `rowbytes` bytes, `stride` bytes apart (the padding
after the last row is not needed), from `offset` in the file. PIL's
decoder raises where the file ends before the last row, where the stride
is smaller than a row ("raw decoder stride too small") and where the
offset is negative (its seek fails).
"""
from __future__ import annotations

import numpy as np


class Next(ValueError):
    """A plugin's `_open` refused the file: PIL tries the next plugin (a
    ValueError where a decoder meets it: the file is not of its
    format)."""


def takes(header, data: bytes) -> bool:
    """Whether PIL's plugin takes the file: its `_open` (here `header`)
    opens it, or fails it, rather than passing it on (Next)."""
    try:
        header(data)
    except Next:
        return False
    except ValueError:
        pass
    return True


def rows(data: bytes, offset: int, h: int, rowbytes: int,
         stride: int = 0, fmt: str = "image") -> np.ndarray:
    """(h, rowbytes) uint8 of a raw tile."""
    stride = stride or rowbytes
    if stride < rowbytes:
        raise ValueError(f"{fmt} row stride {stride} shorter than a row of "
                         f"{rowbytes} bytes")
    if offset < 0:
        raise ValueError(f"{fmt} data at a negative offset")
    if offset + (h - 1) * stride + rowbytes > len(data):
        raise ValueError(f"{fmt} image data truncated")
    buf = np.frombuffer(data, np.uint8, len(data) - offset, offset)
    if stride == rowbytes:
        return buf[:h * rowbytes].reshape(h, rowbytes)
    return np.lib.stride_tricks.as_strided(
        buf, (h, rowbytes), (stride, 1)).copy()


def grey(v: np.ndarray) -> np.ndarray:
    """(h, w, 3) of one 8-bit channel."""
    return np.repeat(np.asarray(v, np.uint8)[..., None], 3, axis=2)


def palette(entries: np.ndarray, index: np.ndarray) -> np.ndarray:
    """A P image's RGB: indices past the palette's entries are black."""
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(entries)] = entries[:256]
    return pal[index]
