"""PIL's decompression-bomb limit, which every decoder of the port keeps.

PIL's `Image.open` checks the size its plugin reports (`im.size`, read
from the file's header) before any pixel is decoded: past twice
`Image.MAX_IMAGE_PIXELS` (89,478,485, a quarter gigabyte of 24-bit
pixels divided by three) it raises DecompressionBombError, and between
the two limits it only warns. A side of 0 counts as 1. Some plugins
check again the size of the image they go on to load (a BLP's inner
image, the ICO, CUR or ICNS entry, a GIF frame). Each decoder calls
`check` at the same points, from the header, so that an image past the
limit raises ValueError before a pixel is decoded.
"""
from __future__ import annotations

# PIL's Image.MAX_IMAGE_PIXELS: int(1024 * 1024 * 1024 // 4 // 3)
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3
# past this many pixels PIL raises DecompressionBombError
MAX_PIXELS = 2 * MAX_IMAGE_PIXELS


def check(fmt: str, w: int, h: int) -> None:
    """Raise ValueError where PIL's open (or its plugin) raises
    DecompressionBombError for an image of w x h pixels."""
    if max(1, w) * max(1, h) > MAX_PIXELS:
        raise ValueError(
            f"{fmt} image of {w}x{h} pixels is past PIL's decompression "
            f"bomb limit of {MAX_PIXELS} pixels")
