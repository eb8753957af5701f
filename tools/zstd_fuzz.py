"""Hold `rlshaders_tpu_torch/scene/zstd.py::tiff_strip` to Pillow's bundled
libzstd, called through ctypes as libtiff's ZSTD codec calls it
(ZSTD_decompressStream until the rows are full, the input is spent or a
frame ends), on seeded frames, mutated and cut.

Each case compresses a seeded source (small alphabets, noise, random
walks, text, repeated patterns, long runs; 200 B to 300 KB, so blocks of
raw, RLE and Huffman literals in one and four streams, both Huffman
decoders and libzstd's fast loop) with `zstandard` at a level of -5 to
19, checksum and content size on or off; then leaves it, changes one to
three of its bytes (after zeroing its tail, or not), or cuts it short,
and asks for all or part of its output. A case agrees where both fail,
or both give the same bytes.

    PYTHONPATH=. python tools/zstd_fuzz.py [seed [cases]]

prints the cases that disagree and their count (0 where the port is
right). About 15 s for the default 1,500 cases on a CPU.
"""
from __future__ import annotations

import ctypes
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from rlshaders_tpu_torch.scene import zstd  # noqa: E402


class _Buf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def library():
    import PIL
    import PIL._imaging  # noqa: F401  (loads the bundled libraries)

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    z = ctypes.CDLL(glob.glob(os.path.join(libs, "libzstd-*.so*"))[0])
    z.ZSTD_createDStream.restype = ctypes.c_void_p
    z.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
    z.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    z.ZSTD_decompressStream.restype = ctypes.c_size_t
    z.ZSTD_decompressStream.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(_Buf),
                                        ctypes.POINTER(_Buf)]
    z.ZSTD_isError.argtypes = [ctypes.c_size_t]
    return z


def libtiff_strip(z, frame: bytes, need: int):
    """libtiff's ZSTDDecode over libzstd: the `need` bytes, or None."""
    ds = z.ZSTD_createDStream()
    z.ZSTD_initDStream(ds)
    src = ctypes.create_string_buffer(frame, len(frame))
    dst = ctypes.create_string_buffer(max(need, 1))
    inp = _Buf(ctypes.cast(src, ctypes.c_void_p), len(frame), 0)
    out = _Buf(ctypes.cast(dst, ctypes.c_void_p), need, 0)
    try:
        while True:
            r = z.ZSTD_decompressStream(ds, ctypes.byref(out),
                                        ctypes.byref(inp))
            if z.ZSTD_isError(r):
                return None
            if r == 0 or inp.pos >= inp.size or out.pos >= out.size:
                break
        return dst.raw[:need] if out.pos == need else None
    finally:
        z.ZSTD_freeDStream(ds)


def source(rng) -> bytes:
    size = int(rng.choice([200, 3000, 20000, 70000, 140000, 300000]))
    kind = int(rng.integers(0, 6))
    if kind == 0:
        return rng.integers(0, int(rng.integers(2, 64)), size,
                            np.uint8).tobytes()
    if kind == 1:
        return rng.integers(0, 256, size, np.uint8).tobytes()
    if kind == 2:
        return (np.cumsum(rng.integers(-2, 3, size)) % 256).astype(
            np.uint8).tobytes()
    if kind == 3:
        return (b"lorem ipsum dolor sit amet %d " % int(
            rng.integers(0, 99))) * (size // 30)
    if kind == 4:
        pattern = rng.integers(0, 256, int(rng.integers(1, 50)), np.uint8)
        return np.resize(pattern, size).tobytes()
    return np.repeat(rng.integers(0, 256, size // 50 + 1, np.uint8),
                     50)[:size].tobytes()


def main(seed: int = 18, cases: int = 1500) -> int:
    import zstandard

    z = library()
    rng = np.random.default_rng(seed)
    bad = 0
    for case in range(cases):
        src = source(rng)
        level = int(rng.choice([-5, -1, 1, 3, 6, 12, 19]))
        params = zstandard.ZstdCompressionParameters.from_level(
            level, write_checksum=bool(rng.integers(0, 2)),
            write_content_size=bool(rng.integers(0, 2)))
        frame = bytearray(zstandard.ZstdCompressor(
            compression_params=params).compress(src))
        mode = int(rng.integers(0, 5))
        if mode == 4:                       # a zeroed tail, then mutated
            cut = int(rng.integers(4, len(frame)))
            frame[cut:] = bytes(len(frame) - cut)
        if mode:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(4, len(frame)))
                frame[i] = (int(rng.integers(0, 256)) if rng.random() < 0.5
                            else frame[i] ^ (1 << int(rng.integers(0, 8))))
        if mode == 3:
            frame = frame[:int(rng.integers(5, len(frame) + 1))]
        need = len(src) if rng.random() < 0.7 else max(
            1, len(src) - int(rng.integers(0, len(src) // 2 + 1)))
        want = libtiff_strip(z, bytes(frame), need)
        try:
            got = zstd.tiff_strip(bytes(frame), need)
        except (ValueError, NotImplementedError):
            got = None
        if got != want:
            bad += 1
            print(f"case {case}: libzstd "
                  f"{'fails' if want is None else 'decodes'}, the port "
                  f"{'fails' if got is None else 'decodes'}"
                  f"{' otherwise' if got and want else ''} (level {level}, "
                  f"{len(src)} B, {need} B asked)")
    print(f"{bad} of {cases} cases disagree")
    return bad


if __name__ == "__main__":
    sys.exit(1 if main(*(int(a) for a in sys.argv[1:3])) else 0)
