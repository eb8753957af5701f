"""Zstandard (RFC 8878) decoding for ZSTD-compressed TIFF, as libtiff's
ZSTD codec over libzstd 1.5 reads it.

The decoder is native code, `csrc/zstd.cpp`: frame headers (window
descriptor, single-segment frames, content size; a dictionary id fails,
as libtiff gives none), raw, RLE and compressed blocks, literals raw,
RLE or Huffman-coded in one or four streams (treeless literals reuse the
last table), sequences under predefined, RLE, FSE-coded and repeated
tables with the repeat offsets, skippable frames and the XXH64 checksum.
It is compiled by g++ at first use into `rlshaders_tpu_torch/build/` and
bound with ctypes, as `j2k_t1.py` binds its tier-1; a missing compiler
or a failed compile raises.

Where data is corrupt, libzstd's own decoders decide what comes out, so
the native code follows them, not the RFC: Huffman literals in four
streams are decoded with the double-symbol table where libzstd's time
model (HUF_selectDecoder) picks it, and through libzstd's fast loop
where the table has at most 11 bits and every stream 8 bytes or more;
that loop reads a stream's bits on past its start into the bytes before
it (and, below the jump table, round its last 64-bit container), checks
only that no stream's window went more than 8 bytes below its start,
and never checks where a stream's bits end.

`tiff_strip` is one strip or tile as libtiff decodes it: libzstd's
streaming decoder called until the rows are full, the strip's bytes are
spent or its first frame ends. So a frame that decodes past the rows
ends the strip there (its later blocks and checksum unread), a second
frame in a strip is never read, and a strip whose first frame is
skippable or ends short of the rows fails. `frames` decodes every frame
of a buffer as ZSTD_decompress does (the tests hold it to `zstandard`).
Data libzstd fails raises ValueError; a legacy (v0.5-v0.7) frame, which
libzstd still decodes, raises NotImplementedError.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..accel import native

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "zstd.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native.build(CXX_FLAGS, SOURCE, "librls_zstd"))
            i64, vp = ctypes.c_int64, ctypes.c_void_p
            lib.rls_zstd_tiff.restype = ctypes.c_int
            lib.rls_zstd_tiff.argtypes = [ctypes.c_char_p, i64, vp, i64,
                                          ctypes.c_char_p, ctypes.c_int]
            lib.rls_zstd_frames.restype = ctypes.c_int
            lib.rls_zstd_frames.argtypes = [ctypes.c_char_p, i64, vp, i64,
                                            vp, ctypes.c_char_p,
                                            ctypes.c_int]
            _lib = lib
    return _lib


def _check(rc: int, msg) -> None:
    if rc == 2:
        raise NotImplementedError("legacy (v0.5-v0.7) Zstandard frames, "
                                  "which libzstd still decodes, are not "
                                  "decoded by the port")
    if rc:
        raise ValueError(f"corrupt Zstandard data: {msg.value.decode()}")


def tiff_strip(raw: bytes, need: int) -> bytes:
    """The `need` bytes of one ZSTD strip or tile, as libtiff decodes it;
    ValueError where libtiff fails it."""
    out = np.zeros(max(need, 1), np.uint8)
    msg = ctypes.create_string_buffer(128)
    lib = _lib or _load()
    _check(lib.rls_zstd_tiff(bytes(raw), len(raw), out.ctypes.data, need,
                             msg, len(msg)), msg)
    return out[:need].tobytes()


def frames(data: bytes, cap: int) -> bytes:
    """Every frame of `data` (at most `cap` bytes of output), as
    ZSTD_decompress decodes it."""
    out = np.zeros(max(cap, 1), np.uint8)
    got = np.zeros(1, np.int64)
    msg = ctypes.create_string_buffer(128)
    lib = _lib or _load()
    _check(lib.rls_zstd_frames(bytes(data), len(data), out.ctypes.data, cap,
                               got.ctypes.data, msg, len(msg)), msg)
    return out[:int(got[0])].tobytes()
