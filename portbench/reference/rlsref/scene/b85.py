"""Decoder for Arnold's .ass base-85 array encoding.

Reverse-engineered from the testsuite scenes (testsuite/data/test_geo.ass
`b85POINT`/`b85VECTOR`/`b85UINT` blocks). Format:

* 5 chars encode one uint32, most-significant digit first; digit d is the
  character chr(36 + d) (alphabet '$'..'x').
* Special single chars: 'z' = 0x00000000 (0.0f), 'y' = 0x3F800000 (1.0f).
* '!' introduces run-length encoding: the next 5-char group is the value,
  the following 5-char group is the repeat count (in 4-byte groups).
* Full groups are little-endian byte streams; a trailing partial group of
  n chars (2..4) encodes its n-1 HIGH bytes most-significant-first
  (ASCII85-style truncation, validated on the testsuite meshes).
* Integer arrays (b85UINT) carry a leading width marker that packs values
  little-endian into each uint32: 'B' = 1, 'C' = 2, 'D' = 4 bytes per value.

Decoding is vectorized with NumPy; the scalar pass only walks special chars.

Copied verbatim from rlshaders_tpu/scene/b85.py: importing any
module of rlshaders_tpu imports jax, which the torch port must not need.
"""
from __future__ import annotations

import numpy as np

_POW = np.array([85**4, 85**3, 85**2, 85, 1], np.uint64)
_ZERO_BYTES = (0).to_bytes(4, "little")
_ONE_F_BYTES = (0x3F800000).to_bytes(4, "little")


def _decode_plain(chars: np.ndarray) -> bytes:
    """Vectorized decode of a pure digit-char array to a byte stream."""
    n = chars.size
    n_full = n // 5
    out = b""
    if n_full:
        digits = (chars[: n_full * 5].astype(np.uint64) - 36).reshape(n_full, 5)
        vals = (digits * _POW).sum(axis=1).astype(np.uint32)
        out = vals.astype("<u4").tobytes()
    rem = n - n_full * 5
    if rem >= 2:
        tail = chars[n_full * 5 :].astype(np.uint64) - 36
        v = 0
        for d in tail:
            v = v * 85 + int(d)
        for _ in range(5 - rem):
            v = v * 85 + 84  # pad with max digits
        out += (v & 0xFFFFFFFF).to_bytes(4, "big")[: rem - 1]
    return out


def _decode_groups(blob: str) -> np.ndarray:
    """Decode a b85 blob (with specials/RLE) into a uint8 stream."""
    if ("z" not in blob) and ("y" not in blob) and ("!" not in blob):
        chars = np.frombuffer(blob.encode("latin-1"), np.uint8)
        return np.frombuffer(_decode_plain(chars), np.uint8)

    pieces: list[bytes] = []
    plain_start = 0
    i = 0
    n = len(blob)

    def flush(end):
        if end > plain_start:
            chars = np.frombuffer(blob[plain_start:end].encode("latin-1"), np.uint8)
            pieces.append(_decode_plain(chars))

    def read_value(j):
        """One 5-char group starting at j (no specials inside)."""
        v = 0
        for c in blob[j : j + 5]:
            v = v * 85 + (ord(c) - 36)
        return v, j + 5

    while i < n:
        c = blob[i]
        if c == "z":
            flush(i)
            pieces.append(_ZERO_BYTES)
            i += 1
            plain_start = i
        elif c == "y":
            flush(i)
            pieces.append(_ONE_F_BYTES)
            i += 1
            plain_start = i
        elif c == "!":
            flush(i)
            val, j = read_value(i + 1)
            cnt, j = read_value(j)
            pieces.append(int(val).to_bytes(4, "little") * int(cnt))
            i = j
            plain_start = i
        else:
            i += 1
    flush(n)
    return np.frombuffer(b"".join(pieces), np.uint8)


def decode_floats(blob: str) -> np.ndarray:
    """Decode a b85POINT/VECTOR/POINT2/FLOAT blob to float32 values."""
    raw = _decode_groups(blob)
    usable = (raw.size // 4) * 4
    return raw[:usable].view("<f4").copy()


def decode_uints(blob: str) -> np.ndarray:
    """Decode a b85UINT blob (with leading width marker) to uint32 values."""
    width = {"B": 1, "C": 2, "D": 4}.get(blob[0])
    if width is None:
        raise ValueError(f"unknown b85UINT width marker {blob[0]!r}")
    raw = _decode_groups(blob[1:])
    usable = (raw.size // width) * width
    return raw[:usable].view(f"<u{width}").astype(np.uint32)
