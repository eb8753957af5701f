"""CCITT fax decoding (ITU-T T.4 and T.6) for TIFF compressions 2, 3 and 4,
as libtiff decodes them for PIL.

* compression 2, modified Huffman: one-dimensional rows, no EOL codes,
  each row starting on a byte boundary;
* compression 3, T.4 (Group 3): every row follows an EOL code (eleven or
  more 0 bits and a 1: fill bits before it are skipped); under
  T4Options bit 0 the EOL is followed by a tag bit, 1 for a
  one-dimensional row and 0 for a two-dimensional one;
* compression 4, T.6 (Group 4): two-dimensional rows, no EOL codes.

A run is coded as make-up codes (64 to 2560) and one terminating code
(0 to 63), from the white or the black table; the two-dimensional modes
(pass, horizontal, vertical -3..3) code the row's changes against the row
above, which is all white at the top of each strip or tile. Runs coded
"white" are 0 bits and "black" ones 1 bits, whatever the photometric
interpretation, which the caller applies. Fill order 2 reverses the bits
of every byte first.

`decode` returns the rows as an (h, w) uint8 array of those bits. The
bits are walked in Python over a string of '0' and '1', code by code
(tens of thousands of codes a second). Uncompressed-mode extensions and
codes that match no table raise ValueError, as do rows that run past the
width or data that ends before the last row.
"""
from __future__ import annotations

import numpy as np

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
# make-up codes 1792..2560, shared by both colours
_EXTENDED = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111")


def _table(term: str, makeup: str) -> dict:
    codes = {c: i for i, c in enumerate(term.split())}
    codes.update({c: 64 * (i + 1) for i, c in enumerate(makeup.split())})
    codes.update({c: 1792 + 64 * i for i, c in enumerate(_EXTENDED.split())})
    return codes


# code -> run length, for a white and a black run
RUNS = (_table(_WHITE_TERM, _WHITE_MAKEUP), _table(_BLACK_TERM,
                                                   _BLACK_MAKEUP))
# two-dimensional mode codes: "P" pass, "H" horizontal, an int vertical
MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2,
         "0000011": 3, "010": -1, "000010": -2, "0000010": -3}
_LENGTHS = [sorted({len(c) for c in t}) for t in RUNS]
_MODE_LENGTHS = sorted({len(c) for c in MODES})


def _code(bits: str, pos: int, table: dict, lengths: list):
    for n in lengths:
        v = table.get(bits[pos:pos + n])
        if v is not None:
            return v, pos + n
    if pos >= len(bits):
        raise ValueError("CCITT data ends before the last row")
    if bits.startswith("0000001", pos):
        raise ValueError(f"CCITT extension or EOL code inside a row at bit "
                         f"{pos} (uncompressed mode is not decoded)")
    raise ValueError(f"CCITT data holds no valid code at bit {pos}")


def _run(bits: str, pos: int, colour: int):
    """One run of `colour` (0 white, 1 black): make-up codes and its
    terminating code."""
    total = 0
    while True:
        n, pos = _code(bits, pos, RUNS[colour], _LENGTHS[colour])
        total += n
        if n < 64:
            return total, pos


def _row_1d(bits: str, pos: int, w: int):
    """The changes of one one-dimensional (modified Huffman) row."""
    changes, a0, colour = [], 0, 0
    while a0 < w:
        n, pos = _run(bits, pos, colour)
        a0 += n
        changes.append(a0)
        colour ^= 1
    if a0 > w:
        raise ValueError(f"CCITT row of {a0} pixels, the image has {w}")
    return changes, pos


def _row_2d(bits: str, pos: int, w: int, ref: list):
    """The changes of one two-dimensional row against the changes `ref`
    of the row above (T.4 section 4.2, T.6)."""
    ref = ref + [w] * 4
    changes, a0, colour, p = [], -1, 0, 0
    while a0 < w:
        mode, pos = _code(bits, pos, MODES, _MODE_LENGTHS)
        while ref[p] <= a0:
            p += 1
        i = p if p % 2 == colour else p + 1       # b1: a change to the
        b1, b2 = ref[i], ref[i + 1]               # colour opposite a0's
        if mode == "P":
            a0 = b2
        elif mode == "H":
            start = max(a0, 0)
            n1, pos = _run(bits, pos, colour)
            n2, pos = _run(bits, pos, colour ^ 1)
            changes += [start + n1, start + n1 + n2]
            a0 = start + n1 + n2
        else:
            a1 = b1 + mode
            if a1 < max(a0, 0) or a1 > w:
                raise ValueError(f"CCITT vertical mode to {a1} outside the "
                                 f"row")
            changes.append(a1)
            a0, colour = a1, colour ^ 1
    if a0 > w:
        raise ValueError(f"CCITT row of {a0} pixels, the image has {w}")
    return changes, pos


def _pixels(changes: list, w: int) -> np.ndarray:
    """(w,) uint8 of a row's bits from its changes (runs alternate white,
    black, ... from the left edge)."""
    row = np.zeros(w + 1, np.int8)
    edges = [min(c, w) for c in changes]
    np.add.at(row, edges[0::2], 1)        # a change to black
    np.add.at(row, edges[1::2], -1)       # and back to white
    return np.cumsum(row)[:w].astype(np.uint8)


def decode(raw: bytes, w: int, h: int, compression: int,
           t4options: int = 0, fill_order: int = 1) -> np.ndarray:
    """(h, w) uint8 of the bits (1 where a run was coded black) of the
    `h` rows of one strip or tile of CCITT data."""
    arr = np.frombuffer(raw, np.uint8)
    bits = (np.unpackbits(arr, bitorder="little" if fill_order == 2
                          else "big") + 48).tobytes().decode("ascii")
    out = np.zeros((h, w), np.uint8)
    pos, ref = 0, []
    for y in range(h):
        if compression == 2:
            changes, pos = _row_1d(bits, pos, w)
            pos = -(-pos // 8) * 8
        elif compression == 3:
            z = bits.find("0" * 11, pos)
            one = bits.find("1", z + 11) if z >= 0 else -1
            if one < 0:
                raise ValueError("CCITT Group 3 row without its EOL code")
            pos = one + 1
            two_d = False
            if t4options & 1:
                two_d = bits[pos:pos + 1] == "0"
                pos += 1
            if two_d:
                changes, pos = _row_2d(bits, pos, w, ref)
            else:
                changes, pos = _row_1d(bits, pos, w)
        else:
            changes, pos = _row_2d(bits, pos, w, ref)
        out[y] = _pixels(changes, w)
        # the row's real changes (no zero-length runs) for the next row
        ref = np.flatnonzero(np.diff(out[y], prepend=0)).tolist()
    return out
