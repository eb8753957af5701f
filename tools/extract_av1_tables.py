"""Write rlshaders_tpu_torch/scene/csrc/av1_tables.h: the AV1 constant
tables the port's intra-frame decoder (scene/csrc/av1.cpp) needs.

The AV1 specification's default CDFs, quantizer lookups, smooth weights,
directional derivatives, filter-intra taps, self-guided parameters,
quantizer matrices and the film grain's gaussian sequence are too long
to write out by hand. The libavif that Pillow ships
(`pillow.libs/libavif-*.so*`) links libaom's encoder and dav1d, and both
keep these tables in `.rodata`. This tool finds each table there by its
known head (its first values as the specification lists them), reads it
in that library's layout and writes it in the specification's form: a
CDF of N symbols is N cumulative values ending in 32768, then a counter
slot of 0, padded to the table's stride. No file is downloaded; a test
re-runs the tool and holds the committed header equal to its output.

The small tables whose every value the specification gives in a line or
two (the mode angles, the CDEF directions and taps, the loop-restoration
and palette constants) and the scan orders are generated here; the square
scans are checked against libaom's copies.

    python tools/extract_av1_tables.py [--check]
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "rlshaders_tpu_torch", "scene", "csrc",
                   "av1_tables.h")


def library() -> bytes:
    import PIL
    pattern = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                           "pillow.libs", "libavif-*.so*")
    found = sorted(glob.glob(pattern))
    if not found:
        raise FileNotFoundError(f"no libavif matches {pattern}")
    with open(found[0], "rb") as f:
        return f.read()


def _rodata(raw: bytes) -> tuple:
    """(start, end) of the ELF file's .rodata section."""
    shoff = int.from_bytes(raw[0x28:0x30], "little")
    shentsize = int.from_bytes(raw[0x3A:0x3C], "little")
    shnum = int.from_bytes(raw[0x3C:0x3E], "little")
    shstrndx = int.from_bytes(raw[0x3E:0x40], "little")

    def sec(i):
        h = raw[shoff + i * shentsize: shoff + (i + 1) * shentsize]
        return (int.from_bytes(h[0:4], "little"),
                int.from_bytes(h[0x18:0x20], "little"),
                int.from_bytes(h[0x20:0x28], "little"))
    _, stroff, _ = sec(shstrndx)
    for i in range(shnum):
        name, off, size = sec(i)
        end = raw.index(b"\0", stroff + name)
        if raw[stroff + name:end] == b".rodata":
            return off, off + size
    raise ValueError("no .rodata section")


class Lib:
    def __init__(self, raw: bytes):
        self.raw = raw
        self.lo, self.hi = _rodata(raw)

    def find(self, values, dtype) -> int:
        """The first offset in .rodata where `values` stand as `dtype`."""
        needle = np.asarray(values, dtype).tobytes()
        size = np.dtype(dtype).itemsize
        at = self.raw.find(needle, self.lo, self.hi)
        while at >= 0 and at % size:
            at = self.raw.find(needle, at + 1, self.hi)
        if at < 0:
            raise LookupError(f"head {list(values)[:8]} ({dtype}) not found")
        return at

    def read(self, at: int, n: int, dtype) -> np.ndarray:
        return np.frombuffer(self.raw, dtype, n, at).astype(np.int64)


# CDF tables: name, head (the first CDF's values as the specification
# lists them, without the final 32768), the library layout ("aom": each
# CDF of N symbols is N-1 values of 32768 - x, a 0 and a counter, in a
# slot of `slot` entries; "dav1d": N-1 values and a counter), the slot,
# the shape of the table and the symbols of each CDF (one number, or a
# list over the table's flattened CDFs).
_CDFS = (
    ("KF_Y_MODE", [15588, 17027, 19338], "aom", 14, (5, 5), 13),
    ("ANGLE_DELTA", [2180, 5032, 7567], "aom", 8, (8,), 7),
    ("UV_MODE", [22631, 24152, 25378], "aom", 15, (2, 13),
     [13] * 13 + [14] * 13),
    ("PARTITION", [19132, 25510, 30392], "aom", 11, (20,),
     [4] * 4 + [10] * 12 + [8] * 4),
    ("INTRA_TX_SET1", [1535, 8035, 9461], "aom", 17, (4, 13), 7),
    ("INTRA_TX_SET2", [6554, 13107, 19661, 26214], "aom", 17, (4, 13), 5),
    ("CFL_SIGN", [1418, 2123, 13340, 18405, 26972, 28343, 32294], "dav1d", 8,
     (), 8),
    ("CFL_ALPHA", [7637, 20719, 31401], "aom", 17, (6,), 16),
    ("TX_8X8", [19968, 19968, 24320], "aom", 4, (3,), 2),
    ("TX_SIZE", [12272, 30172], "aom", 4, (3, 3), 3),
    ("FILTER_INTRA", [4621, 6743, 5893], "aom", 3, (22,), 2),
    ("FILTER_INTRA_MODE", [8949, 12776, 17211, 29558], "dav1d", 5, (), 5),
    ("PALETTE_UV_SIZE", [8713, 19979, 27128], "aom", 8, (7,), 7),
    ("PALETTE_Y_SIZE", [7952, 13000, 18149], "aom", 8, (7,), 7),
    ("PALETTE_UV_COLOR", [29089, 16384, 8713], "aom", 9, (7, 5),
     [n for n in range(2, 9) for _ in range(5)]),
    ("PALETTE_Y_COLOR", [28710, 16384, 10553], "aom", 9, (7, 5),
     [n for n in range(2, 9) for _ in range(5)]),
    ("PALETTE_Y_MODE", [31676, 3419, 1261], "aom", 3, (7, 3), 2),
    ("PALETTE_UV_MODE", [32461, 21488], "dav1d", 2, (2,), 2),
    ("INTER_TX_SET1", [4458, 5560, 7695], "aom", 17, (4,), 16),
    ("TXFM_SPLIT", [28581, 23846, 20847], "aom", 3, (21,), 2),
    ("DELTA_LF_MULTI", [28160, 32120, 32677], "aom", 5, (4,), 4),
    ("SKIP", [31671, 16515, 4576], "dav1d", 2, (3,), 2),
    ("SEGMENT_ID", [5622, 7893, 16093, 18233], "dav1d", 8, (3,), 8),
    ("RESTORATION_TYPE", [9413, 22581], "dav1d", 3, (), 3),
    ("MV_JOINT", [4096, 11264, 19328], "aom", 5, (), 4),
    ("TXB_SKIP", [31849], "aom", 3, (4, 5, 13), 2),
    ("EOB_EXTRA", [16961, 17223, 7621], "aom", 3, (4, 5, 2, 9), 2),
    ("DC_SIGN", [128 * 125, 128 * 102, 128 * 147], "aom", 3, (4, 2, 3), 2),
    ("EOB_PT_16", [840, 1039, 1980, 4895], "aom", 6, (4, 2, 2), 5),
    ("EOB_PT_32", None, "aom", 7, (4, 2, 2), 6),
    ("EOB_PT_64", None, "aom", 8, (4, 2, 2), 7),
    ("EOB_PT_128", None, "aom", 9, (4, 2, 2), 8),
    ("EOB_PT_256", None, "aom", 10, (4, 2, 2), 9),
    ("EOB_PT_512", None, "aom", 11, (4, 2, 2), 10),
    ("EOB_PT_1024", None, "aom", 12, (4, 2, 2), 11),
    ("COEFF_BASE_EOB", None, "aom", 4, (4, 5, 2, 4), 3),
    ("COEFF_BASE", [4034, 8930, 12727], "aom", 5, (4, 5, 2, 42), 4),
    ("COEFF_BR", [14298, 20718, 24174], "aom", 5, (4, 5, 2, 21), 4),
)
# libaom keeps the end-of-block tables in .rodata from the largest down to
# 16 and the base-level table at the end of the first block right after
# them, so those without a head are read backwards from EOB_PT_16
_BEFORE = ("EOB_PT_32", "EOB_PT_64", "EOB_PT_128", "EOB_PT_256",
           "EOB_PT_512", "EOB_PT_1024")


def _pattern(head, layout, slot, nsym):
    """The head's values as the library stores them: the first CDF's
    values, or for a table of binary CDFs the first value of each of the
    first CDFs, with the slots' other entries (0) between them."""
    vals = [32768 - v for v in head]
    if (nsym[0] if isinstance(nsym, list) else nsym) != 2:
        return vals
    out = []
    for v in vals:
        out += [v] + [0] * (slot - 1)
    return out


def _read_cdfs(lib: Lib, at: int, layout, slot, shape, nsym):
    count = int(np.prod(shape)) if shape else 1
    syms = nsym if isinstance(nsym, list) else [nsym] * count
    raw = lib.read(at, count * slot, "<u2").reshape(count, slot)
    stride = max(syms) + 1
    out = np.zeros((count, stride), np.int64)
    for i, n in enumerate(syms):
        icdf = raw[i, :n - 1]
        vals = 32768 - icdf
        if not (np.all(np.diff(vals) >= 0) and np.all(vals > 0)
                and np.all(vals <= 32768)):
            raise ValueError(f"CDF {i} at {at + 2 * i * slot} is not a CDF: "
                             f"{vals.tolist()}")
        if layout == "aom" and raw[i, n - 1] != 0:
            raise ValueError(f"CDF {i} at {at} does not end where expected")
        out[i, :n - 1] = vals
        out[i, n - 1] = 32768
    return out.reshape(tuple(shape) + (stride,))


def cdf_tables(lib: Lib) -> dict:
    found = {}
    where = {}
    for name, head, layout, slot, shape, nsym in _CDFS:
        if head is None:
            continue
        at = lib.find(_pattern(head, layout, slot, nsym), "<u2")
        where[name] = at
        try:
            found[name] = _read_cdfs(lib, at, layout, slot, shape, nsym)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    spec = {c[0]: c for c in _CDFS}
    at = where["EOB_PT_16"]
    for name in _BEFORE:
        _, _, layout, slot, shape, nsym = spec[name]
        at -= int(np.prod(shape)) * slot * 2
        found[name] = _read_cdfs(lib, at, layout, slot, shape, nsym)
    _, _, layout, slot, shape, nsym = spec["COEFF_BASE_EOB"]
    at = where["EOB_PT_16"] + int(np.prod(spec["EOB_PT_16"][4])) * 6 * 2
    found["COEFF_BASE_EOB"] = _read_cdfs(lib, at, layout, slot, shape, nsym)
    if at + int(np.prod(shape)) * slot * 2 != where["COEFF_BASE"]:
        raise ValueError("the base-level tables are not where expected")
    # dav1d's CdfModeContext ends in pal_uv[2][2] and intrabc[2]; its
    # restore_switchable[4] is followed by restore_wiener[2] and
    # restore_sgrproj[2]
    found["INTRABC"] = _read_cdfs(lib, where["PALETTE_UV_MODE"] + 8,
                                  "dav1d", 2, (), 2)
    found["USE_WIENER"] = _read_cdfs(lib, where["RESTORATION_TYPE"] + 8,
                                     "dav1d", 2, (), 2)
    found["USE_SGRPROJ"] = _read_cdfs(lib, where["RESTORATION_TYPE"] + 12,
                                      "dav1d", 2, (), 2)
    # libaom's inter_ext_tx_cdf[4][4][17] holds sets 2 and 3 after set 1
    at = where["INTER_TX_SET1"] + 4 * 17 * 2
    found["INTER_TX_SET2"] = _read_cdfs(lib, at, "aom", 17, (4,), 12)
    found["INTER_TX_SET3"] = _read_cdfs(lib, at + 4 * 17 * 2, "aom", 17,
                                        (4,), 2)
    # the motion vector component CDFs follow the joint CDF (libaom's
    # nmv_context: classes, class0_fp[2], fp, sign, class0_hp, hp,
    # class0, bits[10], each in a slot of its size + 1)
    at = where["MV_JOINT"] + 5 * 2
    comps = []
    for _ in range(2):
        c = {}
        c["MV_CLASS"] = _read_cdfs(lib, at, "aom", 12, (), 11)
        at += 12 * 2 + 2 * 5 * 2 + 5 * 2
        c["MV_SIGN"] = _read_cdfs(lib, at, "aom", 3, (), 2)
        at += 3 * 3 * 2
        c["MV_CLASS0"] = _read_cdfs(lib, at, "aom", 3, (), 2)
        at += 3 * 2
        c["MV_BIT"] = _read_cdfs(lib, at, "aom", 3, (10,), 2)
        at += 10 * 3 * 2
        comps.append(c)
    for k in comps[0]:
        found[k] = np.stack([comps[0][k], comps[1][k]])
    return found


def other_tables(lib: Lib) -> dict:
    t = {}
    at = lib.find([4, 8, 8, 9, 10, 11, 12, 12], "<i2")
    t["DC_QLOOKUP"] = lib.read(at, 256, "<i2")
    at = lib.find([4, 8, 9, 10, 11, 12, 13, 14, 15, 16], "<i2")
    t["AC_QLOOKUP"] = lib.read(at, 256, "<i2")
    at = lib.find([255, 149, 85, 64, 255, 197, 146, 105], "u1")
    t["SM_WEIGHTS"] = lib.read(at, 4 + 8 + 16 + 32 + 64, "u1")
    at = lib.find([0, 0, 0, 1023, 0, 0, 547], "<u2")
    t["DR_INTRA_DERIVATIVE"] = lib.read(at, 90, "<u2")
    at = lib.find([-6, 10, 0, 0, 0, 12, 0, 0], "i1")
    t["FILTER_INTRA_TAPS"] = lib.read(at, 5 * 8 * 8, "i1").reshape(
        5, 8, 8)[:, :, :7]
    # libaom's sgr_params_type: radii r[2], then epsilons s[2]
    at = lib.find([2, 1, 140, 3236], "<i4")
    p = lib.read(at, 16 * 4, "<i4").reshape(16, 4)
    t["SGR_PARAMS"] = p[:, [0, 2, 1, 3]]
    t["QM"] = quantizer_matrices(lib)
    # dav1d's gaussian_sequence, the film grain's 2,048 draws
    at = lib.find([56, 568, -180, 172, 124, -84, 172, -64], "<i2")
    t["GAUSSIAN_SEQUENCE"] = lib.read(at, 2048, "<i2")
    return t


# libaom's transform sizes in its order (w, h), the offset of each size's
# weights in a level's 3,344 values, and the size whose weights a 64-point
# size takes (its top-left 32 x 32 quarter): every size but those five
# owns w * h values, stored column by column
QM_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
            (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32),
            (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
QM_LEVELS, QM_TOTAL = 15, 3344


def qm_offsets() -> list:
    out, at = [], 0
    for w, h in QM_SIZES:
        if max(w, h) == 64:
            out.append(out[QM_SIZES.index((min(w, 32), min(h, 32)))])
        else:
            out.append(at)
            at += w * h
    assert at == QM_TOTAL
    return out


def quantizer_matrices(lib: Lib) -> np.ndarray:
    """(15, 2, 3344): the dequantizer weights of levels 0-14 (level 15 is
    flat) for luma and chroma, libaom's iwt_matrix_ref. dav1d keeps the
    32x32 weights as a triangle and the 32x16 ones whole, and derives
    every other size from them by subsampling at init: the tool checks
    libaom's weights of every size against that derivation."""
    at = lib.find([32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150],
                  "u1")
    qm = lib.read(at, QM_LEVELS * 2 * QM_TOTAL, "u1").reshape(
        QM_LEVELS, 2, QM_TOTAL)
    offs = qm_offsets()
    m32 = qm[:, :, offs[3]:offs[3] + 1024].reshape(QM_LEVELS, 2, 32, 32)
    tri = [r * 32 + c for r in range(32) for c in range(r + 1)]
    at = lib.find(m32[0, 0].ravel()[tri[:12]], "u1")
    d32 = lib.read(at, QM_LEVELS * 2 * 528, "u1").reshape(QM_LEVELS, 2, 528)
    if not np.array_equal(m32.reshape(QM_LEVELS, 2, 1024)[:, :, tri], d32):
        raise ValueError("libaom's and dav1d's 32x32 weights differ")
    d16 = lib.read(at + d32.size, QM_LEVELS * 2 * 512, "u1").reshape(
        QM_LEVELS, 2, 16, 32)
    full = {(32, 32): m32, (16, 32): d16,
            (32, 16): d16.transpose(0, 1, 3, 2)}
    for t, (w, h) in enumerate(QM_SIZES):
        if max(w, h) == 64:
            continue
        # a size's weights [col][row], from dav1d's square or 2:1 table
        m = qm[:, :, offs[t]:offs[t] + w * h].reshape(QM_LEVELS, 2, w, h)
        src = full[(32, 32)] if w == h else full[
            (16, 32) if w < h else (32, 16)]
        sa, sb = src.shape[2] // w, src.shape[3] // h
        if not any(np.array_equal(src[:, :, a::sa, b::sb], m)
                   for a in range(sa) for b in range(sb)):
            raise ValueError(f"the {w}x{h} weights are not dav1d's")
    return qm


def _diag(w: int, h: int, zigzag: bool) -> list:
    """A diagonal scan of a w x h block (positions row * w + col): down
    and to the left along each anti-diagonal, or (zigzag) alternating,
    starting to the right; wide blocks run up and to the right."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if zigzag:
            if d % 2 == 0:
                cells.reverse()
        elif w > h:
            cells.reverse()
        out += [r * w + c for r, c in cells]
    return out


SCAN_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
              (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32),
              (32, 8))


def scans(lib: Lib) -> dict:
    t = {}
    for w, h in SCAN_SIZES:
        s = _diag(w, h, w == h)
        if w == h and w <= 16:
            lib.find(s, "<i2")  # libaom's copy, or LookupError
        t[f"SCAN_{w}X{h}"] = np.array(s)
    return t


GENERATED = {
    # the intra modes' nominal angles (DC .. PAETH)
    "MODE_TO_ANGLE": [0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0],
    # CDEF: (row, col) of the two taps along each direction
    "CDEF_DIRECTIONS": [[[-1, 1], [-2, 2]], [[0, 1], [-1, 2]],
                        [[0, 1], [0, 2]], [[0, 1], [1, 2]],
                        [[1, 1], [2, 2]], [[1, 0], [2, 1]],
                        [[1, 0], [2, 0]], [[1, 0], [2, -1]]],
    "CDEF_UV_DIR_422": [7, 0, 2, 4, 5, 6, 6, 6],
    "CDEF_PRI_TAPS": [[4, 2], [3, 3]],
    "CDEF_SEC_TAPS": [[2, 1], [2, 1]],
    "CDEF_DIV_TABLE": [0, 840, 420, 280, 210, 168, 140, 120, 105],
    "WIENER_TAPS_MID": [3, -7, 15],
    "SGRPROJ_XQD_MID": [-32, 31],
    "WIENER_TAPS_MIN": [-5, -23, -17],
    "WIENER_TAPS_MAX": [10, 8, 46],
    "SGRPROJ_XQD_MIN": [-96, -32],
    "SGRPROJ_XQD_MAX": [31, 95],
    "PALETTE_COLOR_CONTEXT": [-1, -1, 0, -1, -1, 4, 3, 2, 1],
    "PALETTE_COLOR_HASH_MULTIPLIERS": [1, 2, 2],
    "INTRA_EDGE_KERNEL": [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0],
                          [2, 4, 4, 4, 2]],
}


def _c(name: str, a, ctype: str) -> str:
    a = np.asarray(a)
    dims = "".join(f"[{d}]" for d in a.shape)

    def body(x, ind):
        if x.ndim == 1:
            items = [str(int(v)) for v in x]
            lines, line = [], ind
            for it in items:
                if len(line) + len(it) + 2 > 78:
                    lines.append(line.rstrip())
                    line = ind
                line += it + ", "
            lines.append(line.rstrip())
            return "{\n" + "\n".join(lines) + "\n" + ind[:-2] + "}"
        return "{" + ",".join(
            "\n" + ind + body(x[i], ind + "  ") for i in range(len(x))
        ) + "\n" + ind[:-2] + "}"
    return f"static const {ctype} AV1_{name}{dims} = " + body(a, "  ") + ";\n"


def header() -> str:
    lib = Lib(library())
    parts = ["// The AV1 constant tables of scene/csrc/av1.cpp, written by\n"
             "// tools/extract_av1_tables.py from the tables libaom and "
             "dav1d keep\n// (CDFs in the specification's form: cumulative"
             " values ending in\n// 32768, then a counter slot). Do not "
             "edit; run the tool.\n#pragma once\n#include <cstdint>\n\n"]
    for name, a in cdf_tables(lib).items():
        parts.append(_c(name + "_CDF", a, "uint16_t"))
    for name, a in other_tables(lib).items():
        ctype = ("int16_t" if name.endswith("QLOOKUP")
                 or name == "GAUSSIAN_SEQUENCE" else
                 "int8_t" if name == "FILTER_INTRA_TAPS" else
                 "uint8_t" if name == "QM" else "int32_t")
        parts.append(_c(name, a, ctype))
    for name, a in scans(lib).items():
        parts.append(_c(name, a, "int16_t"))
    for name, a in GENERATED.items():
        parts.append(_c(name, a, "int32_t"))
    parts.append(_c("QM_OFFSET", qm_offsets(), "int32_t"))
    return "\n".join(parts)


def main(argv) -> int:
    text = header()
    if "--check" in argv:
        with open(OUT) as f:
            same = f.read() == text
        print("same" if same else "differs")
        return 0 if same else 1
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT} ({len(text)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
