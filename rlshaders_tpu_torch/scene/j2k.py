"""JPEG 2000 codestream decoding (ITU-T T.800), as OpenJPEG 2.5 decodes it.

`decode_codestream` reads a J2K codestream, the one of a JP2 file too,
into its components' samples as OpenJPEG hands them to PIL: every quality
layer and every resolution, tile by tile, then each sample shifted by the
DC level and clamped to its precision.

* Markers, read and checked as OpenJPEG's header procedures read them:
  SIZ, COD, COC, QCD, QCC, POC, COM, TLM, PLM, PLT, CRG, SOT, SOD and
  EOC in the main header and the tile-part headers (an unknown marker in
  the main header is skipped word by word, as opj_j2k_read_unk does); a
  tile's parts are joined in order; EOC must end the codestream.
* Tier 2: packets in any of the five progression orders, or the
  progressions of POC markers, with precincts, tag trees for inclusion
  and zero bit-planes, pass counts, Lblock lengths and segments of 109
  passes over all quality layers. OpenJPEG's decoder is strict: a packet
  whose code-block data runs past its tile-part raises ValueError.
* Tier 1: every code-block through `j2k_t1.decode_blocks` (native).
* Dequantization (reversible, derived and expounded step sizes), the
  inverse 5/3 (integer) and 9/7 (float32, OpenJPEG's lifting steps and
  constants in its order of operations) wavelets, the inverse RCT and ICT
  of the first three components, and the DC level shift with
  round-half-to-even and the clamp.

What OpenJPEG reads and no encoder here writes raises NotImplementedError
naming it: code-block styles other than 0, PPM, PPT, RGN, SOP and EPH
markers, the markers of Parts 2 and 15, subsampled components, and
precisions other than 8 and 16 bits. Malformed data raises ValueError.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from .j2k_t1 import decode_blocks

SOC, SIZ, CAP, COD, COC, TLM, PLM, PLT, CPF = (
    0xFF4F, 0xFF51, 0xFF50, 0xFF52, 0xFF53, 0xFF55, 0xFF57, 0xFF58, 0xFF59)
QCD, QCC, RGN, POC, PPM, PPT, CRG, COM = (
    0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF60, 0xFF61, 0xFF63, 0xFF64)
MCT, MCC, MCO, CBD, SOT, SOP, SOD, EOC = (
    0xFF74, 0xFF75, 0xFF77, 0xFF78, 0xFF90, 0xFF91, 0xFF93, 0xFFD9)
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
MAX_PASSES = 109        # passes in a segment of code-block style 0
_REFUSED = {PPM: "packed packet headers (PPM)",
            PPT: "packed packet headers (PPT)",
            RGN: "regions of interest (RGN)"}
_PART2 = (CAP, CPF, CBD, MCT, MCC, MCO)
# the markers OpenJPEG has a reader for, and where each may stand: "siz"
# right after SOC, "m" the main header, "t" a tile-part header
_PLACES = {SIZ: "siz", SOT: "m", COD: "mt", COC: "mt", RGN: "mt",
           QCD: "mt", QCC: "mt", POC: "mt", TLM: "m", PLM: "m", PLT: "t",
           PPM: "m", PPT: "t", SOP: "", CRG: "m", COM: "mt", MCT: "mt",
           CBD: "m", CAP: "m", CPF: "m", MCC: "mt", MCO: "mt"}

# OpenJPEG's 9/7 lifting constants (dwt.c), float32
ALPHA = np.float32(-1.586134342)
BETA = np.float32(-0.052980118)
GAMMA = np.float32(0.882911075)
DELTA = np.float32(0.443506852)
K = np.float32(1.230174105)
C13318 = np.float32(1.625732422)      # the high-pass band's scale
# the ICT's (mct.c)
ICT_RV, ICT_GU, ICT_GV, ICT_BU = (np.float32(1.402), np.float32(0.34413),
                                  np.float32(0.71414), np.float32(1.772))


class Component(NamedTuple):
    prec: int
    sgnd: bool
    dx: int
    dy: int


class Siz(NamedTuple):
    """The SIZ marker: the reference grid, the tiles and the components."""
    x1: int
    y1: int
    x0: int
    y0: int
    tw: int
    th: int
    tx0: int
    ty0: int
    comps: tuple

    @property
    def tiles_x(self) -> int:
        return -(-(self.x1 - self.tx0) // self.tw)

    @property
    def tiles_y(self) -> int:
        return -(-(self.y1 - self.ty0) // self.th)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _ceil2(a: int, e: int) -> int:
    return -(-a >> e)


class _Reader:
    """Big-endian fields of a marker segment, which must hold them."""

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def take(self, fmt: str):
        size = struct.calcsize(">" + fmt)
        if self.pos + size > len(self.data):
            raise ValueError(f"JPEG 2000 {self.name} marker ends early")
        out = struct.unpack_from(">" + fmt, self.data, self.pos)
        self.pos += size
        return out if len(out) > 1 else out[0]

    def left(self) -> int:
        return len(self.data) - self.pos


def _siz(seg: bytes) -> Siz:
    r = _Reader(seg, "SIZ")
    _rsiz, x1, y1, x0, y0, tw, th, tx0, ty0, n = r.take("HIIIIIIIIH")
    if n == 0 or r.left() != 3 * n:
        raise ValueError("JPEG 2000 SIZ marker of the wrong size")
    if x0 >= x1 or y0 >= y1:
        raise ValueError("JPEG 2000 image of zero or negative size")
    if not tw or not th:
        raise ValueError("JPEG 2000 tile of zero size")
    if tx0 > x0 or ty0 > y0 or tx0 + tw <= x0 or ty0 + th <= y0:
        raise ValueError("JPEG 2000 tile offset outside the image")
    ntx, nty = -(-(x1 - tx0) // tw), -(-(y1 - ty0) // th)
    if ntx * nty > 65535:
        raise ValueError(f"JPEG 2000 image of {ntx} x {nty} tiles")
    comps = []
    for _ in range(n):
        ssiz, dx, dy = r.take("BBB")
        prec = (ssiz & 0x7F) + 1
        if not dx or not dy:
            raise ValueError("JPEG 2000 component subsampling of 0")
        if prec > 31:
            raise ValueError(f"JPEG 2000 component of {prec} bits")
        comps.append(Component(prec, bool(ssiz >> 7), dx, dy))
    return Siz(x1, y1, x0, y0, tw, th, tx0, ty0, tuple(comps))


class Coding(NamedTuple):
    """A component's coding style (COD, or COC for one component)."""
    precincts: bool
    nres: int
    cbw: int
    cbh: int
    cblksty: int
    qmfbid: int
    prec_sizes: tuple       # (ppx, ppy) per resolution


class Quant(NamedTuple):
    guard: int
    steps: tuple            # (expn, mant) per band


def _spcod(r: _Reader, precincts: bool) -> Coding:
    nl, cbw, cbh, sty, qmf = r.take("BBBBB")
    if nl > 32:
        raise ValueError(f"JPEG 2000 coding style of {nl} decompositions")
    cbw, cbh = cbw + 2, cbh + 2
    if cbw > 10 or cbh > 10 or cbw + cbh > 12:
        raise ValueError("JPEG 2000 code-block size out of range")
    if qmf > 1:
        raise ValueError(f"JPEG 2000 wavelet transform {qmf}")
    if precincts:
        sizes = []
        for j in range(nl + 1):
            b = r.take("B")
            if j and (not b & 0xF or not b >> 4):
                raise ValueError("JPEG 2000 precinct size of 1")
            sizes.append((b & 0xF, b >> 4))
    else:
        sizes = [(15, 15)] * (nl + 1)
    return Coding(precincts, nl + 1, cbw, cbh, sty, qmf, tuple(sizes))


def _cod(seg: bytes) -> tuple:
    """(Scod, progression, layers, mct, Coding)."""
    r = _Reader(seg, "COD")
    scod, prog, layers, mct = r.take("BBHB")
    if scod & ~7:
        raise ValueError(f"JPEG 2000 coding style {scod:#04x}")
    if prog > 4:
        raise ValueError(f"JPEG 2000 progression order {prog}")
    if not layers:
        raise ValueError("JPEG 2000 coding style of 0 layers")
    if mct > 1:
        raise ValueError(f"JPEG 2000 component transform {mct}")
    coding = _spcod(r, bool(scod & 1))
    if r.left():
        raise ValueError("JPEG 2000 COD marker of the wrong size")
    return scod, prog, layers, mct, coding


def _comp_index(r: _Reader, n: int) -> int:
    c = r.take("B" if n < 257 else "H")
    if c >= n:
        raise ValueError(f"JPEG 2000 marker for component {c} of {n}")
    return c


def _coc(seg: bytes, n: int) -> tuple:
    r = _Reader(seg, "COC")
    c = _comp_index(r, n)
    coding = _spcod(r, bool(r.take("B") & 1))
    if r.left():
        raise ValueError("JPEG 2000 COC marker of the wrong size")
    return c, coding


def _sqcd(r: _Reader) -> Quant:
    """Sqcd and its step sizes, as opj_j2k_read_SQcd_SQcc reads them: one
    byte a band without quantization (style 0), one 2-byte step for the
    derived style (1), 2 bytes a band for any other style."""
    b = r.take("B")
    style, guard = b & 0x1F, b >> 5
    if style == 0:
        steps = [(r.take("B") >> 3, 0) for _ in range(r.left())]
    else:
        count = 1 if style == 1 else r.left() // 2
        steps = [(v >> 11, v & 0x7FF) for v in
                 (r.take("H") for _ in range(count))]
        if style == 1:
            e0, m0 = steps[0]
            steps = [(e0, m0)] + [(max(e0 - (b - 1) // 3, 0), m0)
                                  for b in range(1, 97)]
    if r.left():
        raise ValueError("JPEG 2000 quantization marker of the wrong size")
    steps = steps[:97] + [(0, 0)] * max(0, 97 - len(steps))
    return Quant(guard, tuple(steps))


def _qcc(seg: bytes, n: int) -> tuple:
    r = _Reader(seg, "QCC")
    c = _comp_index(r, n)
    return c, _sqcd(r)


class _Params:
    """The coding parameters of the main header or of a tile."""

    def __init__(self, n: int):
        self.scod = self.prog = self.layers = self.mct = None
        self.pocs = []
        self.coding = [None] * n
        self.quant = [None] * n
        self.coc = [False] * n
        self.qcc = [False] * n

    def copy(self) -> "_Params":
        p = _Params(len(self.coding))
        p.scod, p.prog, p.layers, p.mct = (self.scod, self.prog,
                                           self.layers, self.mct)
        p.coding, p.quant = list(self.coding), list(self.quant)
        p.pocs = list(self.pocs)
        return p

    def read(self, marker: int, seg: bytes, n: int) -> None:
        if marker == COD:
            self.scod, self.prog, self.layers, self.mct, coding = _cod(seg)
            for c in range(n):
                if not self.coc[c]:
                    self.coding[c] = coding
        elif marker == COC:
            c, coding = _coc(seg, n)
            self.coding[c], self.coc[c] = coding, True
        elif marker == QCD:
            r = _Reader(seg, "QCD")
            quant = _sqcd(r)
            for c in range(n):
                if not self.qcc[c]:
                    self.quant[c] = quant
        elif marker == QCC:
            c, quant = _qcc(seg, n)
            self.quant[c], self.qcc[c] = quant, True
        elif marker == POC:
            self.pocs += _poc(seg, n)


def _u16(data: bytes, pos: int, what: str) -> int:
    if pos + 2 > len(data):
        raise ValueError(f"JPEG 2000 codestream ends in {what}")
    return struct.unpack_from(">H", data, pos)[0]


def _scan_unknown(data: bytes, pos: int, state: str) -> int:
    """OpenJPEG's opj_j2k_read_unk after an unknown marker in the main
    header: on over 2-byte words to the next marker it has a reader for,
    which must be allowed in `state`."""
    while True:
        word = _u16(data, pos, "a header")
        if word >= 0xFF00 and word in _PLACES:
            if state not in _PLACES[word]:
                raise ValueError(f"JPEG 2000 marker {word:#06x} out of place")
            return pos
        pos += 2


def _segment(data: bytes, pos: int, end: int) -> tuple:
    """(the segment of the marker at pos, the position after it)."""
    length = _u16(data, pos + 2, "a marker")
    if length < 2:
        raise ValueError("JPEG 2000 marker segment shorter than 2 bytes")
    if pos + 2 + length > end:
        raise ValueError(f"JPEG 2000 marker {_u16(data, pos, 'a marker'):#06x}"
                         f" runs past its header")
    return data[pos + 4:pos + 2 + length], pos + 2 + length


def _other(marker: int, seg: bytes, n: int) -> None:
    """The markers read only to refuse or check them."""
    if marker in _REFUSED:
        raise NotImplementedError(f"JPEG 2000 {_REFUSED[marker]} are not "
                                  f"decoded by the port")
    if marker in _PART2:
        raise NotImplementedError(f"JPEG 2000 marker {marker:#06x} (Part 2 "
                                  f"or 15) is not decoded by the port")
    if marker == TLM:
        if len(seg) < 2 or (seg[1] >> 4) & 3 == 3:
            raise ValueError("JPEG 2000 TLM marker of a wrong size")
        step = ((seg[1] >> 6) & 1) * 2 + 2 + ((seg[1] >> 4) & 3)
        if (len(seg) - 2) % step:
            raise ValueError("JPEG 2000 TLM marker of a wrong size")
    elif marker == PLT:
        if not seg:
            raise ValueError("JPEG 2000 PLT marker of a wrong size")
        length = 0
        for b in seg[1:]:
            length |= b & 0x7F
            length = length << 7 if b & 0x80 else 0
        if length:
            raise ValueError("JPEG 2000 PLT marker ends inside a length")
    elif marker == PLM:
        if not seg:
            raise ValueError("JPEG 2000 PLM marker of a wrong size")
    elif marker == CRG:
        if len(seg) != 4 * n:
            raise ValueError("JPEG 2000 CRG marker of a wrong size")


class Header(NamedTuple):
    siz: Siz
    params: _Params
    first_sot: int


def read_header(data: bytes) -> Header:
    """The main header of a codestream: SIZ and the default coding
    parameters, read and checked as OpenJPEG's header procedure does."""
    if _u16(data, 0, "SOC") != SOC:
        raise ValueError("not a JPEG 2000 codestream")
    siz = params = None
    state, pos, seen = "siz", 2, set()
    while True:
        marker = _u16(data, pos, "the main header")
        if marker == SOT:
            break
        if marker < 0xFF00:
            raise ValueError(f"JPEG 2000 marker expected, {marker:#06x} "
                             f"found")
        if marker not in _PLACES:
            pos = _scan_unknown(data, pos + 2, state)
            marker = _u16(data, pos, "the main header")
            if marker == SOT:
                break
        if state not in _PLACES[marker]:
            raise ValueError(f"JPEG 2000 marker {marker:#06x} out of place")
        seg, pos = _segment(data, pos, len(data))
        seen.add(marker)
        if marker == SIZ:
            siz = _siz(seg)
            params = _Params(len(siz.comps))
            state = "m"
        elif marker in (COD, COC, QCD, QCC, POC):
            params.read(marker, seg, len(siz.comps))
        else:
            _other(marker, seg, len(siz.comps))
    for need in (SIZ, COD, QCD):
        if need not in seen:
            raise ValueError(f"JPEG 2000 main header without marker "
                             f"{need:#06x}")
    for comp in siz.comps:
        if comp.dx != 1 or comp.dy != 1:
            raise NotImplementedError("JPEG 2000 subsampled components are "
                                      "not decoded by the port")
        if comp.prec not in (8, 16):
            raise NotImplementedError(f"JPEG 2000 components of "
                                      f"{comp.prec} bits are not decoded by "
                                      f"the port (8 and 16 only)")
    return Header(siz, params, pos)


def _tile_parts(data: bytes, head: Header) -> dict:
    """{tile index: (its _Params, its tile-parts' data)} for every tile in
    the codestream, reading tile-parts from the first SOT to EOC as
    OpenJPEG's opj_j2k_read_tile_header checks them."""
    siz, n = head.siz, len(head.siz.comps)
    ntiles = siz.tiles_x * siz.tiles_y
    tiles, parts, nparts = {}, {}, {}
    pos = head.first_sot
    while True:
        marker = _u16(data, pos, "its tile-parts (no EOC)")
        if marker == EOC:
            break
        if marker != SOT:
            raise ValueError(f"JPEG 2000 SOT expected, {marker:#06x} found")
        if _u16(data, pos + 2, "SOT") != 10 or pos + 12 > len(data):
            raise ValueError("JPEG 2000 SOT marker of the wrong size")
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", data, pos + 4)
        if isot >= ntiles:
            raise ValueError(f"JPEG 2000 tile {isot} of {ntiles}")
        if psot and psot < 14:
            raise ValueError(f"JPEG 2000 tile-part of {psot} bytes")
        if tpsot != parts.get(isot, 0):
            raise ValueError(f"JPEG 2000 tile {isot}'s part {tpsot} out of "
                             f"order")
        if tnsot:
            if isot in nparts and tpsot >= nparts[isot] or tpsot >= tnsot:
                raise ValueError(f"JPEG 2000 tile {isot}'s part {tpsot} of "
                                 f"{tnsot}")
            nparts[isot] = tnsot
        parts[isot] = tpsot + 1
        end = len(data) - 2 if psot == 0 else pos + psot
        if isot not in tiles:
            tiles[isot] = (head.params.copy(), [])
        params, chunks = tiles[isot]
        at = pos + 12
        while True:
            marker = _u16(data, at, "a tile-part header")
            if marker == SOD:
                break
            if marker not in _PLACES or "t" not in _PLACES[marker]:
                raise ValueError(f"JPEG 2000 marker {marker:#06x} in a "
                                 f"tile-part header")
            seg, at = _segment(data, at, end)
            if marker == POC:
                params.read(marker, seg, n)     # after the main header's
            elif marker in (COD, COC, QCD, QCC):
                if tpsot:
                    raise ValueError("JPEG 2000 coding parameters in a later "
                                     "tile-part")
                params.read(marker, seg, n)
            else:
                _other(marker, seg, n)
        if end > len(data):
            raise ValueError("JPEG 2000 tile-part runs past the codestream")
        chunks.append(data[at + 2:end])
        pos = end
    return tiles


class _Band(NamedTuple):
    bandno: int
    x0: int
    y0: int
    x1: int
    y1: int
    numbps: int
    stepsize: np.float32


def _band(c: Component, coding: Coding, quant: Quant, rect: tuple,
          r: int, bandno: int) -> _Band:
    tcx0, tcy0, tcx1, tcy1 = rect
    lvl = coding.nres - 1 - r
    if r == 0:
        box = (_ceil2(tcx0, lvl), _ceil2(tcy0, lvl), _ceil2(tcx1, lvl),
               _ceil2(tcy1, lvl))
    else:
        xb, yb = bandno & 1, bandno >> 1
        box = (_ceil2(tcx0 - (xb << lvl), lvl + 1),
               _ceil2(tcy0 - (yb << lvl), lvl + 1),
               _ceil2(tcx1 - (xb << lvl), lvl + 1),
               _ceil2(tcy1 - (yb << lvl), lvl + 1))
    expn, mant = quant.steps[0 if r == 0 else 3 * (r - 1) + bandno]
    gain = 0 if coding.qmfbid == 0 else (0, 1, 1, 2)[bandno]
    step = np.float32((1.0 + mant / 2048.0) * 2.0 ** (c.prec + gain - expn))
    return _Band(bandno, *box, expn + quant.guard - 1, step)


class _Block:
    """A code-block's tier-2 state: its segments, each [passes, chunks]."""
    __slots__ = ("x0", "y0", "x1", "y1", "included", "numbps", "lenbits",
                 "segs")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.included, self.numbps, self.lenbits = False, 0, 3
        self.segs = []


class _TagTree:
    """OpenJPEG's tag tree decoder over a w x h grid of leaves."""

    def __init__(self, w: int, h: int):
        parents, sizes = [], [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            pw, ph = sizes[-1]
            sizes.append(((pw + 1) // 2, (ph + 1) // 2))
        base = [0]
        for sw, sh in sizes:
            base.append(base[-1] + sw * sh)
        parents = [-1] * base[-1]
        for lvl in range(len(sizes) - 1):
            sw, sh = sizes[lvl]
            pw = sizes[lvl + 1][0]
            for j in range(sh):
                for i in range(sw):
                    parents[base[lvl] + j * sw + i] = (
                        base[lvl + 1] + (j // 2) * pw + i // 2)
        self.parent = parents
        self.value = [999] * base[-1]
        self.low = [0] * base[-1]

    def decode(self, bits: "_Bits", leaf: int, threshold: int) -> bool:
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return self.value[node] < threshold


class _Bits:
    """OpenJPEG's packet-header bit reader: after an 0xFF byte the next
    byte gives 7 bits; past its end it reads 0s."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.start, self.pos, self.end = data, pos, pos, end
        self.buf, self.ct = 0, 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v = (v << 1) | ((self.buf >> self.ct) & 1)
        return v

    def align(self) -> int:
        """Bytes the header took, as opj_bio_inalign leaves them."""
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0
        return self.pos - self.start


def _passes(bits: _Bits) -> int:
    if not bits.read(1):
        return 1
    if not bits.read(1):
        return 2
    n = bits.read(2)
    if n != 3:
        return 3 + n
    n = bits.read(5)
    if n != 31:
        return 6 + n
    return 37 + bits.read(7)


class _Resolution:
    def __init__(self, c: Component, coding: Coding, quant: Quant,
                 rect: tuple, r: int):
        lvl = coding.nres - 1 - r
        tcx0, tcy0, tcx1, tcy1 = rect
        self.x0, self.y0 = _ceil2(tcx0, lvl), _ceil2(tcy0, lvl)
        self.x1, self.y1 = _ceil2(tcx1, lvl), _ceil2(tcy1, lvl)
        ppx, ppy = coding.prec_sizes[r]
        self.ppx, self.ppy = ppx, ppy
        px0, py0 = (self.x0 >> ppx) << ppx, (self.y0 >> ppy) << ppy
        px1, py1 = _ceil2(self.x1, ppx) << ppx, _ceil2(self.y1, ppy) << ppy
        self.pw = 0 if self.x0 == self.x1 else (px1 - px0) >> ppx
        self.ph = 0 if self.y0 == self.y1 else (py1 - py0) >> ppy
        if r == 0:
            gx, gy, gw, gh = px0, py0, ppx, ppy
        else:
            gx, gy, gw, gh = _ceil2(px0, 1), _ceil2(py0, 1), ppx - 1, ppy - 1
        cbw, cbh = min(coding.cbw, gw), min(coding.cbh, gh)
        self.bands = []
        for bandno in ((0,) if r == 0 else (1, 2, 3)):
            band = _band(c, coding, quant, rect, r, bandno)
            precincts = []
            empty = band.x0 == band.x1 or band.y0 == band.y1
            for p in range(self.pw * self.ph):
                sx = gx + (p % self.pw) * (1 << gw)
                sy = gy + (p // self.pw) * (1 << gh)
                x0, y0 = max(sx, band.x0), max(sy, band.y0)
                x1, y1 = min(sx + (1 << gw), band.x1), min(sy + (1 << gh),
                                                           band.y1)
                bx0, by0 = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                cw = max(0, ((_ceil2(x1, cbw) << cbw) - bx0) >> cbw)
                ch = max(0, ((_ceil2(y1, cbh) << cbh) - by0) >> cbh)
                if empty:
                    cw = ch = 0
                blocks = []
                for k in range(cw * ch):
                    bx = bx0 + (k % cw) * (1 << cbw)
                    by = by0 + (k // cw) * (1 << cbh)
                    blocks.append(_Block(max(bx, x0), max(by, y0),
                                         min(bx + (1 << cbw), x1),
                                         min(by + (1 << cbh), y1)))
                trees = (_TagTree(cw, ch), _TagTree(cw, ch)) if blocks \
                    else (None, None)
                precincts.append((blocks, trees))
            self.bands.append((band, precincts, empty))


class Poc(NamedTuple):
    """One progression of a tile: its order and the packets it covers
    (resolutions r0..r1, components c0..c1, layers 0..l1, ends open)."""
    prog: int
    r0: int
    c0: int
    l1: int
    r1: int
    c1: int


def _poc(seg: bytes, n: int) -> list:
    """The progressions of a POC marker, as opj_j2k_read_poc reads them."""
    size = 7 if n <= 256 else 9
    if not seg or len(seg) % size:
        raise ValueError("JPEG 2000 POC marker of the wrong size")
    fmt = ">BBHBBB" if n <= 256 else ">BHHBHB"
    out = []
    for i in range(0, len(seg), size):
        r0, c0, l1, r1, c1, prog = struct.unpack_from(fmt, seg, i)
        out.append(Poc(prog, r0, c0, l1, r1, min(c1, n)))
    return out


def _order(params: "_Params", comps: list, rect: tuple):
    """(layer, resolution, component, precinct) of every packet of a tile,
    as OpenJPEG's packet iterators (pi.c) give them: one iterator for each
    progression (the coding style's, or each of POC's), skipping packets
    an earlier one gave."""
    ncomp = len(comps)
    maxres = max(len(res) for res in comps)
    pocs = params.pocs or [Poc(params.prog, 0, 0, params.layers, maxres,
                               ncomp)]
    seen = set()
    for poc in pocs:
        if poc.c0 >= ncomp:
            raise ValueError("JPEG 2000 progression of a component past the "
                             "last")
        if poc.prog >= len(PROGRESSIONS):
            continue                    # OpenJPEG iterates no packet
        bounds = poc._replace(l1=min(poc.l1, params.layers))
        for key in _progression(bounds, comps, rect):
            if key not in seen:
                seen.add(key)
                yield key


def _progression(poc: Poc, comps: list, rect: tuple):
    """The packets of one progression, repeats included."""
    tx0, ty0, tx1, ty1 = rect
    layers = range(poc.l1)
    name = PROGRESSIONS[poc.prog]
    if name in ("LRCP", "RLCP"):
        outer = ((l, r) for l in layers for r in range(poc.r0, poc.r1)) \
            if name == "LRCP" else \
            ((l, r) for r in range(poc.r0, poc.r1) for l in layers)
        for l, r in outer:
            for c in range(poc.c0, poc.c1):
                if r >= len(comps[c]):
                    continue
                res = comps[c][r]
                for p in range(res.pw * res.ph):
                    yield l, r, c, p
        return

    def steps(cs):
        dx = dy = 0
        for c in cs:
            nres = len(comps[c])
            for r, res in enumerate(comps[c]):
                sx = 1 << (res.ppx + nres - 1 - r)
                sy = 1 << (res.ppy + nres - 1 - r)
                dx = sx if not dx else min(dx, sx)
                dy = sy if not dy else min(dy, sy)
        return dx, dy

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    def precinct(c, r, x, y):
        nres = len(comps[c])
        if r >= nres:
            return None
        res = comps[c][r]
        lvl = nres - 1 - r
        trx0, try0 = _ceil(tx0, 1 << lvl), _ceil(ty0, 1 << lvl)
        trx1, try1 = _ceil(tx1, 1 << lvl), _ceil(ty1, 1 << lvl)
        rpx, rpy = res.ppx + lvl, res.ppy + lvl
        if not (y % (1 << rpy) == 0 or (y == ty0 and (try0 << lvl)
                                        % (1 << rpy))):
            return None
        if not (x % (1 << rpx) == 0 or (x == tx0 and (trx0 << lvl)
                                        % (1 << rpx))):
            return None
        if not res.pw or not res.ph or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceil(x, 1 << lvl) >> res.ppx) - (trx0 >> res.ppx)
        prcj = (_ceil(y, 1 << lvl) >> res.ppy) - (try0 >> res.ppy)
        return prci + prcj * res.pw

    cs = range(poc.c0, poc.c1)
    if name == "RPCL":
        dx, dy = steps(range(len(comps)))
        for r in range(poc.r0, poc.r1):
            for x, y in positions(dx, dy):
                for c in cs:
                    p = precinct(c, r, x, y)
                    if p is not None:
                        yield from ((l, r, c, p) for l in layers)
    elif name == "PCRL":
        dx, dy = steps(range(len(comps)))
        for x, y in positions(dx, dy):
            for c in cs:
                for r in range(poc.r0, min(poc.r1, len(comps[c]))):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        yield from ((l, r, c, p) for l in layers)
    else:                                               # CPRL
        for c in cs:
            dx, dy = steps((c,))
            for x, y in positions(dx, dy):
                for r in range(poc.r0, min(poc.r1, len(comps[c]))):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        yield from ((l, r, c, p) for l in layers)


def _packet(data: bytes, pos: int, end: int, res: _Resolution, p: int,
            layer: int) -> int:
    """Read one packet at pos (its header, then its code-blocks' bytes);
    returns the position after it."""
    bits = _Bits(data, pos, end)
    if not bits.read(1):
        return pos + bits.align()
    got = []
    for band, precincts, empty in res.bands:
        if empty:
            continue
        blocks, (incl, imsb) = precincts[p]
        for k, blk in enumerate(blocks):
            if not blk.included:
                inc = incl.decode(bits, k, layer + 1)
            else:
                inc = bits.read(1)
            if not inc:
                continue
            if not blk.included:
                i = 0
                while not imsb.decode(bits, k, i):
                    i += 1
                blk.numbps = band.numbps + 1 - i
                blk.lenbits = 3
                blk.included = True
            new = _passes(bits)
            while bits.read(1):
                blk.lenbits += 1
            # the passes fill the last segment up to MAX_PASSES, then new
            # ones, each with its own length
            if not blk.segs or blk.segs[-1][0] == MAX_PASSES:
                blk.segs.append([0, []])
            seg, room = len(blk.segs) - 1, MAX_PASSES - blk.segs[-1][0]
            while new > 0:
                take = min(room, new)
                nbits = blk.lenbits + take.bit_length() - 1
                if nbits > 32:
                    raise ValueError("JPEG 2000 code-block length of more "
                                     "than 32 bits")
                got.append((blk, seg, take, bits.read(nbits)))
                new, seg, room = new - take, seg + 1, MAX_PASSES
    pos += bits.align()
    for blk, seg, take, length in got:
        if pos + length > end:
            raise ValueError("JPEG 2000 code-block data runs past its "
                             "tile-part")
        if seg == len(blk.segs):
            blk.segs.append([0, []])
        blk.segs[seg][0] += take
        blk.segs[seg][1].append(data[pos:pos + length])
        pos += length
    return pos


def _lift(x: np.ndarray, cas: int, steps) -> np.ndarray:
    """Lifting steps along axis 0 of an interleaved array whose first
    sample has parity `cas` (0: a low-pass sample). Each step (parity,
    update) sets every sample of that parity to update(sample, left +
    right) of its neighbours, mirrored at the ends (symmetric
    extension)."""
    n = x.shape[0]
    ext = np.empty((n + 2,) + x.shape[1:], x.dtype)
    ext[1:n + 1] = x
    for parity, update in steps:
        ext[0], ext[n + 1] = ext[2], ext[n - 1]
        first = cas if parity == 0 else 1 - cas
        k = len(range(first, n, 2))
        mid = ext[first + 1:first + 1 + 2 * k:2]
        mid[...] = update(mid, ext[first:first + 2 * k:2]
                          + ext[first + 2:first + 2 + 2 * k:2])
    return ext[1:n + 1]


def _lift53(x: np.ndarray, cas: int) -> np.ndarray:
    """The inverse 5/3 lifting along axis 0, in integers."""
    if x.shape[0] == 1:
        return (x + (x < 0)) >> 1 if cas else x  # C's division by 2
    return _lift(x, cas, ((0, lambda v, s: v - ((s + 2) >> 2)),
                          (1, lambda v, s: v + (s >> 1))))


def _lift97(x: np.ndarray, cas: int) -> np.ndarray:
    """The inverse 9/7 lifting along axis 0, in float32, as OpenJPEG's
    opj_v8dwt_decode: scale, then four steps of w += (l + r) * c."""
    if x.shape[0] == 1:
        return x
    x = x.copy()
    x[cas::2] *= K
    x[1 - cas::2] *= C13318
    return _lift(x, cas, tuple((parity, lambda v, s, c=c: v + s * c)
                               for parity, c in ((0, -DELTA), (1, -GAMMA),
                                                 (0, -BETA), (1, -ALPHA))))


def _interleave(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Samples stored low half first (sn of them) then high, put in their
    places along axis 0."""
    out = np.empty_like(a)
    out[cas::2] = a[:sn]
    out[1 - cas::2] = a[sn:]
    return out


def _idwt(coef: np.ndarray, res: list, qmfbid: int) -> np.ndarray:
    """The inverse wavelet of a tile-component, level by level: rows, then
    columns."""
    lift = _lift53 if qmfbid == 1 else _lift97
    for r in range(1, len(res)):
        lo, hi = res[r - 1], res[r]
        w, h = hi.x1 - hi.x0, hi.y1 - hi.y0
        sw, sh = lo.x1 - lo.x0, lo.y1 - lo.y0
        if not w or not h:
            continue
        cx, cy = hi.x0 % 2, hi.y0 % 2
        part = lift(_interleave(coef[:h, :w].T, sw, cx), cx).T
        coef[:h, :w] = lift(_interleave(part, sh, cy), cy)
    return coef


def _decode_tile(siz: Siz, index: int, params: _Params,
                 data: bytes) -> tuple:
    """((x0, y0, x1, y1) of the tile, its components' int32 samples)."""
    p, q = index % siz.tiles_x, index // siz.tiles_x
    rect = (max(siz.tx0 + p * siz.tw, siz.x0),
            max(siz.ty0 + q * siz.th, siz.y0),
            min(siz.tx0 + (p + 1) * siz.tw, siz.x1),
            min(siz.ty0 + (q + 1) * siz.th, siz.y1))
    if params.scod & 6:
        raise NotImplementedError("JPEG 2000 SOP and EPH markers are not "
                                  "decoded by the port")
    comps = []
    for c, comp in enumerate(siz.comps):
        coding = params.coding[c]
        if coding.cblksty:
            raise NotImplementedError(
                f"JPEG 2000 code-block style {coding.cblksty:#04x} is not "
                f"decoded by the port (style 0 only)")
        comps.append([_Resolution(comp, coding, params.quant[c], rect, r)
                      for r in range(coding.nres)])
    pos, end = 0, len(data)
    for layer, r, c, prec in _order(params, comps, rect):
        pos = _packet(data, pos, end, comps[c][r], prec, layer)
    return rect, _reconstruct(siz, params, comps, rect)


def _reconstruct(siz: Siz, params: _Params, comps: list,
                 rect: tuple) -> list:
    """Tier 1, dequantization, the wavelet, the component transform and
    the DC level shift of a tile whose packets are read."""
    w, h = rect[2] - rect[0], rect[3] - rect[1]
    table, chunks, places, at, size = [], [], [], 0, 0
    for c, res in enumerate(comps):
        for r, level in enumerate(res):
            for band, precincts, _ in level.bands:
                for blocks, _ in precincts:
                    for blk in blocks:
                        bw, bh = blk.x1 - blk.x0, blk.y1 - blk.y0
                        if bw <= 0 or bh <= 0:
                            continue
                        if blk.numbps >= 31:
                            raise ValueError("JPEG 2000 code-block of more "
                                             "than 30 bit-planes")
                        # tier 1 ends within the first segment
                        passes, pieces = blk.segs[0] if blk.segs else (0, [])
                        body = b"".join(pieces)
                        table.append((at, len(body), bw, bh, band.bandno,
                                      blk.numbps, passes, size))
                        chunks.append(body)
                        places.append((c, r, band, blk, size))
                        at += len(body)
                        size += bw * bh
    flat = decode_blocks(b"".join(chunks), np.array(table, np.int64), size) \
        if table else np.zeros(0, np.int32)
    out = [np.zeros((h, w), np.int32 if params.coding[c].qmfbid else
                    np.float32) for c in range(len(comps))]
    for c, r, band, blk, start in places:
        coding = params.coding[c]
        bw, bh = blk.x1 - blk.x0, blk.y1 - blk.y0
        v = flat[start:start + bw * bh].reshape(bh, bw)
        if coding.qmfbid == 1:
            v = (v + (v < 0)) >> 1              # C's division by 2
        else:
            v = v.astype(np.float32) * (np.float32(0.5) * band.stepsize)
        x, y = blk.x0 - band.x0, blk.y0 - band.y0
        if band.bandno & 1:
            lower = comps[c][r - 1]
            x += lower.x1 - lower.x0
        if band.bandno & 2:
            lower = comps[c][r - 1]
            y += lower.y1 - lower.y0
        out[c][y:y + bh, x:x + bw] = v
    for c, res in enumerate(comps):
        out[c] = _idwt(out[c], res, params.coding[c].qmfbid)
    if params.mct and len(out) >= 3:
        kinds = {params.coding[c].qmfbid for c in range(3)}
        if len(kinds) != 1:
            raise NotImplementedError("JPEG 2000 component transform over "
                                      "mixed wavelets is not decoded by the "
                                      "port")
        out[:3] = _rct(*out[:3]) if kinds == {1} else _ict(*out[:3])
    for c, comp in enumerate(siz.comps):
        shift = 0 if comp.sgnd else 1 << (comp.prec - 1)
        lo, hi = ((-(1 << (comp.prec - 1)), (1 << (comp.prec - 1)) - 1)
                  if comp.sgnd else (0, (1 << comp.prec) - 1))
        v = out[c]
        if v.dtype == np.float32:
            v = np.rint(np.clip(v, -2.0 ** 31, 2.0 ** 31)).astype(np.int64)
        out[c] = np.clip(v.astype(np.int64) + shift, lo, hi).astype(np.int32)
    return out


def _rct(y, u, v):
    g = y - ((u + v) >> 2)
    return [v + g, g, u + g]


def _ict(y, u, v):
    r = y + v * ICT_RV
    g = y - u * ICT_GU - v * ICT_GV
    b = y + u * ICT_BU
    return [r, g, b]


class Image(NamedTuple):
    """A decoded codestream: its SIZ and its components' samples over the
    image area ((height, width) int32 each; tiles not in the codestream
    stay 0)."""
    siz: Siz
    planes: list


def decode_codestream(data: bytes) -> Image:
    head = read_header(data)
    siz = head.siz
    w, h = siz.x1 - siz.x0, siz.y1 - siz.y0
    planes = [np.zeros((h, w), np.int32) for _ in siz.comps]
    for index, (params, chunks) in _tile_parts(data, head).items():
        rect, comps = _decode_tile(siz, index, params, b"".join(chunks))
        x0, y0, x1, y1 = rect
        for plane, comp in zip(planes, comps):
            plane[y0 - siz.y0:y1 - siz.y0, x0 - siz.x0:x1 - siz.x0] = comp
    return Image(siz, planes)
