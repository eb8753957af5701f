"""AVIF files, equal to PIL's decode.

The JAX package decodes textures with `Image.open(path).convert("RGB")`.
PIL 12.1 opens an AVIF file through libavif 1.3 (which has dav1d decode
its AV1 payload): a file whose `ftyp` major brand is avif, avis, mif1 or
msf1 goes to the AVIF plugin, and a file libavif then refuses while it
parses the container (wrong brands, broken boxes, a truncated file) is a
SyntaxError to PIL, which moves on to its next plugin. `accept` is that
test. `decode_avif` returns the bytes of `convert("RGB")`:

* the container (ISOBMFF/HEIF): `ftyp`, `meta` with `hdlr` pict, `pitm`,
  `iinf`/`infe`, `iloc` (versions 0-2, construction methods 0 and 1 with
  `idat`), `iref` (`auxl`, `prem`) and `iprp` (`ipco`, `ipma`, with the
  essential flags); the properties `av1C`, `ispe`, `pixi`, `colr` (nclx
  and ICC) and `auxC` (the alpha URN), and `irot`, `imir` and `clap`,
  which libavif checks and Pillow applies to no pixel;
* the primary item's AV1 frame, decoded by av1.py, and the alpha item's,
  which is always decoded (a broken alpha fails the file); a primary
  grid item (the `grid` box; its tiles from `iref`/`dimg`, in order,
  with libavif's checks of the tiles) stitched and cropped, as is an
  alpha grid;
* a frame whose AV1 size is not its item's ispe (or its track header's)
  size, each plane scaled to it as libavif scales it (libyuv's box
  filter, scene/yuvscale.py), in stills, grid tiles and sequences;
* an image sequence's first frame where libavif takes the tracks (a
  major brand of avis): the `moov` box (trak, tkhd, tref, edts,
  mdia, mdhd, hdlr, minf, stbl with stsd, stsc, stsz, stco or co64, stss
  and stts, checked as libavif checks them), the colour track and its
  alpha track (`tref`/`auxl`), the first sample of each;
* libavif's YUV to RGB: the matrix coefficients from `colr`, else from
  the sequence header (identity, BT.601, BT.709, BT.2020 NCL, YCgCo, as
  libavif takes them), full or limited range, libyuv's bilinear chroma
  upsampling for 4:2:0 and 4:2:2, 4:0:0
  as grey: libyuv's fixed point for BT.601, BT.709 and BT.2020 (this
  libavif links libyuv), libavif's float32 otherwise; and the colour
  un-premultiplied by a premultiplied alpha as libyuv does it.

A sequence whose first frame is not a shown key frame, superres and bit
depths other than 8 (av1.py) raise NotImplementedError naming them; an
image past PIL's decompression-bomb limit (bomb.py) and malformed data
raise ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import av1, bomb, yuvscale

BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
VISUAL_SAMPLE_ENTRY = 78      # the bytes before a sample entry's boxes
# libavif's default limits: image size, dimension, images in a sequence
SIZE_LIMIT, DIMENSION_LIMIT = 16384 * 16384, 32768
COUNT_LIMIT = 12 * 3600 * 60
# the item properties libavif knows (others it cannot honour as essential)
SUPPORTED = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot",
             b"imir", b"pixi", b"a1op", b"lsel", b"a1lx", b"clli")


class ContainerError(ValueError):
    """What libavif's parse refuses and PIL turns into a SyntaxError."""


def _boxes(data: bytes, start: int, end: int, top: bool = False):
    """Yield (type, payload start, payload end) of the boxes in
    data[start:end]; a size of 0 (to the end) only at the top level."""
    at = start
    while at < end:
        if end - at < 8:
            raise ContainerError("AVIF box header ends early")
        size, typ = struct.unpack_from(">I4s", data, at)
        head = 8
        if size == 1:
            if end - at < 16:
                raise ContainerError("AVIF box header ends early")
            size = struct.unpack_from(">Q", data, at + 8)[0]
            head = 16
        elif size == 0:
            if not top:
                raise ContainerError("AVIF box of size 0 inside another")
            size = end - at
        if size < head or at + size > end:
            raise ContainerError(f"AVIF box {typ!r} runs past its parent")
        yield typ, at + head, at + size
        at += size


class _R:
    """A cursor over a box's payload."""

    def __init__(self, data: bytes, at: int, end: int):
        self.d, self.at, self.end = data, at, end

    def take(self, n: int) -> bytes:
        if self.at + n > self.end:
            raise ContainerError("AVIF box ends early")
        b = self.d[self.at:self.at + n]
        self.at += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def full(self) -> tuple:
        v = self.u(4)
        return v >> 24, v & 0xFFFFFF

    def string(self) -> bytes:
        z = self.d.find(b"\0", self.at, self.end)
        if z < 0:
            raise ContainerError("AVIF string is not terminated")
        s = self.d[self.at:z]
        self.at = z + 1
        return s


def _ftyp(data: bytes) -> set:
    boxes = _boxes(data, 0, len(data), True)
    try:
        typ, at, end = next(boxes)
    except StopIteration:
        raise ContainerError("AVIF file is empty") from None
    if typ != b"ftyp" or end - at < 8:
        raise ContainerError("AVIF file does not start with ftyp")
    brands = [data[at:at + 4]] + [data[i:i + 4]
                                  for i in range(at + 8, end - 3, 4)]
    if (end - at) % 4:
        raise ContainerError("AVIF ftyp has a broken brand list")
    if not ({b"avif", b"avis"} & set(brands)):
        raise ContainerError("AVIF ftyp names no AVIF brand")
    return set(brands)


def _meta(data: bytes, at: int, end: int) -> dict:
    r = _R(data, at, end)
    version, _ = r.full()
    if version != 0:
        raise ContainerError("AVIF meta version")
    m = {"items": {}, "props": [], "assoc": {}, "refs": [], "idat": None,
         "primary": None, "hdlr": None}
    seen = set()
    for typ, a, e in _boxes(data, r.at, end):
        if typ in (b"hdlr", b"pitm", b"iloc", b"iinf", b"iprp", b"iref",
                   b"idat"):
            if typ in seen:
                raise ContainerError(f"AVIF meta has two {typ!r} boxes")
            seen.add(typ)
        b = _R(data, a, e)
        if typ == b"hdlr":
            m["hdlr"] = _hdlr(b)
        elif typ == b"pitm":
            v, _ = b.full()
            m["primary"] = b.u(2 if v == 0 else 4)
        elif typ == b"iloc":
            _iloc(b, m)
        elif typ == b"iinf":
            v, _ = b.full()
            if v > 1:
                raise ContainerError("AVIF iinf version")
            count = b.u(2 if v == 0 else 4)
            # libavif reads `count` boxes, each an infe, and no further
            for t2, a2, e2 in _first(data, b.at, e, count):
                if t2 != b"infe":
                    raise ContainerError("AVIF iinf holds another box")
                c = _R(data, a2, e2)
                iv, flags = c.full()
                if iv not in (2, 3):
                    raise ContainerError("AVIF infe version")
                item = c.u(2 if iv == 2 else 4)
                if item == 0:
                    raise ContainerError("AVIF infe of item 0")
                c.u(2)
                itype = c.take(4)
                c.string()  # item_name
                if itype == b"mime":
                    c.string()
                it = m["items"].setdefault(item, {"extents": None})
                if "type" in it:
                    raise ContainerError("AVIF item listed twice")
                it["type"], it["hidden"] = itype, flags & 1
        elif typ == b"iref":
            v, _ = b.full()
            if v > 1:
                continue  # libavif skips a version it does not know
            _iref(b, 2 if v == 0 else 4, m)
        elif typ == b"iprp":
            _iprp(data, a, e, m)
        elif typ == b"idat":
            m["idat"] = (a, e)
    for item, it in m["items"].items():
        # an essential property libavif does not know makes it pass over
        # the item (as alpha) or refuse it (as the image or a tile)
        it["unsupported"] = any(
            essential and m["props"][i - 1][0] not in SUPPORTED
            for i, essential in m["assoc"].get(item, []) if i)
        if it.get("type") in (b"av01", b"grid") and \
                it.get("extents") is not None and not it["unsupported"]:
            ispe = next((m["props"][i - 1][1]
                         for i, _ in m["assoc"].get(item, [])
                         if i and m["props"][i - 1][0] == b"ispe"), None)
            if ispe is None or not all(ispe) or _too_large(*ispe):
                raise ContainerError(f"AVIF image item {item} has no ispe "
                                     f"or one of a size libavif refuses")
    if m["hdlr"] != b"pict":
        raise ContainerError("AVIF meta has no pict handler")
    return m


def _iref(b: _R, n: int, m: dict) -> None:
    """iref's references as libavif reads them: each a box header that
    must fit in iref, then its ids read on from there whatever the box's
    size says."""
    while b.at < b.end:
        start = b.at
        size, typ = b.u(4), b.take(4)
        if size == 1:
            size = b.u(8)
        if size < b.at - start or start + size > b.end:
            raise ContainerError("AVIF iref entry runs past iref")
        src = b.u(n)
        dst = [b.u(n) for _ in range(b.u(2))]
        if src == 0 or 0 in dst:
            raise ContainerError("AVIF iref names item 0")
        m["refs"].append((typ, src, dst))


def _hdlr(b: _R) -> bytes:
    if b.full()[0] != 0 or b.u(4) != 0:
        raise ContainerError("AVIF hdlr version or pre_defined")
    kind = b.take(4)
    b.take(12)
    b.string()
    return kind


def _iloc(b: _R, m: dict) -> None:
    v, _ = b.full()
    if v > 2:
        raise ContainerError(f"AVIF iloc version {v}")
    sizes = b.u(1)
    off_size, len_size = sizes >> 4, sizes & 15
    sizes = b.u(1)
    base_size, idx_size = sizes >> 4, (sizes & 15) if v else 0
    for s in (off_size, len_size, base_size, idx_size):
        if s not in (0, 4, 8):
            raise ContainerError("AVIF iloc field size")
    count = b.u(2 if v < 2 else 4)
    for _ in range(count):
        item = b.u(2 if v < 2 else 4)
        if item == 0:
            raise ContainerError("AVIF iloc of item 0")
        method = b.u(2) & 15 if v else 0
        if method > 1:
            raise ContainerError("AVIF iloc construction method")
        b.u(2)  # data_reference_index, which libavif does not read
        base = b.u(base_size)
        extents = []
        for _ in range(b.u(2)):
            if idx_size:
                b.u(idx_size)
            extents.append((base + b.u(off_size), b.u(len_size)))
        it = m["items"].setdefault(item, {})
        if it.get("extents") is not None:
            raise ContainerError("AVIF item located twice")
        it["extents"], it["method"] = extents, method


def _iprp(data: bytes, at: int, end: int, m: dict) -> None:
    for typ, a, e in _boxes(data, at, end):
        if typ == b"ipco":
            for t2, a2, e2 in _boxes(data, a, e):
                m["props"].append((t2, _property(data, t2, a2, e2)))
        elif typ == b"ipma":
            b = _R(data, a, e)
            v, flags = b.full()
            for _ in range(b.u(4)):
                item = b.u(2 if v < 1 else 4)
                if item in m["assoc"]:
                    raise ContainerError("AVIF ipma lists an item twice")
                lst = []
                for _ in range(b.u(1)):
                    if flags & 1:
                        x = b.u(2)
                        lst.append((x & 0x7FFF, x >> 15))
                    else:
                        x = b.u(1)
                        lst.append((x & 0x7F, x >> 7))
                    if lst[-1][0] > len(m["props"]):
                        raise ContainerError(
                            "AVIF ipma names a missing property")
                m["assoc"][item] = lst


def _property(data: bytes, typ: bytes, a: int, e: int):
    """A property box's content, checked as libavif checks it while it
    parses ipco (whether or not an item uses it)."""
    b = _R(data, a, e)
    if typ == b"av1C":
        c = b.take(4)
        if c[0] != 0x81:
            raise ContainerError("AVIF av1C marker or version")
        return c
    if typ == b"ispe":
        if b.full()[0] != 0:
            raise ContainerError("AVIF ispe version")
        return (b.u(4), b.u(4))
    if typ == b"pixi":
        if b.full()[0] != 0:
            raise ContainerError("AVIF pixi version")
        n = b.u(1)
        if not 1 <= n <= 4:
            raise ContainerError(f"AVIF pixi of {n} planes")
        depths = [b.u(1) for _ in range(n)]
        if any(d != depths[0] for d in depths):
            raise ContainerError("AVIF pixi planes of different depths")
        return depths
    if typ == b"colr":
        kind = b.take(4)
        if kind == b"nclx":
            cp, tc, mc, rng = b.u(2), b.u(2), b.u(2), b.u(1)
            if rng & 0x7F:
                raise ContainerError("AVIF colr nclx reserved bits")
            return kind, (cp, tc, mc, rng >> 7)
        return kind, None
    if typ == b"auxC":
        if b.full()[0] != 0:
            raise ContainerError("AVIF auxC version")
        return b.string()
    if typ in (b"irot", b"imir"):
        return b.u(1)
    if typ == b"clap":
        return [b.u(4) for _ in range(8)]
    return None


def _collect(entries) -> dict:
    """The properties of (type, value, essential) entries, as libavif
    associates them with an item or a track."""
    out = {}
    for typ, val, essential in entries:
        if typ in (b"av1C", b"ispe", b"pixi", b"auxC", b"clap"):
            out.setdefault(typ.decode(), val)
        elif typ == b"colr":
            kind, nclx = val
            if kind == b"nclx":
                out.setdefault("nclx", nclx)
            elif kind in (b"rICC", b"prof"):
                out["icc"] = True
                kind = b"ICC"
            out.setdefault("colr", []).append(kind)
        elif typ in (b"irot", b"imir", b"a1op", b"lsel"):
            if not essential:
                raise ContainerError(f"AVIF {typ.decode()} is not essential")
            out[typ.decode()] = val
    return out


def _check_colr(props: dict) -> None:
    """libavif reads the colour image's colr boxes, at most one of each
    kind (nclx, ICC)."""
    kinds = [k for k in props.get("colr", []) if k in (b"nclx", b"ICC")]
    if len(set(kinds)) != len(kinds):
        raise ContainerError("AVIF image has two colr boxes of one kind")


def _props(data: bytes, m: dict, item: int) -> dict:
    """The properties of an item, as libavif associates them."""
    return _collect((*m["props"][idx - 1], essential)
                    for idx, essential in m["assoc"].get(item, []) if idx)


def _payload(data: bytes, m: dict, item: int) -> bytes:
    it = m["items"].get(item)
    if it is None or it.get("extents") is None:
        raise ContainerError("AVIF item has no location")
    chunks = []
    for off, length in it["extents"]:
        if it["method"] == 1:
            if m["idat"] is None:
                raise ContainerError("AVIF item in a missing idat")
            a, e = m["idat"]
            off += a
            end = e
        else:
            end = len(data)
        if length == 0:
            length = end - off
        if off + length > end or off > end:
            raise ContainerError("AVIF item runs past the end of the file")
        chunks.append(data[off:off + length])
    return b"".join(chunks)


def _first(data: bytes, at: int, end: int, count: int):
    """The first `count` boxes of data[at:end]; fewer raise."""
    boxes = _boxes(data, at, end)
    out = []
    for _ in range(count):
        try:
            out.append(next(boxes))
        except StopIteration:
            raise ContainerError("AVIF box list ends early") from None
    return out


def _too_large(w: int, h: int) -> bool:
    """libavif's default image size and dimension limits."""
    return w > SIZE_LIMIT // h or w > DIMENSION_LIMIT or h > DIMENSION_LIMIT


def _version0(b: _R) -> None:
    if b.full()[0] != 0:
        raise ContainerError("AVIF sample table box version")


def _moov(data: bytes, at: int, end: int) -> list:
    """The tracks of a moov box, with libavif's checks of each box it
    reads (trak, tkhd, tref, edts/elst, mdia, mdhd, hdlr, minf, stbl and
    the sample table's boxes; not mvhd)."""
    return [_trak(data, a, e) for typ, a, e in _boxes(data, at, end)
            if typ == b"trak"]


def _trak(data: bytes, at: int, end: int) -> dict:
    t = {"id": 0, "size": None, "aux_for": 0, "prem_by": 0, "stbl": None,
         "timescale": 0}
    tkhd = False
    for typ, a, e in _boxes(data, at, end):
        b = _R(data, a, e)
        if typ == b"tkhd":
            v, _ = b.full()
            if v > 1:
                raise ContainerError("AVIF tkhd version")
            b.take(16 if v else 8)
            tid = b.u(4)
            b.take(12 if v else 8)
            b.take(52)
            w, h = b.u(4) >> 16, b.u(4) >> 16
            if not w or not h or _too_large(w, h):
                raise ContainerError(f"AVIF track of {w}x{h} pixels")
            t["id"], t["size"], tkhd = tid, (w, h), True
        elif typ == b"mdia":
            _mdia(data, a, e, t)
        elif typ == b"tref":
            for t2, a2, e2 in _boxes(data, a, e):
                if t2 in (b"auxl", b"prem"):
                    if e2 - a2 < 4:
                        raise ContainerError("AVIF tref entry ends early")
                    key = "aux_for" if t2 == b"auxl" else "prem_by"
                    t[key] = int.from_bytes(data[a2:a2 + 4], "big")
        elif typ == b"edts":
            _edts(data, a, e)
    if not tkhd:
        raise ContainerError("AVIF trak has no tkhd")
    return t


def _edts(data: bytes, at: int, end: int) -> None:
    seen = False
    for typ, a, e in _boxes(data, at, end):
        if typ != b"elst":
            continue
        if seen:
            raise ContainerError("AVIF edts has two elst boxes")
        seen = True
        b = _R(data, a, e)
        v, flags = b.full()
        if flags & 1:
            if b.u(4) != 1:
                raise ContainerError("AVIF elst entry count")
            if v > 1:
                raise ContainerError("AVIF elst version")
            if b.u(8 if v else 4) == 0:
                raise ContainerError("AVIF elst segment duration")
    if not seen:
        raise ContainerError("AVIF edts has no elst")


def _mdia(data: bytes, at: int, end: int, t: dict) -> None:
    """mdia: mdhd (the colour track's timescale, which Pillow divides by),
    hdlr and minf with the sample table, each checked where it is; none
    is required."""
    for typ, a, e in _boxes(data, at, end):
        b = _R(data, a, e)
        if typ == b"mdhd":
            v, _ = b.full()
            if v > 1:
                raise ContainerError("AVIF mdhd version")
            b.take(16 if v else 8)
            t["timescale"] = b.u(4)
            b.take(8 if v else 4)
        elif typ == b"hdlr":
            _hdlr(b)
        elif typ == b"minf":
            for t2, a2, e2 in _boxes(data, a, e):
                if t2 == b"stbl":
                    if t["stbl"] is not None:
                        raise ContainerError("AVIF track has two stbl boxes")
                    t["stbl"] = _stbl(data, a2, e2)


def _stbl(data: bytes, at: int, end: int) -> dict:
    st = {"chunks": [], "stsc": [], "sizes": [], "all_size": 0,
          "descs": []}
    for typ, a, e in _boxes(data, at, end):
        b = _R(data, a, e)
        if typ in (b"stco", b"co64"):
            _version0(b)
            n = 8 if typ == b"co64" else 4
            st["chunks"] += [b.u(n) for _ in range(b.u(4))]
        elif typ == b"stsc":
            _version0(b)
            prev = 0
            for i in range(b.u(4)):
                first, per = b.u(4), b.u(4)
                b.u(4)  # sample_description_index
                if first <= prev or (i == 0 and first != 1):
                    raise ContainerError("AVIF stsc chunks out of order")
                st["stsc"].append((first, per))
                prev = first
        elif typ == b"stsz":
            _version0(b)
            size, count = b.u(4), b.u(4)
            if size:
                st["all_size"] = size
            else:
                st["sizes"] += [b.u(4) for _ in range(count)]
        elif typ in (b"stss", b"stts"):
            _version0(b)
            b.take(b.u(4) * (4 if typ == b"stss" else 8))
        elif typ == b"stsd":
            if b.full()[0] > 1:
                raise ContainerError("AVIF stsd version")
            count = b.u(4)
            for t2, a2, e2 in _first(data, b.at, e, count):
                props = None
                if t2 == b"av01":
                    if e2 - a2 < VISUAL_SAMPLE_ENTRY:
                        raise ContainerError("AVIF av01 sample entry ends "
                                             "early")
                    # a track's auxi is read as an item's auxC
                    props = [(t3, _property(
                        data, b"auxC" if t3 == b"auxi" else t3, a3, e3), 1)
                             for t3, a3, e3 in _boxes(
                                 data, a2 + VISUAL_SAMPLE_ENTRY, e2)]
                st["descs"].append((t2, props))
    return st


def _first_sample(st: dict, size: int) -> tuple:
    """(offset, size) of a track's first sample, after libavif's checks
    of every sample: no chunk without samples, at most COUNT_LIMIT of
    them, a size for each, and each inside the file."""
    counts, left = [], COUNT_LIMIT
    for ci in range(len(st["chunks"])):
        n = next((per for first, per in reversed(st["stsc"])
                  if first <= ci + 1), 0)
        if n == 0 or n > left:
            raise ContainerError("AVIF sample table has an empty chunk or "
                                 "too many samples")
        left -= n
        counts.append(n)
    k, out = 0, None
    for off, n in zip(st["chunks"], counts):
        for _ in range(n):
            sz = st["all_size"]
            if not sz:
                if k >= len(st["sizes"]):
                    raise ContainerError("AVIF sample table is truncated")
                sz = st["sizes"][k]
            if off + sz > size:
                raise ContainerError("AVIF sample runs past the end of the "
                                     "file")
            out = out or (off, sz)
            off += sz
            k += 1
    return out


def _av01_props(t: dict):
    """The properties of a track's first av01 sample entry, or None where
    libavif would not take the track (no sample table, id, chunk or av01
    entry)."""
    st = t["stbl"]
    if st is None or not t["id"] or not st["chunks"]:
        return None
    return next((p for f, p in st["descs"] if f == b"av01"), None)


def _tracks(data: bytes, tracks: list) -> dict:
    """The colour track (the first AV1 track that is no auxiliary) and
    its alpha track (the first AV1 track auxiliary to it), as libavif's
    track source takes them: frame 0 of each."""
    color = next((t for t in tracks
                  if _av01_props(t) is not None and not t["aux_for"]), None)
    if color is None:
        raise ContainerError("AVIF file has no AV1 colour track")
    alpha = next((t for t in tracks if _av01_props(t) is not None
                  and t["aux_for"] == color["id"]), None)
    out = {"size": color["size"], "props": _collect(_av01_props(color)),
           "alpha": None, "premultiplied": False, "grid": None,
           "alpha_grid": None, "track": True}
    out["props"]["ispe"] = color["size"]
    _check_colr(out["props"])
    out["timescale"] = color["timescale"]
    at, n = _first_sample(color["stbl"], len(data))
    out["color"] = data[at:at + n]
    if alpha is not None:
        at, n = _first_sample(alpha["stbl"], len(data))
        out["alpha"] = data[at:at + n]
        out["alpha_props"] = _collect(_av01_props(alpha))
        out["alpha_props"]["ispe"] = alpha["size"]
        out["premultiplied"] = color["prem_by"] == alpha["id"]
    return out


def _grid(data: bytes, m: dict, item: int, props: dict) -> dict:
    """A grid item: its rows, columns and output size (the grid box,
    32-bit sizes where flag 1 is set; nothing may follow), and its tiles
    (the items its dimg reference lists, in that order): each an av01
    item, one for each cell; the first's av1C is the grid's."""
    payload = _payload(data, m, item)
    b = _R(payload, 0, len(payload))
    version, flags = b.u(1), b.u(1)
    if version != 0:
        raise ContainerError("AVIF grid version")
    rows, cols = b.u(1) + 1, b.u(1) + 1
    n = 4 if flags & 1 else 2
    ow, oh = b.u(n), b.u(n)
    if not ow or not oh or _too_large(ow, oh) or b.at != b.end:
        raise ContainerError("AVIF grid box is broken")
    dimg = {}
    for typ, src, dst in m["refs"]:
        if typ == b"dimg":
            for i, d in enumerate(dst):
                dimg[d] = (src, i)
    ids = [d for (src, i), d in sorted((v, d) for d, v in dimg.items())
           if src == item]
    if len(ids) != rows * cols:
        raise ContainerError("AVIF grid has another number of tiles than "
                             "cells")
    tiles = []
    for d in ids:
        tile = m["items"].get(d, {})
        if tile.get("type") != b"av01" or tile.get("unsupported"):
            raise ContainerError("AVIF grid tile is not an av01 item libavif "
                                 "takes")
        tiles.append((_payload(data, m, d), _props(data, m, d)))
    # libavif compares the av1C fields of every tile but the presentation
    # delay (bytes 1 and 2)
    first = tiles[0][1].get("av1C")
    if first is None or any(tp.get("av1C", b"")[1:3] != first[1:3]
                            for _, tp in tiles):
        raise ContainerError("AVIF grid tiles lack an av1C or differ in it")
    props["av1C"] = first
    return {"rows": rows, "cols": cols, "size": (ow, oh), "tiles": tiles}


def _source(data: bytes, m: dict, item: int, props: dict) -> tuple:
    """(payload, grid) of an image item: its AV1 payload, or None and its
    grid."""
    typ = m["items"][item].get("type")
    if typ == b"grid":
        return None, _grid(data, m, item, props)
    return _payload(data, m, item), None


def parse(data: bytes) -> dict:
    """The colour and alpha images' AV1 payloads (or grids of them) and
    properties, from the primary item and its alpha item, or from the
    colour track and its alpha track where libavif takes the tracks (a
    major brand of avis); raises ContainerError where libavif's parse
    fails."""
    brands = _ftyp(data)
    # libavif reads top-level boxes until it has what the brands ask for
    # (meta for avif, moov for avis) and no further
    need_meta, need_moov = b"avif" in brands, b"avis" in brands
    meta = moov = None
    for typ, a, e in _boxes(data, 0, len(data), True):
        if typ == b"meta":
            if meta is not None:
                raise ContainerError("AVIF file has two meta boxes")
            meta = (a, e)
        elif typ == b"moov":
            if moov is not None:
                raise ContainerError("AVIF file has two moov boxes")
            moov = (a, e)
        if (meta or not need_meta) and (moov or not need_moov):
            break
    if (need_meta and meta is None) or (need_moov and moov is None):
        raise ContainerError("AVIF file ends before its meta or moov box")
    m = _meta(data, *meta) if meta is not None else None
    tracks = _moov(data, *moov) if moov is not None else []
    major = data[8:12]
    if major == b"avis" or (major != b"avif" and tracks):
        return _tracks(data, tracks)
    if m is None:
        raise ContainerError("AVIF file has no meta box")
    prim = m["items"].get(m["primary"])
    if m["primary"] is None or prim is None or "type" not in prim:
        raise ContainerError("AVIF primary item is not listed")
    if prim["type"] not in (b"av01", b"grid") or prim["unsupported"]:
        raise ContainerError(f"AVIF primary item of type {prim['type']!r}, "
                             f"or with an essential property libavif does "
                             f"not know")
    props = _props(data, m, m["primary"])
    if "ispe" not in props:
        raise ContainerError("AVIF primary item has no ispe")
    _check_colr(props)
    color, grid = _source(data, m, m["primary"], props)
    out = {"color": color, "grid": grid, "props": props, "alpha": None,
           "alpha_grid": None, "premultiplied": False, "track": False,
           "size": props["ispe"]}
    for typ, src, dst in m["refs"]:
        if typ != b"auxl" or m["primary"] not in dst:
            continue
        it = m["items"].get(src)
        if it is None or it.get("type") not in (b"av01", b"grid") or \
                it["unsupported"]:
            continue
        aprops = _props(data, m, src)
        if aprops.get("auxC") in ALPHA_URNS:
            if not it.get("extents"):
                continue  # libavif does not take an empty item
            if "ispe" not in aprops or (it["type"] == b"av01"
                                        and "av1C" not in aprops):
                raise ContainerError("AVIF alpha item has no ispe or av1C")
            out["alpha"], out["alpha_grid"] = _source(data, m, src, aprops)
            out["alpha_props"] = aprops
            out["alpha_id"] = src
    if "alpha_id" in out:
        out["premultiplied"] = any(
            t == b"prem" and s == m["primary"] and out["alpha_id"] in d
            for t, s, d in m["refs"])
    return out


def accept(data: bytes) -> bool:
    """PIL's test: the AVIF plugin takes the file and libavif parses its
    container."""
    if data[4:8] != b"ftyp" or data[8:12] not in BRANDS:
        return False
    try:
        parse(data)
    except ContainerError:
        return False
    return True


# libyuv's YUV to RGB constants (YG, YB, UB, UG, VG, VR), which this
# libavif picks by range and matrix coefficients (BT.709; BT.470BG, BT.601
# and unspecified as BT.601; BT.2020 NCL): libyuv's JPEG, F709, V2020 for
# full range and I601, H709, 2020 for limited range
_LIBYUV = {
    (True, 1): (16320, 32, 119, 12, 30, 101),
    (True, 5): (16320, 32, 113, 22, 46, 90),
    (True, 9): (16320, 32, 120, 11, 37, 94),
    (False, 1): (18997, -1160, 128, 14, 34, 115),
    (False, 5): (18997, -1160, 128, 25, 52, 102),
    (False, 9): (19003, -1160, 128, 12, 42, 107),
}
_AS_601 = {2: 5, 6: 5}
# the matrix coefficients libavif converts itself, in float32: identity,
# YCgCo, and (kr, kb) for FCC and SMPTE 240M; others it refuses
_KRKB = {0: None, 8: None, 4: (0.30, 0.11), 7: (0.212, 0.087)}
_SUPPORTED = {0, 1, 2, 4, 5, 6, 7, 8, 9}


def _float_rgb(seq, y, u, v, mc, full, alpha=None):
    """libavif's built-in conversion (float32): grey, identity, YCgCo; a
    premultiplied `alpha` is divided out in float32 before rounding."""
    f = np.float32
    cp = np.arange(256, dtype=f)
    if full:
        ty, tuv = cp / f(255), (cp - f(128)) / f(255)
    else:
        ty, tuv = (cp - f(16)) / f(219), (cp - f(128)) / f(224)
    yf = ty[y]
    if u is None:
        rgb = np.repeat(yf[..., None], 3, axis=2)
    else:
        h, w = y.shape
        tab = ty if mc == 0 else tuv
        cb = _upsample_bilinear(tab[u], seq, w, h)
        cr = _upsample_bilinear(tab[v], seq, w, h)
        if mc == 0:
            rgb = np.stack([cr, yf, cb], axis=2)
        elif mc == 8:
            t = yf - cb
            rgb = np.stack([t + cr, yf + cb, t - cr], axis=2)
        else:
            kr, kb = (f(k) for k in _KRKB[mc])
            kg = f(1) - kr - kb
            r = yf + f(2) * (f(1) - kr) * cr
            b = yf + f(2) * (f(1) - kb) * cb
            g = yf - (f(2) * (kr * (f(1) - kr) * cr
                              + kb * (f(1) - kb) * cb)) / kg
            rgb = np.stack([r, g, b], axis=2)
    rgb = np.clip(rgb, f(0), f(1))
    if alpha is not None:
        af = (alpha.astype(f) / f(255))[..., None]
        rgb = np.where(af == 0, f(0), np.where(
            af < 1, np.minimum(rgb / np.maximum(af, f(1e-30)), f(1)), rgb))
    return (f(0.5) + rgb * f(255)).astype(np.uint8)


def _neighbours(n: int, shift: int) -> tuple:
    """The chroma sample of each of n luma positions and its neighbour in
    libavif's bilinear upsampling: the one before for an even position,
    after for an odd one, none at the first and at a last odd one."""
    i = np.arange(n)
    near = i >> shift
    if not shift:
        return near, near
    adj = np.where(i % 2, 1, -1)
    adj[(i == 0) | ((i == n - 1) & (i % 2 == 1))] = 0
    return near, near + adj


def _upsample_bilinear(c, seq, w, h):
    """libavif's built-in bilinear chroma upsampling (float32): the nearest
    sample 9/16, its horizontal and vertical neighbours 3/16 each, the
    diagonal 1/16, summed in that order."""
    f = np.float32
    ny, fy = _neighbours(h, seq["ss_y"])
    nx, fx = _neighbours(w, seq["ss_x"])
    return (((c[ny][:, nx] * f(9 / 16) + c[ny][:, fx] * f(3 / 16))
             + c[fy][:, nx] * f(3 / 16)) + c[fy][:, fx] * f(1 / 16))


def to_rgb(seq: dict, y, u, v, nclx, alpha=None,
           rgba: bool = False) -> np.ndarray:
    """(H, W, 3) uint8: this libavif's YUV to RGB of 8-bit planes, libyuv's
    fixed point where libavif hands the image to libyuv, else libavif's
    float32 conversion; `alpha`, when the colour is premultiplied by it,
    is divided out as each path does it. Grey goes to libyuv only when
    Pillow asks for RGBA (the file has alpha): libyuv has no grey to RGB."""
    if nclx is not None:
        mc, full = nclx[2], bool(nclx[3])
    else:
        mc, full = seq["mc"], bool(seq["full_range"])
    if mc not in _SUPPORTED:
        raise NotImplementedError(
            f"AVIF matrix coefficients {mc} are not decoded by the port")
    key = (full, _AS_601.get(mc, mc))
    if u is None:
        # libavif reads grey's unspecified or identity matrix as BT.601
        key = (full, 5 if mc in (0, 2, 5, 6) else mc)
        if not rgba or key not in _LIBYUV:
            return _float_rgb(seq, y, None, None, mc, full, alpha)
        rgb = av1.yuv_rgb(y, None, None, 0, 0, _LIBYUV[key])
        return rgb if alpha is None else unpremultiply(rgb, alpha)
    if key in _LIBYUV:
        rgb = av1.yuv_rgb(y, u, v, seq["ss_x"], seq["ss_y"], _LIBYUV[key])
        return rgb if alpha is None else unpremultiply(rgb, alpha)
    if mc in _KRKB and not (mc == 0 and (seq["ss_x"] or seq["ss_y"])):
        return _float_rgb(seq, y, u, v, mc, full, alpha)
    raise NotImplementedError(
        f"AVIF matrix coefficients {mc} are not decoded by the port")


def _check_config(props: dict) -> None:
    """libavif's check of an item's av1C against its pixi: the bit depth
    (high_bitdepth, twelve_bit) must be each channel's."""
    c, pixi = props.get("av1C"), props.get("pixi")
    if c is None or pixi is None:
        return
    depth = 12 if c[2] & 0x20 else 10 if c[2] & 0x40 else 8
    if any(d != depth for d in pixi):
        raise ValueError("AVIF av1C depth differs from the item's pixi")


def _scaled(props: dict, planes: tuple) -> tuple:
    """libavif's checks of a decoded frame against its item or track (the
    pixi depths, 8 here), then its scaling of each plane to the ispe (or
    track header) size where the AV1 frame's differs (libyuv's
    ScalePlane, box filter: scene/yuvscale.py), chroma to that size's
    subsampled size."""
    if any(d != 8 for d in props.get("pixi", ())):
        raise ValueError("AVIF pixi depth differs from the AV1 bit depth")
    seq, y = planes[0], planes[1]
    w, h = props["ispe"]
    if (w, h) == (y.shape[1], y.shape[0]):
        return planes
    sx, sy = (0, 0) if seq["mono"] else (seq["ss_x"], seq["ss_y"])
    out = [seq, yuvscale.scale_plane(y, w, h)]
    for c in planes[2:]:
        out.append(None if c is None else yuvscale.scale_plane(
            c, (w + sx) >> sx, (h + sy) >> sy))
    return tuple(out)


def _frame(payload: bytes, props: dict, track: bool,
           seq: dict | None = None) -> tuple:
    """(seq, Y, U, V) of one AV1 image (`seq`: the decoder's sequence
    header from an earlier image): a track's first temporal unit must
    hold a shown key frame first."""
    if track:
        frame = av1.parse(payload)[1]
        if frame["frame_type"] != av1.KEY_FRAME or not frame["show_frame"]:
            raise NotImplementedError(
                "AVIF image sequences whose first frame is not a shown key "
                "frame are not decoded by the port")
    return _scaled(props, av1.decode_frame(payload, seq=seq))


# the sequence header's fields every tile of a grid must share (libavif:
# size, depth, format, range and CICP)
_SAME = ("bit_depth", "mono", "ss_x", "ss_y", "full_range", "cp", "tc", "mc")


def _stitch(grid: dict, props: dict) -> tuple:
    """(seq, Y, U, V) of a grid: each tile decoded, libavif's checks of the
    tiles against each other and the grid (tiles of one size and format,
    at least 64x64, that cover the output with no spare row or column,
    even sizes where chroma is subsampled), then the planes laid side by
    side and cropped to the output size."""
    # libavif decodes a grid's tiles with one dav1d decoder, which keeps
    # the last sequence header it read
    tiles = []
    for p, tp in grid["tiles"]:
        tiles.append(_frame(p, tp, False, tiles[-1][0] if tiles else None))
    seq, y0 = tiles[0][0], tiles[0][1]
    th, tw = y0.shape
    if any(t[1].shape != y0.shape or any(t[0][k] != seq[k] for k in _SAME)
           for t in tiles):
        raise ValueError("AVIF grid tiles differ")
    (ow, oh), rows, cols = grid["size"], grid["rows"], grid["cols"]
    if tw * cols < ow or th * rows < oh or tw * (cols - 1) >= ow or \
            th * (rows - 1) >= oh:
        raise ValueError("AVIF grid tiles do not cover its output exactly")
    sx, sy = (0, 0) if seq["mono"] else (seq["ss_x"], seq["ss_y"])
    if tw < 64 or th < 64 or (sx and (ow | tw) & 1) or (sy and (oh | th) & 1):
        raise ValueError("AVIF grid tiles are too small or of odd size")
    planes = []
    for k in range(1 if seq["mono"] else 3):
        full = np.block([[tiles[r * cols + c][1 + k] for c in range(cols)]
                         for r in range(rows)])
        ssx, ssy = (sx, sy) if k else (0, 0)
        planes.append(full[:(oh + ssy) >> ssy, :(ow + ssx) >> ssx])
    if len(planes) == 1:
        planes += [None, None]
    return (seq, *planes)


def _image(c: dict, key: str) -> tuple:
    """(seq, Y, U, V) of the colour ("") or alpha ("alpha_") image."""
    props = c[key + "props"]
    if c[key + "grid"] is not None:
        return _stitch(c[key + "grid"], props)
    return _frame(c[key + "color" if not key else "alpha"], props,
                  c["track"])


def decode_avif(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an AVIF file (a still image, a grid, or an image
    sequence's first frame), PIL's `convert("RGB")` of it byte for
    byte."""
    try:
        c = parse(data)
    except ContainerError as e:
        raise ValueError(str(e)) from None
    bomb.check("AVIF", *c["size"])
    if c["track"] and not c["timescale"]:
        # Pillow divides the frame's time by the colour track's timescale
        raise ValueError("AVIF colour track of timescale 0")
    if "av1C" not in c["props"]:
        raise ValueError("AVIF primary item has no av1C")
    _check_config(c["props"])
    has_alpha = c["alpha"] is not None or c["alpha_grid"] is not None
    if has_alpha:
        _check_config(c["alpha_props"])
    seq, y, u, v = _image(c, "")
    a = None
    if has_alpha:
        a = _image(c, "alpha_")[1]
        if a.shape != y.shape:
            raise ValueError("AVIF alpha plane differs in size")
    rgb = to_rgb(seq, y, u, v, c["props"].get("nclx"),
                 a if c["premultiplied"] else None, a is not None)
    if c["size"] == (rgb.shape[1], rgb.shape[0]):
        return rgb
    # a grid whose ispe (PIL's size) is not its output size: Pillow reads
    # the output's RGB or RGBA rows as rows of its own size, and the file
    # is truncated where they are too few
    w, h = c["size"]
    px = rgb if a is None else np.dstack([rgb, a])
    n = px.shape[2]
    if w * h * n > px.size:
        raise ValueError("AVIF grid output is smaller than its ispe size")
    return px.reshape(-1)[:w * h * n].reshape(h, w, n)[..., :3].copy()


def unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate, as this libavif un-premultiplies 8-bit
    colour: each sample times 257 times 65536 // alpha (0xFFFF at alpha
    1), over 2^16, saturated as a signed 16-bit value packed to a byte;
    alpha 0 gives 0 and alpha 255 leaves the colour (native code)."""
    return av1.unattenuate(rgb, a)
