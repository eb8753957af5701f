"""Still AVIF files, equal to PIL's decode.

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
  which is always decoded (a broken alpha fails the file);
* libavif's YUV to RGB: the matrix coefficients from `colr`, else from
  the sequence header (identity, BT.601, BT.709, BT.2020 NCL, YCgCo, as
  libavif takes them), full or limited range, libyuv's bilinear chroma
  upsampling for 4:2:0 and 4:2:2, 4:0:0
  as grey: libyuv's fixed point for BT.601, BT.709 and BT.2020 (this
  libavif links libyuv), libavif's float32 otherwise; and the colour
  un-premultiplied by a premultiplied alpha as libyuv does it.

Image sequences (`avis` with a track), grid items, quantizer matrices
and film grain raise NotImplementedError naming them, as do superres and
bit depths other than 8 (av1.py); malformed data raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np

from . import av1

BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
# PIL's DecompressionBombError: twice Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * 89478485


class ContainerError(ValueError):
    """What libavif's parse refuses and PIL turns into a SyntaxError."""


def _boxes(data: bytes, start: int, end: int):
    """Yield (type, payload start, payload end) of the boxes in
    data[start:end]."""
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
    boxes = _boxes(data, 0, len(data))
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
            if b.full()[0] != 0 or b.u(4) != 0:
                raise ContainerError("AVIF hdlr version or pre_defined")
            m["hdlr"] = b.take(4)
            b.take(12)
            b.string()
        elif typ == b"pitm":
            v, _ = b.full()
            m["primary"] = b.u(2 if v == 0 else 4)
        elif typ == b"iloc":
            _iloc(b, m)
        elif typ == b"iinf":
            v, _ = b.full()
            count = b.u(2 if v == 0 else 4)
            n = 0
            for t2, a2, e2 in _boxes(data, b.at, e):
                if t2 != b"infe":
                    continue
                n += 1
                c = _R(data, a2, e2)
                iv, flags = c.full()
                if iv not in (2, 3):
                    raise ContainerError("AVIF infe version")
                item = c.u(2 if iv == 2 else 4)
                c.u(2)
                itype = c.take(4)
                c.string()  # item_name
                if itype == b"mime":
                    c.string()
                it = m["items"].setdefault(item, {"extents": None})
                if "type" in it:
                    raise ContainerError("AVIF item listed twice")
                it["type"], it["hidden"] = itype, flags & 1
            if n != count:
                raise ContainerError("AVIF iinf entry count")
        elif typ == b"iref":
            v, _ = b.full()
            if v > 1:
                continue  # libavif skips a version it does not know
            n = 2 if v == 0 else 4
            for t2, a2, e2 in _boxes(data, b.at, e):
                c = _R(data, a2, e2)
                src = c.u(n)
                count = c.u(2)
                m["refs"].append((t2, src, [c.u(n) for _ in range(count)]))
        elif typ == b"iprp":
            _iprp(data, a, e, m)
        elif typ == b"idat":
            m["idat"] = (a, e)
    for item, it in m["items"].items():
        if it.get("type") == b"av01" and it.get("extents") is not None and \
                not any(m["props"][i - 1][0] == b"ispe"
                        for i, _ in m["assoc"].get(item, []) if i):
            raise ContainerError(f"AVIF av01 item {item} has no ispe")
    if m["hdlr"] != b"pict":
        raise ContainerError("AVIF meta has no pict handler")
    if m["primary"] is None:
        raise ContainerError("AVIF meta has no primary item")
    return m


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
        return [b.u(1) for _ in range(b.u(1))]
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


def _props(data: bytes, m: dict, item: int) -> dict:
    """The properties of an item, as libavif associates them."""
    out = {}
    for idx, essential in m["assoc"].get(item, []):
        if idx == 0:
            continue
        typ, val = m["props"][idx - 1]
        if typ in (b"av1C", b"ispe", b"pixi", b"auxC", b"clap"):
            out.setdefault(typ.decode(), val)
        elif typ == b"colr":
            kind, nclx = val
            if kind == b"nclx":
                out.setdefault("nclx", nclx)
            elif kind in (b"rICC", b"prof"):
                out["icc"] = True
        elif typ in (b"irot", b"imir", b"a1op", b"lsel"):
            if not essential:
                raise ContainerError(f"AVIF {typ.decode()} is not essential")
            out[typ.decode()] = val
    return out


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


def parse(data: bytes) -> dict:
    """The primary item's and the alpha item's AV1 payloads and
    properties; raises ContainerError where libavif's parse fails."""
    brands = _ftyp(data)
    # libavif reads top-level boxes until it has what the brands ask for
    # (meta for avif, moov for avis) and no further
    need_meta, need_moov = b"avif" in brands, b"avis" in brands
    meta = moov = None
    for typ, a, e in _boxes(data, 0, len(data)):
        if typ == b"meta":
            if meta is not None:
                raise ContainerError("AVIF file has two meta boxes")
            meta = (a, e)
        elif typ == b"moov":
            moov = (a, e)
        if (meta or not need_meta) and (moov or not need_moov):
            break
    if (need_meta and meta is None) or (need_moov and moov is None):
        raise ContainerError("AVIF file ends before its meta or moov box")
    if moov is not None:
        raise NotImplementedError(
            "AVIF image sequences are not decoded by the port")
    m = _meta(data, *meta)
    prim = m["items"].get(m["primary"])
    if prim is None or "type" not in prim:
        raise ContainerError("AVIF primary item is not listed")
    if prim["type"] == b"grid":
        raise NotImplementedError(
            "AVIF grid items are not decoded by the port")
    if prim["type"] != b"av01":
        raise ContainerError(f"AVIF primary item of type {prim['type']!r}")
    props = _props(data, m, m["primary"])
    if "ispe" not in props:
        raise ContainerError("AVIF primary item has no ispe")
    out = {"color": _payload(data, m, m["primary"]), "props": props,
           "alpha": None, "premultiplied": False}
    for typ, src, dst in m["refs"]:
        if typ != b"auxl" or m["primary"] not in dst:
            continue
        it = m["items"].get(src)
        if it is None or it.get("type") != b"av01":
            continue
        aprops = _props(data, m, src)
        if aprops.get("auxC") in ALPHA_URNS:
            if "av1C" not in aprops or it.get("extents") is None:
                continue  # libavif does not take it as the alpha
            if "ispe" not in aprops:
                raise ContainerError("AVIF alpha item has no ispe")
            out["alpha_props"] = aprops
            out["alpha"] = _payload(data, m, src)
            out["alpha_id"] = src
    if out["alpha"] is not None:
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
    except NotImplementedError:
        return True
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
        cb = tab[_upsample_nearest(u, seq, w, h)]
        cr = tab[_upsample_nearest(v, seq, w, h)]
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


def _upsample_nearest(c, seq, w, h):
    ys = np.arange(h) >> seq["ss_y"]
    xs = np.arange(w) >> seq["ss_x"]
    return c[ys][:, xs]


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


def _check_frame(props: dict, y: np.ndarray) -> None:
    """libavif's checks of a decoded frame against its item: the pixi
    depths (8 here) and the ispe size, to which libavif would scale the
    frame with libyuv, which the port does not do."""
    if any(d != 8 for d in props.get("pixi", ())):
        raise ValueError("AVIF pixi depth differs from the AV1 bit depth")
    if props["ispe"] != (y.shape[1], y.shape[0]):
        raise NotImplementedError(
            "AVIF frames scaled to an ispe size that differs from the AV1 "
            "frame's are not decoded by the port")


def decode_avif(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a still AVIF file, PIL's `convert("RGB")` of it
    byte for byte."""
    try:
        c = parse(data)
    except ContainerError as e:
        raise ValueError(str(e)) from None
    iw, ih = c["props"]["ispe"]
    if iw * ih > MAX_PIXELS:
        raise ValueError(f"AVIF image of {iw}x{ih} pixels is past PIL's "
                         f"decompression bomb limit")
    if "av1C" not in c["props"]:
        raise ValueError("AVIF primary item has no av1C")
    _check_config(c["props"])
    if c["alpha"] is not None:
        _check_config(c["alpha_props"])
    seq, y, u, v = av1.decode_frame(c["color"])
    _check_frame(c["props"], y)
    a = None
    if c["alpha"] is not None:
        _, a, _, _ = av1.decode_frame(c["alpha"])
        _check_frame(c["alpha_props"], a)
        if a.shape != y.shape:
            raise ValueError("AVIF alpha plane differs in size")
    return to_rgb(seq, y, u, v, c["props"].get("nclx"),
                  a if c["premultiplied"] else None, a is not None)


def unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate, as this libavif un-premultiplies 8-bit
    colour: each sample times 257 times 65536 // alpha (0xFFFF at alpha
    1), over 2^16, saturated as a signed 16-bit value packed to a byte;
    alpha 0 gives 0 and alpha 255 leaves the colour (native code)."""
    return av1.unattenuate(rgb, a)
