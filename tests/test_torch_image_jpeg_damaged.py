"""Damaged JPEG data decoded as libjpeg-turbo decodes it (PIL 12.1.0 over
libjpeg-turbo 3.1; scene/jpeg.py): where libjpeg only warns the port
decodes the same samples, where libjpeg or Pillow fails the port raises
ValueError.

* Seeded one-byte mutation fuzzes of 200 cases each (150 in the scan
  data, 50 anywhere past the SOI) of a 64x64 RGB image saved at quality
  80: baseline 4:2:0, 4:4:4 with a restart marker every 2 MCUs, grey,
  progressive; and of the JPEG bytes (strip and JPEGTables) of
  scenes/data/formats_h/odd_lab_jpeg.tif, which libtiff hands to libjpeg
  with a fake EOI at the strip's end. Each case shows PIL's pixels or
  PIL's failure. Before the port followed libjpeg's warnings (ROADMAP §3
  fault 10), 100 one-byte changes of a baseline file's scan data gave 21
  images with other pixels and 40 raises where PIL decodes, of a
  progressive one 53 raises, and 300 of the TIFF 52 raises.
* The SIMD IDCT: blocks of extreme coefficients under 8- and 16-bit
  tables (jpeg_blocks, the tool's hand encoder) decode as PIL decodes
  them, where the C routine (`_c_idct`, jidctint.c, what the port ran
  before) does not; on valid files the two agree.
* Block smoothing: every scan-boundary cut plus EOI of progressive files
  of several sizes, samplings, qualities and of grey.
* The bit buffer's read-ahead at the end of the data: a sequential file
  whose EOI is lost decodes in PIL only where libjpeg's last fill of 57
  bits stops before the end, byte for byte the same boundary here.
* Restart markers: every RSTn of a grey and a progressive restart file
  turned into every other RSTn and into other markers, lost, or with
  bytes before it (libjpeg's resync); the standard Huffman tables of a
  sequential file without DHT (a progressive one fails).
"""
import io

import numpy as np
import pytest
from PIL import Image

from test_torch_image_jpeg2000 import held_to_pil
from tools import make_image_formats as fm
from rlshaders_tpu_torch.scene import jpeg
from rlshaders_tpu_torch.scene import texture as ttex

FAMILIES = {
    "baseline": dict(quality=80, subsampling=2),
    "restart": dict(quality=80, subsampling=0, restart_marker_blocks=2),
    "grey": dict(quality=80),
    "progressive": dict(quality=80, subsampling=2, progressive=True),
}


def _segments(data: bytes, marker: int) -> list:
    """Positions of every `marker` segment (0xFF, marker) outside the
    entropy-coded data."""
    out, pos = [], 2
    while pos < len(data) and data[pos] == 0xFF:
        m = data[pos + 1]
        if m == 0xD9:
            break
        if m == marker:
            out.append(pos)
        pos += 2 + (data[pos + 2] << 8 | data[pos + 3])
        if m == 0xDA:                      # skip the scan's data
            while not (data[pos] == 0xFF and data[pos + 1] not in (
                    0x00, *range(0xD0, 0xD8))):
                pos += 1
    return out


def _without(data: bytes, marker: int) -> bytes:
    """The file without its `marker` segments."""
    for pos in reversed(_segments(data, marker)):
        data = data[:pos] + data[pos + 2 + (data[pos + 2] << 8
                                           | data[pos + 3]):]
    return data


def _image(w: int, h: int, seed: int = 0) -> np.ndarray:
    """Gradients with noise: every coefficient band busy."""
    rs = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                   (x + y) * 127.0 / max(w + h - 2, 1)], -1)
    px += rs.normal(0, 30, px.shape)
    return np.clip(px, 0, 255).astype(np.uint8)


def _save(px: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _probe_image(seed: int = 1000) -> np.ndarray:
    """A seeded 64x64 RGB image of ramps and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:64, 0:64]
    base = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                     (x * 5 - y * 2) % 256], -1)
    return np.clip(base + rng.integers(-40, 40, (64, 64, 3)), 0,
                   255).astype(np.uint8)


def _scan_start(data: bytes) -> int:
    i = data.index(b"\xff\xda")
    return i + 2 + (data[i + 2] << 8 | data[i + 3])


def _family(kind: str) -> tuple:
    """(file, [(start, end) of the spans a mutation may hit (the first
    for 150 cases, the second for 50)])."""
    if kind == "tiff":
        data = open("scenes/data/formats_h/odd_lab_jpeg.tif", "rb").read()
        tables = Image.open(io.BytesIO(data)).tag_v2[347]
        at = data.index(tables)
        strip = (8, data.index(b"\xff\xd9", 8) + 2)
        return data, [strip, (at, at + len(tables))]
    px = _probe_image()
    if kind == "grey":
        px = px[..., 1]
    data = _save(px, **FAMILIES[kind])
    return data, [(_scan_start(data), len(data) - 2), (2, len(data))]


@pytest.mark.parametrize("kind", sorted(FAMILIES) + ["tiff"])
def test_damaged_fuzz(kind):
    """200 one-byte mutations: the port is byte-equal wherever PIL
    decodes and raises wherever PIL fails, and names no feature it does
    not decode."""
    data, spans = _family(kind)
    rng = np.random.default_rng(19500 + (sorted(FAMILIES) + ["tiff"]).index(
        kind))
    seen = []
    for case in range(200):
        lo, hi = spans[0] if case < 150 else spans[1]
        out = bytearray(data)
        out[int(rng.integers(lo, hi))] = int(rng.integers(0, 256))
        outcome = held_to_pil(bytes(out))
        assert outcome in ("equal", "raise"), (kind, case, outcome)
        seen.append(outcome)
    assert seen.count("equal") >= 100


def _c_idct(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """jidctint.c's jpeg_idct_islow (the C routine, int arithmetic and its
    range-limit table that wraps), on 16-bit coefficients: what the port
    computed before the SIMD rule."""
    f = jpeg._F

    def one(x, shift):
        z1 = (x[2] + x[6]) * f["F054"]
        tmp2 = z1 - x[6] * f["F184"]
        tmp3 = z1 + x[2] * f["F076"]
        tmp0, tmp1 = (x[0] + x[4]) << 13, (x[0] - x[4]) << 13
        tmp10, tmp13, tmp11, tmp12 = (tmp0 + tmp3, tmp0 - tmp3,
                                      tmp1 + tmp2, tmp1 - tmp2)
        t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * f["F117"]
        t0, t1, t2, t3 = (t0 * f["F029"], t1 * f["F205"], t2 * f["F307"],
                          t3 * f["F150"])
        z1, z2 = z1 * -f["F089"], z2 * -f["F256"]
        z3, z4 = z3 * -f["F196"] + z5, z4 * -f["F039"] + z5
        t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, \
            t3 + z1 + z4
        half = 1 << (shift - 1)
        return [(v + half) >> shift for v in (
            tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0,
            tmp12 - t1, tmp11 - t2, tmp10 - t3)]

    blk = (jpeg._w16(np.asarray(coef, np.int64)).reshape(-1, 64)
           * np.asarray(qt, np.int64)).reshape(-1, 8, 8)
    ws = np.stack(one([blk[:, k, :] for k in range(8)], 11), axis=1)
    out = np.stack(one([ws[:, :, k] for k in range(8)], 18), axis=2)
    x = out & 1023
    return np.clip(np.where(x < 512, x, x - 1024) + 128, 0, 255).astype(
        np.uint8)


def _grey(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("L"))


@pytest.mark.parametrize("seed", range(4))
def test_simd_idct_extreme_blocks(seed):
    """Rows of 32 blocks of extreme coefficients (full 16-bit range, or
    DC with one first-row AC, the column pass's shortcut) under 8- and
    16-bit tables: PIL's samples are jsimd_idct_islow's, which the port
    gives, and not the C routine's."""
    rng = np.random.default_rng(19600 + seed)
    blocks = np.zeros((1, 32, 64), np.int64)
    for b in range(32):
        idx = rng.choice(64, int(rng.integers(1, 64)), replace=False)
        if b % 4 == 0:
            blocks[0, b, idx] = rng.integers(-32767, 32768, len(idx))
        elif b % 4 == 1:
            blocks[0, b, idx] = rng.integers(-2000, 2000, len(idx))
        elif b % 4 == 2:
            blocks[0, b, 0] = rng.integers(-32767, 32768)
            blocks[0, b, int(rng.integers(1, 8))] = rng.integers(-32767,
                                                                 32768)
        else:
            blocks[0, b, idx] = rng.integers(-300, 300, len(idx))
    dc = np.cumsum(np.clip(np.diff(blocks[0, :, 0], prepend=0), -32767,
                           32767))
    blocks[0, :, 0] = dc
    wide = seed % 2 == 1
    qt = rng.integers(1, 65536 if wide else 256, 64)
    data = fm.jpeg_blocks(blocks, 256, 8, qt, wide=wide)
    want = _grey(data)
    got = jpeg.decode_jpeg(data)[..., 0]
    assert np.array_equal(got, want)
    c = _c_idct(blocks.reshape(-1, 64), qt).transpose(1, 0, 2).reshape(8, -1)
    assert not np.array_equal(c, want)


def _coefficients(data: bytes) -> list:
    """(coefficient blocks (N, 64), quantisation table) of each component
    of a single-scan sequential file, as the port's entropy decoder
    leaves them."""
    st = jpeg._Stream()
    rd = jpeg._Reader(data, False)
    _, seg = jpeg._markers(rd, st)
    jpeg._scan(rd, st, seg, True)
    return [(np.asarray(c.coef, np.int64).reshape(-1, 64), c.qt)
            for c in st.comps]


def test_pinned_extreme_file():
    """idct_extremes.jpg of scenes/data/formats_i (the tool's writer): the
    port's samples are PIL's, under a table with values past 32767, and
    the C routine's are not."""
    data = fm.idct_extremes()
    assert data == open("scenes/data/formats_i/idct_extremes.jpg",
                        "rb").read()
    want = _grey(data)
    assert np.array_equal(jpeg.decode_jpeg(data)[..., 0], want)
    [(coef, qt)] = _coefficients(data)
    assert (qt > 32767).any()
    c = _c_idct(coef, qt).transpose(1, 0, 2).reshape(8, -1)
    assert not np.array_equal(c, want)


@pytest.mark.parametrize("quality", [50, 95])
def test_valid_files_same_either_way(quality):
    """On PIL's own files the SIMD rule and the C routine give the same
    samples: the coefficients of valid data stay inside both."""
    data = _save(_probe_image(3), quality=quality, subsampling=0)
    for coef, qt in _coefficients(data):
        assert np.array_equal(jpeg.idct_islow(coef, qt), _c_idct(coef, qt))


@pytest.mark.parametrize("size,sub,mode", [
    ((64, 48), 2, "RGB"), ((37, 23), 0, "RGB"), ((100, 75), 1, "RGB"),
    ((53, 41), 2, "RGB"), ((40, 33), 0, "L"), ((17, 9), 2, "RGB"),
    ((8, 200), 2, "RGB")])
def test_block_smoothing_every_scan_cut(size, sub, mode):
    """A progressive file cut after each of its scans (before the next
    scan's tables), EOI appended, at qualities 30, 80 and 95: libjpeg
    smooths the blocks whose first ten coefficients are not fully known
    (from the DC alone where no AC was sent), and the port's samples are
    PIL's."""
    w, h = size
    px = _image(w, h)
    for q in (30, 80, 95):
        img = Image.fromarray(px)
        data = _save(np.asarray(img.convert(mode)), quality=q,
                     progressive=True, subsampling=sub)
        sos = _segments(data, 0xDA)
        for k in range(1, len(sos)):
            cut = max([p for p in _segments(data, 0xC4)
                       if sos[k - 1] < p < sos[k]] or [sos[k]])
            part = data[:cut] + b"\xff\xd9"
            want = np.asarray(Image.open(io.BytesIO(part)).convert("RGB"))
            assert np.array_equal(jpeg.decode_jpeg(part), want), (q, k)


def _bases() -> dict:
    grey = np.random.default_rng(1).integers(0, 256, (37, 53))
    return {"grid": open("scenes/data/grid.jpg", "rb").read(),
            "logo": open("scenes/data/logo.jpg", "rb").read(),
            "grey": fm.jpeg_grey(grey.astype(np.uint8)),
            "grey_restart": fm.jpeg_grey(grey.astype(np.uint8), restart=5)}


@pytest.mark.parametrize("name", sorted(_bases()))
def test_lost_eoi_read_ahead(name):
    """The file without its EOI and 0 to 13 bytes (zeros, or 0x55) after
    its scan: PIL decodes it only where libjpeg's bit buffer, which reads
    ahead to 57 bits whenever it runs short, never reaches the end of the
    data before the last MCU is out; the port decodes exactly those."""
    body = _bases()[name][:-2]
    decoded = 0
    for k in range(14):
        for fill in (b"\x00", b"\x55"):
            outcome = held_to_pil(body + fill * k)
            assert outcome in ("equal", "raise")
            decoded += outcome == "equal"
    assert 0 < decoded < 28


def _restart_cases(base: bytes, markers: int) -> list:
    rst = [i for i in range(len(base) - 1)
           if base[i] == 0xFF and 0xD0 <= base[i + 1] <= 0xD7][:markers]
    cases = []
    for i in rst:
        for code in list(range(0xD0, 0xD8)) + [0x01, 0x02, 0xC4, 0xD9, 0xDA,
                                               0xE1, 0xFE, 0xC0, 0xDC]:
            d = bytearray(base)
            d[i + 1] = code
            cases.append(bytes(d))
        cases += [base[:i] + b"\x12\x34" + base[i:], base[:i] + base[i + 2:],
                  base[:i] + b"\xff\x00\x77" + base[i:],
                  base[:i] + b"\xff\xff\xff" + base[i:]]
    return cases


def test_restart_resync():
    """Every damage of the first six restart markers of a grey restart
    file (the tool's writer, a marker every 3 blocks) and of a progressive
    file PIL writes with a marker every 2 MCUs: the expected RSTn turned
    into each other RSTn and into invalid, table, EOI, SOS, APP, COM, SOF
    and DNL markers, lost, or with bytes before it. libjpeg resyncs by
    the marker's distance from the one expected; the port follows."""
    img = np.random.default_rng(3).integers(0, 256, (40, 64))
    grey = fm.jpeg_grey(img.astype(np.uint8), restart=3)
    prog = _save(np.random.default_rng(4).integers(0, 256, (40, 64, 3)).astype(
        np.uint8), quality=85, restart_marker_blocks=2, progressive=True)
    seen = []
    for base in (grey, prog):
        for data in _restart_cases(base, 6):
            outcome = held_to_pil(data)
            assert outcome in ("equal", "raise")
            seen.append(outcome)
    assert seen.count("equal") > len(seen) // 2


def test_standard_huffman_tables():
    """A sequential file without its DHT segments decodes with
    libjpeg-turbo's standard tables (PIL's writer uses them, so the image
    is the same); a progressive one fails in PIL and in the port."""
    px = _probe_image(5)
    data = _save(px, quality=80)
    bare = _without(data, 0xC4)
    assert held_to_pil(bare) == "equal"
    assert np.array_equal(jpeg.decode_jpeg(bare), jpeg.decode_jpeg(data))
    assert held_to_pil(_without(_save(px, quality=80, progressive=True),
                                0xC4)) == "raise"
    for key, (counts, symbols) in jpeg._STD.items():
        assert sum(counts) == len(symbols)


def test_committed_damaged_files_are_fuzz_cases():
    """Each damaged JPEG of scenes/data/formats_i is its base file with the
    edits the tool lists, decodes in PIL, and the port gives PIL's
    pixels."""
    files = fm.damaged_jpegs()
    assert sorted(files) == sorted(fm.DAMAGED)
    for name, data in files.items():
        assert data == open(f"scenes/data/formats_i/{name}", "rb").read()
        assert held_to_pil(data) == "equal", name
        assert ttex.image_format(data) == Image.open(io.BytesIO(data)).format
