"""The port's JPEG 2000 decoder (scene/jp2.py over j2k.py, and j2k_t1.py
with its native tier-1 csrc/j2k_t1.cpp) against PIL 12.1's OpenJPEG
2.5.4, the decoder behind the JAX package's
`Image.open(path).convert("RGB")`: byte-equal, no tolerance.

The images are seeded (numpy default_rng, seeds stated in each test) and
written by PIL in the test over every option of its JPEG 2000 writer:
modes L, LA, RGB, RGBA and I;16, J2K and JP2, the 5/3 and 9/7 wavelets,
RCT and ICT, signed components, quality layers by rate and by dB, the
number of resolutions, code-block, precinct and tile sizes, tile and
image offsets, the five progression orders, comments, PLT markers and
the cinema profiles (tile-parts, TLM, POC). PIL writes no palette,
colour-space or quantization variants; tools/make_image_formats.py's
`jp2_wrap` and `pclr_cmap` build JP2 boxes around PIL's codestreams, and
the tests rewrite marker segments in place. Every committed file of
scenes/data/formats_d is held to its digest and to the JAX package's
`load_image(path, 1.0)`, the native tier-1 to the plain one on every
code-block, and cut and mutated streams to PIL: the port raises
ValueError wherever PIL raises, decodes PIL's bytes wherever PIL
decodes, and raises NotImplementedError naming a feature it does not
decode.
"""
import hashlib
import io
import os
import pickle
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from test_torch_gpu import FORMAT_D_DIGESTS
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from rlshaders_tpu_torch.accel import native
from rlshaders_tpu_torch.scene import j2k, j2k_t1, jp2
from rlshaders_tpu_torch.scene import texture as ttex

FOLDER = "scenes/data/formats_d"
BIG = f"{FOLDER}/texture_2048.jp2"
FILES = sorted(FORMAT_D_DIGESTS)
JPEG2000 = [f for f in FILES if not f.endswith(".webp")]


# PIL in a process of its own, serving pickled requests on its stdin: a
# stream OpenJPEG or libwebp crashes on (or an option set OpenJPEG's
# encoder aborts on) must not take the test process down, and a fork of
# the test process (torch and jax loaded) costs more than the decode
_WORKER = r"""
import io, pickle, struct, sys
import numpy as np
from PIL import Image
inp, out = sys.stdin.buffer, sys.stdout.buffer
while True:
    head = inp.read(4)
    if len(head) < 4:
        break
    op, arg, kw = pickle.loads(inp.read(struct.unpack("<I", head)[0]))
    try:
        if op == "decode":
            px = np.asarray(Image.open(io.BytesIO(arg)).convert("RGB"))
            res = ("ok", px)
        else:
            buf = io.BytesIO()
            img = Image.fromarray(arg)
            img = img.convert(kw.pop("mode")) if "mode" in kw else img
            img.save(buf, op, **kw)
            res = ("ok", buf.getvalue())
    except Exception as e:
        res = ("error", repr(e)[:200])
    msg = pickle.dumps(res)
    out.write(struct.pack("<I", len(msg)) + msg)
    out.flush()
"""
_worker = None


def _ask(op: str, arg, **kw):
    """("ok", result) or ("error", text) of the PIL process, or None where
    the request ended it (it is started again for the next)."""
    global _worker
    if _worker is None or _worker.poll() is not None:
        _worker = subprocess.Popen([sys.executable, "-c", _WORKER],
                                   stdin=subprocess.PIPE,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.DEVNULL)
    msg = pickle.dumps((op, arg, kw))
    try:
        _worker.stdin.write(struct.pack("<I", len(msg)) + msg)
        _worker.stdin.flush()
        head = _worker.stdout.read(4)
        if len(head) == 4:
            return pickle.loads(_worker.stdout.read(
                struct.unpack("<I", head)[0]))
    except BrokenPipeError:
        pass
    _worker.wait()
    return None


def pil_outcome(data: bytes):
    """PIL's convert("RGB") of the bytes, or the text of its exception."""
    res = _ask("decode", data)
    assert res is not None, "PIL's decode ended its process"
    return res[1]


def held_to_pil(data: bytes, decode=ttex.decode_image) -> str:
    """The port's outcome on the bytes held to PIL's: "equal" (both
    decode, byte for byte), "raise" (both raise: the port ValueError, or
    NotImplementedError for data no plugin takes) or "refused" (PIL
    decodes, the port names a feature it does not decode with
    NotImplementedError)."""
    want = pil_outcome(data)
    try:
        got = decode(data)
    except NotImplementedError:
        return "refused" if isinstance(want, np.ndarray) else "raise"
    except ValueError:
        assert isinstance(want, str), "PIL decodes what the port refuses"
        return "raise"
    assert isinstance(want, np.ndarray), f"PIL raises {want}"
    assert np.array_equal(got, want)
    return "equal"


def _save(px: np.ndarray, mode: str = None, **kw) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(px)
    (img.convert(mode) if mode else img).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _image(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """A seeded image of gradients and noise (c = 1 gives (h, w))."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                     (x * 2 + y * 5 + 40) % 256, (x + y) % 256][:c], -1)
    px = np.clip(base + rng.integers(0, 40, (h, w, c)), 0, 255)
    px = px.astype(np.uint8)
    return px[..., 0] if c == 1 else px


def _segment(data: bytes, marker: int) -> tuple:
    """(start, end) of the first segment of a marker in a codestream."""
    at = data.index(struct.pack(">H", marker))
    return at, at + 2 + struct.unpack_from(">H", data, at + 2)[0]


def _with_segment(data: bytes, marker: int, body: bytes) -> bytes:
    """The codestream with the first segment of `marker` replaced."""
    start, end = _segment(data, marker)
    return (data[:start] + struct.pack(">HH", marker, len(body) + 2) + body
            + data[end:])


def _insert(data: bytes, before: int, marker: int, body: bytes) -> bytes:
    """The codestream with a segment inserted before the first `before`."""
    at = data.index(struct.pack(">H", before))
    return (data[:at] + struct.pack(">HH", marker, len(body) + 2) + body
            + data[at:])


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def test_digests_cover_the_files():
    """Every file of scenes/data/formats_d is pinned, in both copies of the
    digests, and the tool's entry point writes the committed bytes."""
    names = sorted(f"{FOLDER}/{n}" for n in os.listdir(FOLDER))
    assert names == FILES
    assert chip_smoke.FORMAT_D_DIGESTS == FORMAT_D_DIGESTS
    made = fm.files_d()
    for path in FILES:
        with open(path, "rb") as f:
            assert f.read() == made[os.path.basename(path)], path


@pytest.mark.parametrize("path", [f for f in JPEG2000 if f != BIG],
                         ids=os.path.basename)
def test_committed_file(tmp_path, path):
    with open(path, "rb") as f:
        data = f.read()
    assert ttex.image_format(data) == Image.open(io.BytesIO(data)).format
    want = same_as_reference(tmp_path, data, os.path.basename(path))
    assert hashlib.sha256(want.tobytes()).hexdigest() == FORMAT_D_DIGESTS[
        path]


@pytest.fixture(scope="module")
def big():
    """The 2048x2048 JP2 and its decodes by PIL and the port, each made
    once; the blocks the native tier-1 decoded for it."""
    with open(BIG, "rb") as f:
        data = f.read()
    calls = []
    real = j2k.decode_blocks

    def spy(body, table, size):
        out = real(body, table, size)
        calls.append((body, np.asarray(table), out))
        return out

    j2k.decode_blocks = spy
    try:
        got = ttex.decode_image(data)
    finally:
        j2k.decode_blocks = real
    return data, pil_outcome(data), got, calls


def test_big_jp2(big):
    """The 2048x2048 texture as a 9/7 JP2 of three quality layers with the
    ICT, about 250 KB, decoded to PIL's bytes and its digest."""
    data, want, got, _ = big
    head = j2k.read_header(data[jp2._jp2_boxes(data)[0]:])
    assert head.params.layers == 3 and head.params.mct == 1
    assert head.params.coding[0].qmfbid == 0
    assert 200_000 < len(data) < 300_000
    assert np.array_equal(got, want)
    assert hashlib.sha256(got.tobytes()).hexdigest() == FORMAT_D_DIGESTS[BIG]


def test_big_jp2_matches_the_jax_load(big, tmp_path):
    """The JAX package's load_image of the file (PIL's decode over 255)."""
    from rlshaders_tpu.scene import texture as jtex
    data, _, got, _ = big
    path = tmp_path / "big.jp2"
    path.write_bytes(data)
    assert np.array_equal(got.astype(np.float32) / 255.0,
                          jtex.load_image(str(path), 1.0))


def _blocks_equal(body: bytes, table: np.ndarray, out: np.ndarray, rows):
    for k in rows:
        at, n, w, h, orient, numbps, passes, dst = (int(v) for v in table[k])
        plain = j2k_t1.decode_block(body[at:at + n], w, h, orient, numbps,
                                    passes)
        assert np.array_equal(plain.ravel(), out[dst:dst + w * h]), k


@pytest.mark.parametrize("path", [f for f in JPEG2000 if f != BIG],
                         ids=os.path.basename)
def test_native_tier1_equals_plain(monkeypatch, path):
    """The native tier-1 equals the plain one on every code-block of the
    file."""
    calls = []
    real = j2k.decode_blocks

    def spy(body, table, size):
        out = real(body, table, size)
        calls.append((body, np.asarray(table), out))
        return out

    monkeypatch.setattr(j2k, "decode_blocks", spy)
    with open(path, "rb") as f:
        ttex.decode_image(f.read())
    assert calls
    for body, table, out in calls:
        _blocks_equal(body, table, out, range(len(table)))


def test_native_tier1_equals_plain_on_the_big_file(big):
    """Every code-block of the 2048x2048 file (3,072, about half a minute
    of the plain tier-1) held to the plain tier-1."""
    *_, calls = big
    assert len(calls) == 1
    body, table, out = calls[0]
    assert len(table) == 3072
    _blocks_equal(body, table, out, range(len(table)))


def test_no_compiler_raises(monkeypatch):
    """No g++ on PATH: the decode raises instead of falling back to the
    plain tier-1."""
    with open(f"{FOLDER}/crop_lrcp.j2k", "rb") as f:
        data = f.read()
    monkeypatch.setattr(j2k_t1, "_lib", None)
    monkeypatch.setenv("PATH", "/nonexistent")
    assert shutil.which(native.CXX) is None
    with pytest.raises(RuntimeError, match="not found on PATH"):
        ttex.decode_image(data)


def test_broken_source_raises(monkeypatch, tmp_path):
    """A source that does not compile: the build raises, and so does the
    decode."""
    with open(j2k_t1.SOURCE) as f:
        src = f.read()
    bad = tmp_path / "j2k_t1.cpp"
    bad.write_text(src.replace("int zc_context", "int zc_context(", 1))
    monkeypatch.setattr(j2k_t1, "_lib", None)
    monkeypatch.setattr(j2k_t1, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with open(f"{FOLDER}/crop_lrcp.j2k", "rb") as f:
        data = f.read()
    with pytest.raises(RuntimeError, match="failed"):
        ttex.decode_image(data)


def test_committed_features():
    """The committed files hold the five progression orders, both
    wavelets, RCT and ICT, several layers, precincts, tiles and
    tile-parts, an image offset, POC, TLM, PLT, a comment, signed
    components, 16-bit components and a palette."""
    seen = set()
    for path in JPEG2000:
        with open(path, "rb") as f:
            data = f.read()
        if data.startswith(b"icns"):
            data = data[data.index(jp2.JP2_MAGIC):]
        start = jp2._jp2_boxes(data)[0] if data.startswith(
            jp2.JP2_MAGIC) else 0
        if start:
            seen.add(("palette", jp2.pil_header(data)[1] == "P"))
        stream = data[start:]
        head = j2k.read_header(stream)
        p, siz = head.params, head.siz
        seen |= {("prog", j2k.PROGRESSIONS[p.prog]), ("layers", p.layers > 1),
                 ("qmf", p.coding[0].qmfbid), ("mct", p.mct),
                 ("precincts", p.coding[0].precincts),
                 ("tiles", siz.tiles_x * siz.tiles_y > 1),
                 ("offset", siz.x0 > 0),
                 ("signed", siz.comps[0].sgnd),
                 ("16 bits", siz.comps[0].prec == 16)}
        for name, marker in (("tlm", j2k.TLM), ("plt", j2k.PLT),
                             ("com", j2k.COM)):
            seen.add((name, struct.pack(">H", marker) in stream))
        parts = j2k._tile_parts(stream, head).values()
        seen.add(("tile-parts", any(len(c) > 1 for _, c in parts)))
        seen.add(("poc", any(bool(q.pocs) for q, _ in parts)))
    want = {("prog", p) for p in j2k.PROGRESSIONS} | {
        ("layers", True), ("qmf", 0), ("qmf", 1), ("mct", 1),
        ("precincts", True), ("tiles", True), ("offset", True),
        ("poc", True), ("signed", True), ("16 bits", True), ("tlm", True),
        ("plt", True), ("com", True), ("tile-parts", True),
        ("palette", True)}
    assert want <= seen


# ---------------------------------------------------------------------------
# PIL's writer: modes and options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("kw", [
    {}, {"no_jp2": True}, {"irreversible": True}, {"signed": True},
    {"signed": True, "no_jp2": True, "irreversible": True}],
    ids=["jp2", "j2k", "irreversible", "signed", "signed_j2k_irreversible"])
def test_modes(mode, kw):
    """Each mode PIL writes, seed 1, 33x45."""
    px = _image(33, 45, len(mode), 1)
    assert held_to_pil(_save(px, mode, **kw)) == "equal"


@pytest.mark.parametrize("kw", [{}, {"no_jp2": True}, {"irreversible": True},
                                {"signed": True}],
                         ids=["jp2", "j2k", "irreversible", "signed"])
def test_sixteen_bit_grey_clamps_as_pil(kw):
    """I;16 (16-bit components): convert("RGB") clamps at 255, values past
    255 in the seeded image (seed 2) and values below it in its top rows."""
    rng = np.random.default_rng(2)
    px = rng.integers(0, 65536, (31, 40)).astype(np.uint16)
    px[:6] = rng.integers(0, 300, (6, 40))
    data = _save(px, "I;16", **kw)
    assert Image.open(io.BytesIO(data)).mode == "I;16"
    assert held_to_pil(data) == "equal"


PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _options(seed: int) -> tuple:
    """A seeded image and a draw of PIL's JPEG 2000 options."""
    rng = np.random.default_rng(seed)
    c = int(rng.integers(1, 5))
    h, w = (int(v) for v in rng.integers(1, 90, 2))
    px = _image(h, w, c, seed)
    kw = {"no_jp2": bool(rng.random() < 0.5),
          "irreversible": bool(rng.random() < 0.5),
          "mct": int(rng.random() < 0.5),
          "progression": PROGRESSIONS[int(rng.integers(0, 5))]}
    if rng.random() < 0.4:
        kw["quality_mode"] = "dB" if rng.random() < 0.5 else "rates"
        layers = sorted(rng.choice([80, 40, 20, 10, 5, 2],
                                   int(rng.integers(1, 4)), replace=False))
        kw["quality_layers"] = (
            [20 + int(q) for q in layers] if kw["quality_mode"] == "dB"
            else [int(q) for q in layers[::-1]])
    if rng.random() < 0.4:
        kw["num_resolutions"] = int(rng.integers(1, 7))
    if rng.random() < 0.3:
        kw["codeblock_size"] = [(16, 16), (32, 32), (64, 16), (8, 128),
                                (4, 4)][int(rng.integers(0, 5))]
    if rng.random() < 0.3:
        kw["precinct_size"] = [(32, 32), (64, 64), (128, 64),
                               (16, 16)][int(rng.integers(0, 4))]
    if rng.random() < 0.3:
        kw["tile_size"] = tuple(int(v) for v in rng.integers(8, 48, 2))
        if rng.random() < 0.5:
            kw["tile_offset"] = tuple(int(v) for v in rng.integers(0, 5, 2))
    if rng.random() < 0.3:
        kw["offset"] = tuple(int(v) for v in rng.integers(0, 9, 2))
        if "tile_offset" in kw:
            kw["tile_offset"] = tuple(min(t, o) for t, o in
                                      zip(kw["tile_offset"], kw["offset"]))
    return px, kw


def _pil_save_safely(px: np.ndarray, kw: dict):
    """PIL's JPEG 2000 file of px (OpenJPEG's encoder aborts on some
    option sets for tiny images), or None."""
    res = _ask("JPEG2000", px, **kw)
    return res[1] if res is not None and res[0] == "ok" else None


@pytest.mark.parametrize("chunk", range(8))
def test_option_sweep(chunk):
    """25 seeded draws a case (seeds 25 * chunk + k) of the image and of
    PIL's options; each file PIL writes is held to PIL's decode."""
    outcomes = []
    for seed in range(25 * chunk, 25 * chunk + 25):
        px, kw = _options(seed)
        data = _pil_save_safely(px, kw)
        if data is not None:
            outcomes.append(held_to_pil(data))
    assert outcomes.count("equal") >= 8


@pytest.mark.parametrize("cinema", ["cinema2k-24", "cinema2k-48",
                                    "cinema4k-24"])
def test_cinema_profiles(cinema):
    """The digital cinema profiles Pillow accepts for 8-bit RGB: tile-parts
    by component, TLM, and POC for 4K (seed 3, 48x64)."""
    data = _save(_image(48, 64, 3, 3), cinema_mode=cinema, no_jp2=True)
    assert held_to_pil(data) == "equal"


def test_comment_plt_and_dB_layers():
    """A comment, PLT markers and layers by PSNR (seed 4)."""
    data = _save(_image(50, 61, 3, 4), comment="a comment", plt=True,
                 quality_mode="dB", quality_layers=[25, 35, 50],
                 irreversible=True)
    assert struct.pack(">H", j2k.PLT) in data
    assert held_to_pil(data) == "equal"


# ---------------------------------------------------------------------------
# JP2 boxes PIL does not write
# ---------------------------------------------------------------------------

def _grey_stream(seed: int = 5) -> tuple:
    idx = np.random.default_rng(seed).integers(0, 256, (21, 30)).astype(
        np.uint8)
    return _save(idx, "L", no_jp2=True), idx


def _palette(n: int, cols: int, seed: int, few: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, few, (n, cols)).astype(
        np.uint8)


GREY_COLR = b"\x01\x00\x00\x00\x00\x00\x11"
PALETTES = {
    # entries for every index, RGB and RGBA
    "rgb_256": (256, 3, 256),
    "rgba_256": (256, 4, 256),
    # indices past the palette are black
    "short_100": (100, 3, 256),
    # a colour listed twice keeps its first index, so later entries move
    # down one (ImagePalette.getcolor) and the last indices turn black
    "repeats": (256, 3, 4),
}


@pytest.mark.parametrize("name", sorted(PALETTES))
def test_palette_jp2(name):
    """pclr and cmap boxes around PIL's codestream of indices (seed 6):
    PIL's mode P, its palette, and its black past the palette."""
    n, cols, few = PALETTES[name]
    stream, _ = _grey_stream()
    pal = _palette(n, cols, 6, few)
    data = fm.jp2_wrap(stream, 30, 21, 1, fm.pclr_cmap(pal))
    assert Image.open(io.BytesIO(data)).mode == "P"
    assert held_to_pil(data) == "equal"


def _raw_pclr(ne: int, npc: int, depth: int, entries: bytes) -> bytes:
    return fm.j2k_boxes(b"pclr", struct.pack(">HB", ne, npc)
                        + bytes([depth] * npc) + entries)


@pytest.mark.parametrize("case", [
    "no_cmap", "grey_colr", "over_256", "nine_bit", "sixteen_bit"])
def test_palette_edges(case):
    """A palette without cmap decodes; one with a greyscale colr box, over
    256 colours, or 9- or 16-bit columns, is refused by PIL and the port
    alike (seed 7)."""
    stream, _ = _grey_stream()
    pal = _palette(300 if case == "over_256" else 256, 3, 7)
    colr = GREY_COLR if case == "grey_colr" else \
        b"\x01\x00\x00\x00\x00\x00\x10"
    if case in ("nine_bit", "sixteen_bit"):
        depth = 8 if case == "nine_bit" else 15
        boxes = _raw_pclr(256, 3, depth, bytes(pal.ravel()))
    else:
        boxes = fm.pclr_cmap(pal)
        if case == "no_cmap":
            boxes = boxes[:boxes.index(b"cmap") - 4]
    data = fm.jp2_wrap(stream, 30, 21, 1, boxes, colr=colr)
    assert held_to_pil(data) == ("equal" if case == "no_cmap" else "raise")


@pytest.mark.parametrize("colr,nc,want", [
    (None, 1, "equal"), (b"\x02\x00\x00" + b"p" * 20, 1, "equal"),
    (b"\x01\x00\x00\x00\x00\x00\x03", 1, "equal"), (GREY_COLR, 1, "equal"),
    (None, 3, "equal"), (b"\x02\x00\x00" + b"p" * 20, 3, "equal"),
    (b"\x03\x00\x00" + b"p" * 20, 3, "equal"),
    (b"\x01\x00\x00\x00", 3, "raise"),
    (b"\x01\x00\x00\x00\x00\x00\x18", 3, "raise"),
    (b"\x01\x00\x00\x00\x00\x00\x0c", 4, "equal"),
    (b"\x01\x00\x00\x00\x00\x00\x12", 3, "equal")],
    ids=["grey_none", "grey_icc", "grey_enum3", "grey", "rgb_none", "rgb_icc",
         "rgb_method3", "rgb_short", "eycc", "cmyk", "sycc"])
def test_colour_spaces(colr, nc, want):
    """The colr box: none, an ICC profile, an unknown method or space
    (PIL's colour space then follows the component count), a box too
    short, eYCC (no unpacker), CMYK (Pillow's cmyk2rgb) and sYCC (once
    refused, now Pillow's YCbCr conversion) around PIL's codestream (seed
    8)."""
    px = _image(21, 30, nc, 8)
    data = fm.jp2_wrap(_save(px, no_jp2=True), 30, 21, nc, colr=colr)
    assert held_to_pil(data) == want


@pytest.mark.parametrize("w,h,nc", [(33, 23, 1), (27, 21, 1), (30, 21, 3),
                                    (30, 21, 4)],
                         ids=["larger", "smaller", "rgb_header",
                              "rgba_header"])
def test_header_and_codestream_disagree(w, h, nc):
    """ihdr's size or component count against a 30x21 grey codestream
    with no colr box: PIL refuses another size, and reads three or four
    components as RGB or RGBA of a grey image."""
    stream, _ = _grey_stream()
    data = fm.jp2_wrap(stream, w, h, nc, colr=None)
    assert held_to_pil(data) == ("equal" if nc > 1 else "raise")


# ---------------------------------------------------------------------------
# codestream variants and refusals
# ---------------------------------------------------------------------------

def test_derived_quantization():
    """Scalar derived quantization (QCD style 1: one step size, the others
    derived from it), which PIL's writer never sets, put in an
    irreversible file (seed 9)."""
    data = _save(_image(40, 52, 3, 9), no_jp2=True, irreversible=True)
    start, end = _segment(data, j2k.QCD)
    body = data[start + 4:end]
    derived = bytes([(body[0] & 0xE0) | 1]) + body[1:3]
    data = _with_segment(data, j2k.QCD, derived)
    assert held_to_pil(data) == "equal"


def _set_byte(data: bytes, marker: int, offset: int, value: int) -> bytes:
    start, _ = _segment(data, marker)
    out = bytearray(data)
    out[start + 4 + offset] = value
    return bytes(out)


def _refusals() -> dict:
    base = _save(_image(40, 52, 3, 10), no_jp2=True)
    rgn = struct.pack(">BBBB", 0, 0, 0, 5)
    return {
        "code-block style": _set_byte(base, j2k.COD, 8, 0x01),
        "SOP and EPH": _set_byte(base, j2k.COD, 0, 0x06),
        "PPM": _insert(base, j2k.SOT, j2k.PPM, b"\x00"),
        "PPT": _insert(base, j2k.SOD, j2k.PPT, b"\x00"),
        "RGN": _insert(base, j2k.SOT, j2k.RGN, rgn),
        "subsampled": _set_byte(base, j2k.SIZ, 40, 2),   # XRsiz of 1
        "bits": _set_byte(base, j2k.SIZ, 36, 11),
    }


@pytest.mark.parametrize("feature,message", [
    ("code-block style", "code-block style"), ("SOP and EPH", "SOP and EPH"),
    ("PPM", "PPM"), ("PPT", "PPT"), ("RGN", "RGN"),
    ("subsampled", "subsampled"), ("bits", "12 bits")])
def test_refused_features_are_named(feature, message):
    """What OpenJPEG reads and no encoder here writes raises
    NotImplementedError naming it: code-block styles other than 0, SOP and
    EPH, PPM and PPT, RGN, subsampled components, 12-bit components."""
    data = _refusals()[feature]
    with pytest.raises(NotImplementedError, match=message):
        ttex.decode_image(data)


def test_avif_is_refused():
    """AVIF, which PIL opens through libavif, is decoded since, quantizer
    matrices (aom's enable-qm) too, and an AVIF whose frame libavif
    scales to another ispe size (refused before its slice) too."""
    buf = io.BytesIO()
    Image.fromarray(_image(16, 16, 3, 11)).save(
        buf, "AVIF", quality=60, advanced={"enable-qm": "1"})
    assert held_to_pil(buf.getvalue()) == "equal"
    data = buf.getvalue()
    at = data.index(b"ispe") + 8
    scaled = data[:at] + struct.pack(">II", 24, 20) + data[at + 8:]
    assert pil_outcome(scaled).shape == (20, 24, 3)
    assert held_to_pil(scaled) == "equal"


# ---------------------------------------------------------------------------
# cut and mutated streams
# ---------------------------------------------------------------------------

def _small_files() -> list:
    out = []
    for path in JPEG2000:
        if path != BIG:
            with open(path, "rb") as f:
                out.append(f.read())
    return out


@pytest.mark.parametrize("path", [f for f in JPEG2000 if f != BIG],
                         ids=os.path.basename)
def test_cut_streams(path):
    """Each committed file cut by 1 to 40 bytes: PIL raises on all 40
    (OpenJPEG's decoder is strict and wants EOC), and so does the port."""
    with open(path, "rb") as f:
        data = f.read()
    assert {held_to_pil(data[:-k]) for k in range(1, 41)} == {"raise"}


def test_cut_big_stream():
    """The 2048x2048 file cut by 1, 2 and 40 bytes."""
    with open(BIG, "rb") as f:
        data = f.read()
    assert {held_to_pil(data[:-k]) for k in (1, 2, 40)} == {"raise"}


@pytest.mark.parametrize("seed", range(6))
def test_mutation_fuzz(seed):
    """60 mutations a seed (360 in all) of the committed files but the
    2048x2048 one, each of 1-3 bytes (a random value, or one bit
    flipped): the port is byte-equal wherever PIL decodes, raises
    ValueError wherever PIL raises, or names a feature it does not decode."""
    files = _small_files()
    rng = np.random.default_rng(1000 + seed)
    seen = []
    for _ in range(60):
        data = bytearray(files[int(rng.integers(0, len(files)))])
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(data)))
            data[i] = (int(rng.integers(0, 256)) if rng.random() < 0.7
                       else data[i] ^ (1 << int(rng.integers(0, 8))))
        seen.append(held_to_pil(bytes(data)))
    assert seen.count("equal") >= 20
