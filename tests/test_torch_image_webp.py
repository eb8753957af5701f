"""The port's WebP decoders (scene/webp.py over vp8l.py and vp8.py) against
PIL 12.1's libwebp 1.6, the decoder behind the JAX package's
`Image.open(path).convert("RGB")`: byte-equal, no tolerance.

The images are seeded (numpy default_rng, seeds stated in each test) and
written by PIL in the test: lossless files over every `method` with few
(palette and pixel bundling), many and all colours, with and without
alpha, at widths 1-67; lossy files over the quality range at sizes no
multiple of 16; VP8X files with alpha, ICC, EXIF and XMP chunks.
tools/make_image_formats.py's own writers make the features PIL's
writer never sets: `vp8_frame` (a boolean encoder) the simple loop
filter, 2, 4 and 8 token partitions, sharpness, segments and filter
deltas; `vp8l_stream` every predictor mode, palette indices past the
palette, and every prefix-code form.
Every committed file of scenes/data/formats_c is held to its digest and
to the JAX package's `load_image(path, 1.0)`; broken containers and
streams are refused wherever PIL refuses them, an animated file with
NotImplementedError.
"""
import hashlib
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from test_torch_gpu import FORMAT_C_DIGESTS
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from rlshaders_tpu_torch.scene import texture as ttex
from rlshaders_tpu_torch.scene import vp8

FOLDER = "scenes/data/formats_c"
BIG = f"{FOLDER}/texture_2048.webp"
FILES = sorted(FORMAT_C_DIGESTS)


def _save(px: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _pil(data: bytes):
    """PIL's convert("RGB") of the bytes, or None where PIL refuses."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except (OSError, ValueError, SyntaxError, EOFError):
        return None


def _same(data: bytes) -> np.ndarray:
    want = _pil(data)
    assert want is not None
    got = ttex.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    return want


def _agree(data: bytes, what: str = "") -> None:
    """The port decodes what PIL decodes, to the same bytes, and refuses
    (ValueError) what PIL refuses."""
    want = _pil(data)
    if want is None:
        with pytest.raises(ValueError):
            ttex.decode_image(data)
    else:
        got = ttex.decode_image(data)
        assert np.array_equal(got, want), what


def _image(rng, h: int, w: int, kind: str) -> np.ndarray:
    """A seeded image: `few` (at most 16 colours), `many` (at most 256),
    `noise` or `smooth` (a random walk), RGB or with an `a` suffix RGBA."""
    c = 4 if kind.endswith("a") else 3
    kind = kind.rstrip("a")
    if kind in ("few", "many"):
        pal = rng.integers(0, 256, (int(rng.integers(
            1, 17) if kind == "few" else rng.integers(17, 257)), c),
            np.uint8)
        return pal[rng.integers(0, len(pal), (h, w))]
    if kind == "noise":
        return rng.integers(0, 256, (h, w, c), np.uint8)
    steps = rng.integers(-5, 6, (h, w, c))
    return (np.cumsum(np.cumsum(steps, 0), 1) + 128).astype(np.uint8)


# ---------------------------------------------------------------------------
# lossless (VP8L)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["few", "fewa", "many", "manya", "noise",
                                  "smootha"])
@pytest.mark.parametrize("method", range(7))
def test_lossless_fuzz(method, kind):
    """Three images a case (seed 100 * method + the kind's index), widths
    1-67: the transforms, the colour cache, the meta prefix codes and
    LZ77 as libwebp's encoder picks them at each method."""
    rng = np.random.default_rng(100 * method + len(kind) * 7 + ord(kind[0]))
    for _ in range(3):
        w, h = (int(v) for v in rng.integers(1, 68, 2))
        px = _image(rng, h, w, kind)
        exact = bool(rng.integers(0, 2))
        data = _save(px, lossless=True, method=method,
                     quality=int(rng.integers(0, 101)), exact=exact)
        assert data[12:16] in (b"VP8L", b"VP8X")
        want = _same(data)
        if exact or px.shape[-1] == 3:    # else RGB under alpha 0 may move
            assert np.array_equal(want, px[..., :3])


@pytest.mark.parametrize("seed", range(16))
def test_written_vp8l_features(seed):
    """Streams of tools/make_image_formats.py's VP8L writer (`vp8l_stream`,
    seeded): the transforms in random order and subsets, predictor tiles
    of every mode 0-15 (libwebp reads 14 and 15 as 0), seeded cross-colour
    multipliers, palettes of 1-256 colours whose indices run past their
    end, colour caches of 1-11 bits, meta prefix codes, copies by both
    distance forms, simple codes and normal ones with every repeat code
    and max_symbol. What PIL's writer never sets, held to PIL."""
    rng = np.random.default_rng(seed)
    w, h = (int(v) for v in rng.integers(1, 48, 2))
    order = [t for t in rng.permutation(4).tolist() if rng.random() < 0.75]
    colours = int(rng.choice([1, 2, 3, 4, 5, 16, 17, 200, 256]))
    _same(fm.riff_webp([(b"VP8L", fm.vp8l_stream(w, h, 1000 + seed, order,
                                                  colours))]))


def test_lossless_keeps_rgb_under_alpha():
    """PIL does not premultiply: with `exact`, RGB under alpha 1-254 comes
    back as written (seed 7)."""
    rng = np.random.default_rng(7)
    px = rng.integers(0, 256, (21, 34, 4), np.uint8)
    px[..., 3] = rng.integers(1, 255, (21, 34))
    got = ttex.decode_image(_save(px, lossless=True, exact=True))
    assert np.array_equal(got, px[..., :3])


# ---------------------------------------------------------------------------
# lossy (VP8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [0, 5, 20, 50, 75, 90, 100])
@pytest.mark.parametrize("kind", ["noise", "smooth", "smootha"])
def test_lossy_fuzz(quality, kind):
    """Three images a case (seed quality * 10 + the kind's length), sizes
    1-80 (no multiple of 16 but by chance), `method` 0-6: modes, tokens,
    segments and the normal filter as libwebp's encoder sets them, then
    its fancy upsampling and RGB conversion. With alpha the file is
    VP8X, ALPH and VP8."""
    rng = np.random.default_rng(quality * 10 + len(kind))
    for _ in range(3):
        w, h = (int(v) for v in rng.integers(1, 81, 2))
        data = _save(_image(rng, h, w, kind), quality=quality,
                     method=int(rng.integers(0, 7)))
        _same(data)


@pytest.mark.parametrize("w,h", [(1, 1), (17, 33), (33, 17), (2, 3),
                                 (16, 16), (31, 2)])
def test_lossy_odd_sizes(w, h):
    """The padded macroblock grid cropped, and the upsampler's first and
    last rows and columns at odd and even sizes (seed w * h)."""
    rng = np.random.default_rng(w * h)
    _same(_save(_image(rng, h, w, "smooth"), quality=80))


def test_rgb_conversion_probes():
    """libwebp's fixed-point YUV to RGB, recovered by probing PIL with
    flat images, ramps and a checker: (255, 0, 0) at quality 100 reads
    (255, 1, 0) and (10, 200, 30) reads (10, 200, 29)."""
    for rgb, read in (((255, 0, 0), (255, 1, 0)),
                      ((10, 200, 30), (10, 200, 29))):
        got = ttex.decode_image(_save(np.full((16, 16, 3), rgb, np.uint8),
                                      quality=100))
        assert (got == read).all()
    ramp = np.zeros((24, 256, 3), np.uint8)
    ramp[..., 0] = np.arange(256)
    ramp[8:16, :, 1] = np.arange(256)[::-1]
    ramp[16:, :, 2] = np.arange(256)
    _same(_save(ramp, quality=100))
    checker = ((np.indices((40, 40)).sum(0) % 2) * 255).astype(np.uint8)
    _same(_save(np.stack([checker, 255 - checker, checker], -1),
                quality=100))
    grey = np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 3, 2)
    _same(_save(np.repeat(grey, 4, 0), quality=100))


@pytest.mark.parametrize("case", [
    dict(simple=True, level=30), dict(simple=True, level=63, sharpness=7),
    dict(sharpness=1), dict(sharpness=4, level=50), dict(sharpness=7),
    dict(partitions=2), dict(partitions=4), dict(partitions=8),
    dict(segments=True), dict(segments=True, level=0),
    dict(deltas=True), dict(segments=True, deltas=True, simple=True),
    dict(skip=False, updates=0), dict(q=0, level=0), dict(q=127, level=63),
], ids=lambda c: "-".join(f"{k}{int(v)}" for k, v in c.items()))
def test_written_vp8_features(case):
    """Frames of tools/make_image_formats.py's VP8 writer (seeded modes,
    every sub-block mode among them, and coefficients of every token
    category, seed 40 and 41) at two sizes no multiple of 16, each held
    to PIL: what PIL's writer never sets."""
    for seed, (w, h) in ((40, (33, 17)), (41, (50, 70))):
        frame = fm.vp8_frame(w, h, seed, **case)
        _same(fm.riff_webp([(b"VP8 ", frame)]))


@pytest.mark.parametrize("seed", range(6))
def test_written_vp8_past_the_exact_range(seed):
    """Coefficients whose dequantized values pass libwebp's exact range
    (the writer's `exact=False`, seed 60 + seed, quantizer 100-127): its
    SSE2 transform, which wraps in 16-bit lanes, takes a luma block with
    tokens past position 3 and both chroma planes' blocks where one holds
    an AC token, its C code the rest; the port's `vp8.idct16` and
    `idct` follow the same choice."""
    for w, h in ((40, 40), (23, 57)):
        frame = fm.vp8_frame(w, h, 60 + seed, q=100 + 5 * seed,
                             segments=seed % 2 == 1, exact=False)
        _same(fm.riff_webp([(b"VP8 ", frame)]))


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

def test_vp8x_chunks():
    """Alpha (ALPH with the lossy image, or in VP8L), an ICC profile,
    EXIF and XMP, alone and together (seed 11)."""
    rng = np.random.default_rng(11)
    px = _image(rng, 30, 45, "smootha")
    icc = fm._srgb_icc()
    for kw in ({"quality": 60}, {"quality": 60, "icc_profile": icc},
               {"quality": 60, "exif": b"Exif\x00\x00II*\x00"},
               {"quality": 60, "xmp": b"<x:xmpmeta/>"},
               {"lossless": True, "icc_profile": icc, "exif": b"Ex"},
               {"quality": 90, "icc_profile": icc, "exif": b"E",
                "xmp": b"<x/>"}):
        data = _save(px, **kw)
        assert data[12:16] == b"VP8X"
        _same(data)
        _same(_save(px[..., :3], **kw))


def _chunks(data: bytes) -> list:
    out, pos = [], 12
    while pos < len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def test_container_variants_agree_with_pil():
    """Broken and unusual containers built from valid files (seed 12):
    the port decodes each one PIL decodes, to the same bytes, and raises
    ValueError where PIL refuses (RIFF sizes too small, too large or
    leaving a partial chunk header, chunks past the RIFF, a canvas
    unlike the image, unknown VP8X flags, ALPH after the image or apart
    from it, two images, none, a damaged frame header)."""
    rng = np.random.default_rng(12)
    px = _image(rng, 20, 30, "smootha")
    simple = _save(px[..., :3], quality=70)
    lossless = _save(px[..., :3], lossless=True)
    alpha = _save(px, quality=70)
    vp8_ = _chunks(simple)[0][1]
    alph = _chunks(alpha)[1][1]
    vp8x = fm.vp8x_chunk(30, 20, 0x10)
    riff = struct.unpack_from("<I", simple, 4)[0]

    def with_riff(data, size):
        return data[:4] + struct.pack("<I", size) + data[8:]

    variants = {
        "riff below 8": with_riff(simple, 4),
        "riff past the file": with_riff(simple, riff + 10),
        "riff cuts the chunk": with_riff(simple, riff - 6),
        "bytes past the riff": simple + b"garbage!",
        "3 bytes left in the riff": with_riff(simple + bytes(3), riff + 3),
        "a trailing unknown chunk": fm.riff_webp([(b"VP8 ", vp8_),
                                                  (b"ABCD", b"1234")]),
        "a trailing ALPH": fm.riff_webp([(b"VP8 ", vp8_), (b"ALPH", alph)]),
        "a trailing ALPH, 4 bytes": fm.riff_webp(
            [(b"VP8 ", vp8_), (b"ALPH", alph)])[:-2] + b"\x00\x00",
        "a chunk past the riff": fm.riff_webp([(b"VP8 ", vp8_)])[:-40],
        "truncated file": simple[:len(simple) // 2],
        "lossless truncated": lossless[:len(lossless) - 20],
        "vp8x": fm.riff_webp([(b"VP8X", vp8x), (b"ALPH", alph),
                              (b"VP8 ", vp8_)]),
        "vp8x without alpha flag": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(30, 20, 0)), (b"ALPH", alph),
            (b"VP8 ", vp8_)]),
        "vp8x canvas unlike the image": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(31, 20, 0)), (b"VP8 ", vp8_)]),
        "vp8x unknown flag": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(30, 20, 0x01)), (b"VP8 ", vp8_)]),
        "vp8x short": fm.riff_webp([(b"VP8X", vp8x[:8]), (b"VP8 ", vp8_)]),
        "vp8x alone": fm.riff_webp([(b"VP8X", vp8x)]),
        "vp8x no image": fm.riff_webp([(b"VP8X", vp8x), (b"EXIF", b"ab")]),
        "vp8x ALPH after": fm.riff_webp([(b"VP8X", vp8x), (b"VP8 ", vp8_),
                                         (b"ALPH", alph)]),
        "vp8x ALPH apart": fm.riff_webp([(b"VP8X", vp8x), (b"ALPH", alph),
                                         (b"XYZW", b"ab"), (b"VP8 ", vp8_)]),
        "vp8x two ALPH": fm.riff_webp([(b"VP8X", vp8x), (b"ALPH", alph),
                                       (b"ALPH", alph), (b"VP8 ", vp8_)]),
        "vp8x two images": fm.riff_webp([(b"VP8X", vp8x), (b"VP8 ", vp8_),
                                         (b"VP8 ", vp8_)]),
        "vp8x ALPH then VP8L": fm.riff_webp([
            (b"VP8X", vp8x), (b"ALPH", alph),
            (b"VP8L", _chunks(lossless)[0][1])]),
        "vp8x chunks after the image": fm.riff_webp([
            (b"VP8X", vp8x), (b"ICCP", b"icc"), (b"VP8 ", vp8_),
            (b"EXIF", b"exif"), (b"XMP ", b"x")]),
        "vp8x two vp8x": fm.riff_webp([(b"VP8X", vp8x), (b"VP8X", vp8x),
                                       (b"VP8 ", vp8_)]),
        "not a key frame": fm.riff_webp([(b"VP8 ", bytes([vp8_[0] | 1])
                                          + vp8_[1:])]),
        "profile 4": fm.riff_webp([(b"VP8 ", bytes([vp8_[0] | 8])
                                    + vp8_[1:])]),
        "not shown": fm.riff_webp([(b"VP8 ", bytes([vp8_[0] & ~16])
                                    + vp8_[1:])]),
        "bad start code": fm.riff_webp([(b"VP8 ", vp8_[:3] + b"\x9d\x01\x2b"
                                         + vp8_[6:])]),
        "zero width": fm.riff_webp([(b"VP8 ", vp8_[:6] + b"\x00\xc0"
                                     + vp8_[8:])]),
        "vp8l version 1": fm.riff_webp([(b"VP8L", _chunks(lossless)[0][1][:4]
                                         + bytes([_chunks(lossless)[0][1][4]
                                                  | 0x20])
                                         + _chunks(lossless)[0][1][5:])]),
    }
    for what, data in variants.items():
        _agree(data, what)
    assert _pil(variants["vp8x"]) is not None
    assert _pil(variants["riff below 8"]) is None


@pytest.mark.parametrize("cut", [1, 2, 3, 4, 6, 9, 17, 40])
def test_short_streams_agree_with_pil(cut):
    """A lossy and a lossless stream (seed 13) whose last `cut` bytes are
    gone, the RIFF and chunk sizes made to fit: libwebp refuses a stream
    whose boolean decoder reads past a partition's end, or whose VP8L
    bits run out; the port refuses the same ones."""
    rng = np.random.default_rng(13)
    px = _image(rng, 40, 52, "noise")
    for data in (_save(px, quality=90), _save(px, lossless=True),
                 fm.riff_webp([(b"VP8 ", fm.vp8_frame(40, 24, 13,
                                                      partitions=4))])):
        kind, payload = _chunks(data)[0]
        _agree(fm.riff_webp([(kind, payload[:len(payload) - cut])]),
               f"{kind} less {cut}")


@pytest.mark.parametrize("kind", ["two", "smooth"])
def test_broken_alpha_agrees_with_pil(kind):
    """libwebp decodes the ALPH chunk with the image and fails the file
    on broken alpha; the port decodes the alpha (and drops it) to refuse
    the same files: lossless alpha cut by 1-40 bytes or with a byte
    changed (seed 14), two alpha values (colour indexing alone, which
    libwebp decodes a byte a pixel and lets its last read run past the
    end) or a smooth alpha (the general path)."""
    rng = np.random.default_rng(14)
    px = _image(rng, 30, 41, "smootha")
    if kind == "two":
        px[..., 3] = np.where(px[..., 3] > 128, 255, 40)
    data = _save(px, quality=70)
    vp8x, (alph_kind, alph), vp8_ = _chunks(data)
    assert alph_kind == b"ALPH" and alph[0] & 3 == 1
    variants = [alph[:len(alph) - cut] for cut in (1, 2, 3, 5, 8, 13, 40)]
    for k in rng.integers(1, len(alph), 12).tolist():
        variants.append(alph[:k] + bytes([alph[k] ^ 0x5A]) + alph[k + 1:])
    for a in variants:
        _agree(fm.riff_webp([vp8x, (b"ALPH", a), vp8_]))


def test_animated_webp_is_refused():
    """An animated WebP (VP8X with the animation flag, ANIM and ANMF),
    refused before the port decoded animations: its first frame decodes
    as PIL's does (tests/test_torch_image_webp_anim.py has the rest)."""
    frames = [Image.fromarray(np.full((8, 8, 3), v, np.uint8))
              for v in (10, 200)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:])
    data = buf.getvalue()
    assert Image.open(io.BytesIO(data)).n_frames == 2
    assert ttex.image_format(data) == "WEBP"
    assert np.array_equal(ttex.decode_image(data), _pil(data))


def test_what_pil_does_not_take_for_webp():
    """A RIFF WEBP file whose first chunk is no image chunk is no WebP to
    PIL, and an unknown format to the port."""
    data = fm.riff_webp([(b"ALPH", b"\x00" * 5)])
    assert _pil(data) is None
    assert ttex.image_format(data) == "an unknown format"
    assert ttex.image_format(b"RIFF\x10\x00\x00\x00WAVEfmt ") == \
        "an unknown format"


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def test_digests_cover_the_files():
    """Every file of scenes/data/formats_c is pinned, in both copies of the
    digests, and the tool's entry point writes the committed bytes."""
    names = sorted(f"{FOLDER}/{n}" for n in os.listdir(FOLDER))
    assert names == FILES
    assert chip_smoke.FORMAT_C_DIGESTS == FORMAT_C_DIGESTS
    made = fm.files_c()
    for path in FILES:
        with open(path, "rb") as f:
            assert f.read() == made[os.path.basename(path)], path


@pytest.mark.parametrize("path", [f for f in FILES if f != BIG],
                         ids=os.path.basename)
def test_committed_file(tmp_path, path):
    with open(path, "rb") as f:
        data = f.read()
    assert ttex.image_format(data) == Image.open(io.BytesIO(data)).format
    want = same_as_reference(tmp_path, data, os.path.basename(path))
    assert hashlib.sha256(want.tobytes()).hexdigest() == FORMAT_C_DIGESTS[
        path]


@pytest.fixture(scope="module")
def big():
    """The 2048x2048 lossy file and its decodes by PIL and the port, each
    made once."""
    with open(BIG, "rb") as f:
        data = f.read()
    return data, _pil(data), ttex.decode_image(data)


def test_big_webp(big):
    """The 2048x2048 texture at quality 90: one VP8 chunk of about 225
    KB, decoded to PIL's bytes and its digest."""
    data, want, got = big
    assert [k for k, _ in _chunks(data)] == [b"VP8 "]
    assert 200_000 < len(data) < 250_000
    assert vp8.Frame(_chunks(data)[0][1]).mbw == 128
    assert np.array_equal(got, want)
    assert hashlib.sha256(got.tobytes()).hexdigest() == FORMAT_C_DIGESTS[BIG]


def test_big_webp_matches_the_jax_load(big, tmp_path):
    """The JAX package's load_image of the file (PIL's decode over 255)."""
    from rlshaders_tpu.scene import texture as jtex
    data, _, got = big
    path = tmp_path / "big.webp"
    path.write_bytes(data)
    assert np.array_equal(got.astype(np.float32) / 255.0,
                          jtex.load_image(str(path), 1.0))


def test_committed_webp_features(monkeypatch):
    """The committed lossless files undo each of the four VP8L transforms
    and use the colour cache; the lossy ones hold the simple and the
    normal filter, 2 and 8 partitions, sharpness and segments."""
    from rlshaders_tpu_torch.scene import vp8l
    used = set()
    for name in ("_unpredict", "_uncross", "_add_green", "_unindex",
                 "_lz77"):
        def spy(*a, _f=getattr(vp8l, name), _n=name):
            used.add(_n if _n != "_lz77" else ("cache", a[7] > 0))
            return _f(*a)
        monkeypatch.setattr(vp8l, name, spy)
    for path in FILES:
        if path == BIG:
            continue
        with open(path, "rb") as f:
            data = f.read()
        for kind, payload in (_chunks(data) if data[:4] == b"RIFF" else []):
            if kind == b"VP8L":
                vp8l.decode_vp8l(payload)
            if kind == b"VP8 ":
                f = vp8.Frame(payload)
                used |= {("filter", f.filter), ("parts", len(f.parts)),
                         ("sharp", f.sharpness > 0), ("seg", f.segments)}
    assert {"_unpredict", "_uncross", "_add_green", "_unindex",
            ("cache", True)} <= used
    assert {("filter", 1), ("filter", 2), ("parts", 8), ("parts", 2),
            ("sharp", True), ("seg", 1)} <= used
