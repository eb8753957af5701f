"""The port's AVIF decoder on what its still-image path refused: aom's
quantizer matrices, film grain (dav1d's synthesis), PIL's image sequences
(libavif's track source) and grid items, against PIL 12.1's libavif 1.3
with dav1d: byte-equal, no tolerance.

Every committed file of scenes/data/formats_f is held to its digest and to
the JAX package's `load_image(path, 1.0)`; seeded sweeps over aom's film
grain test vectors 1-16, quantizer-matrix level ranges at each
subsampling, sequences with alpha and grids of 1x2, 2x1 and 3x3 tiles with
odd and cropped outputs are held to PIL's decode; the grain's clipping and
overlap flags, which aom's vectors leave unset, are set by hand; streams
cut by 1 to 40 bytes and a 240-case mutation fuzz (half of the mutations
in the boxes before the media data: meta, grid, iref, moov) are held to
PIL's outcome. No case is refused by name.
"""
import hashlib
import io
import os

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from test_torch_gpu import FORMAT_F_DIGESTS, FORMAT_F_FRAMES
from test_torch_image_avif import _content, _save
from test_torch_image_jpeg2000 import held_to_pil, pil_outcome
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from rlshaders_tpu_torch.scene import av1, avif
from rlshaders_tpu_torch.scene import texture as ttex

FOLDER = "scenes/data/formats_f"
BIGS = [f"{FOLDER}/texture_2048_grain.avif",
        f"{FOLDER}/texture_2048_grid.avif"]
FILES = sorted(FORMAT_F_DIGESTS)
SMALL = [f for f in FILES if f not in BIGS]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _frames(frames: list, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    imgs = [Image.fromarray(f).convert(mode) for f in frames]
    imgs[0].save(buf, "AVIF", save_all=True, append_images=imgs[1:],
                 max_threads=1, **kw)
    return buf.getvalue()


def _headers(data: bytes) -> list:
    """The frame headers of a file's colour image (each tile of a grid)."""
    c = avif.parse(data)
    payloads = ([c["color"]] if c["grid"] is None else
                [p for p, _ in c["grid"]["tiles"]])
    return [av1.parse(p)[1] for p in payloads]


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def test_digests_cover_the_files():
    """Every file of scenes/data/formats_f is pinned, in both copies of the
    digests; both copies name frames M and N alike; the folder stays
    under about 1 MB."""
    names = sorted(f"{FOLDER}/{n}" for n in os.listdir(FOLDER))
    assert names == FILES
    assert chip_smoke.FORMAT_F_DIGESTS == FORMAT_F_DIGESTS
    assert chip_smoke.FORMAT_F_FRAMES == FORMAT_F_FRAMES
    assert sum(os.path.getsize(f) for f in FILES) < 1_000_000


def test_the_tool_writes_the_committed_files():
    """tools/make_image_formats.py formats_f writes the committed bytes
    (the two 2048x2048 files are held to PIL and their digests below)."""
    made = fm.files_f(big=False)
    assert sorted(made) == sorted(os.path.basename(f) for f in SMALL)
    for path in SMALL:
        assert _read(path) == made[os.path.basename(path)], path


@pytest.mark.parametrize("path", SMALL, ids=os.path.basename)
def test_committed_file(tmp_path, path):
    data = _read(path)
    assert ttex.image_format(data) == Image.open(io.BytesIO(data)).format
    want = same_as_reference(tmp_path, data, os.path.basename(path))
    assert hashlib.sha256(want.tobytes()).hexdigest() == FORMAT_F_DIGESTS[
        path]


@pytest.mark.parametrize("path", BIGS, ids=os.path.basename)
def test_big_file(tmp_path, path):
    """The 2048x2048 texture with film grain (aom's vector 1 at PIL's
    defaults: 4x2 tiles of 128x128 superblocks), and as a 2x2 grid of
    1024x1024 tiles: PIL's bytes, its digest and the JAX package's
    load."""
    data = _read(path)
    heads = _headers(data)
    if "grain" in path:
        assert len(heads) == 1 and heads[0]["apply_grain"]
    else:
        c = avif.parse(data)
        assert (c["grid"]["rows"], c["grid"]["cols"]) == (2, 2)
        assert c["grid"]["size"] == (2048, 2048) and len(heads) == 4
    want = same_as_reference(tmp_path, data, os.path.basename(path))
    assert hashlib.sha256(want.tobytes()).hexdigest() == FORMAT_F_DIGESTS[
        path]


def test_files_reach_each_feature():
    """The committed files hold quantizer matrices (luma and chroma levels
    below 15) at 4:2:0, 4:2:2, 4:4:4 and 4:0:0; film grain with chroma
    from luma, with chroma scaling points, AR lags 2 and 3, overlap and
    clipping, at every subsampling and 1x1, with alpha; sequences (the
    track source) with alpha; grids of odd width and an alpha grid."""
    seen = set()
    for path in FILES:
        data = _read(path)
        c = avif.parse(data)
        seen |= {"track"} if c["track"] else set()
        if c["grid"] is not None:
            seen.add("grid")
            seen |= {"alpha grid"} if c["alpha_grid"] is not None else set()
            seen |= {"odd grid"} if c["grid"]["size"][0] % 2 else set()
        for h in _headers(data):
            seq = av1.parse(c["color"] if c["grid"] is None
                            else c["grid"]["tiles"][0][0])[0]
            sub = "400" if seq["mono"] else ("420", "422", "444")[
                2 - seq["ss_x"] - seq["ss_y"]]
            if h["qm_y"] < 15:
                seen |= {f"qm {sub}", "qm"}
                seen |= {"qm chroma"} if h["qm_u"] < 15 else set()
            if h["apply_grain"]:
                seen |= {f"grain {sub}", f"grain lag {h['ar_coeff_lag']}"}
                for k in ("chroma_scaling_from_luma", "overlap_flag",
                          "clip_to_restricted_range"):
                    seen |= {k} if h[k] else set()
                seen |= {"grain chroma"} if h["num_uv_points"][0] else set()
                seen |= {"grain 1x1"} if h["width"] == 1 else set()
                seen |= {"grain alpha"} if c["alpha"] is not None else set()
    assert {"track", "grid", "alpha grid", "odd grid", "qm", "qm chroma",
            "qm 420", "qm 422", "qm 444", "qm 400", "grain 420",
            "grain 422", "grain 444", "grain 400", "grain lag 2",
            "grain lag 3", "chroma_scaling_from_luma", "overlap_flag",
            "clip_to_restricted_range", "grain chroma", "grain 1x1",
            "grain alpha"} <= seen


# ---------------------------------------------------------------------------
# seeded sweeps
# ---------------------------------------------------------------------------

def _px(k: int, alpha: bool):
    rng = np.random.default_rng(16000 + k)
    h, w = (int(v) for v in rng.integers(1, 80, 2))
    px = _content(("photo", "gradient", "flat")[k % 3], h, w, rng)
    if alpha:
        px = np.dstack([px, rng.integers(0, 256, (h, w)).astype(np.uint8)])
    return px, rng


@pytest.mark.parametrize("chunk", range(4))
def test_film_grain_vectors(chunk):
    """aom's film grain test vectors 1-16 (4 a chunk), each on a seeded
    image of 1-79 pixels a side at a random subsampling, with alpha for
    one in three: PIL's bytes."""
    for vector in range(4 * chunk + 1, 4 * chunk + 5):
        px, rng = _px(vector, vector % 3 == 0)
        sub = str(rng.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"]))
        data = _save(px, "RGBA" if px.shape[2] == 4 else None,
                     quality=int(rng.integers(20, 90)), subsampling=sub,
                     advanced={"film-grain-test": str(vector)})
        assert _headers(data)[0]["apply_grain"], vector
        assert held_to_pil(data) == "equal", (vector, px.shape, sub)


@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_quantizer_matrix_ranges(sub):
    """Quantizer matrices over seeded qm-min and qm-max ranges at each
    subsampling, on a 96x128 crop of the 2048x2048 texture whose blocks
    take the rectangular transform sizes: PIL's bytes."""
    tex = np.asarray(Image.open(io.BytesIO(_read(BIGS[0]))).convert("RGB"))
    rng = np.random.default_rng(len(sub) + ord(sub[2]))
    for _ in range(3):
        lo = int(rng.integers(0, 15))
        hi = int(rng.integers(lo, 16))
        y, x = (int(v) for v in rng.integers(0, 1900, 2))
        data = _save(np.ascontiguousarray(tex[y:y + 96, x:x + 128]),
                     quality=int(rng.integers(20, 80)),
                     speed=int(rng.integers(0, 9)), subsampling=sub,
                     advanced={"enable-qm": "1", "qm-min": str(lo),
                               "qm-max": str(hi)})
        assert held_to_pil(data) == "equal", (sub, lo, hi)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_sequences(mode):
    """PIL's image sequences of 2-4 seeded frames, at each subsampling,
    RGBA with and without premultiplied alpha: frame 0 of the colour
    track (and its alpha track), PIL's bytes."""
    for k, sub in enumerate(["4:2:0", "4:2:2", "4:4:4", "4:0:0"]):
        px, rng = _px(40 + k, mode == "RGBA")
        frames = [px] + [np.roll(px, 3 * i, 1)
                         for i in range(1, int(rng.integers(2, 5)))]
        kw = {"alpha_premultiplied": True} if k % 2 and mode == "RGBA" \
            else {}
        data = _frames(frames, mode, subsampling=sub, **kw)
        assert avif.parse(data)["track"]
        assert held_to_pil(data) == "equal", (mode, sub, px.shape)


def test_sequence_source():
    """libavif takes a sequence's tracks where the major brand is avis:
    with the primary item moved onto another sample PIL still decodes
    frame 0, as does the port; with the major brand avif it takes the
    primary item, and so does the port."""
    data = _read(f"{FOLDER}/photo_sequence.avif")
    c = avif.parse(data)
    at = data.index(c["color"])
    first = at.to_bytes(4, "big") + len(c["color"]).to_bytes(4, "big")
    i = data.index(first)
    moved = (data[:i] + (at + 100).to_bytes(4, "big") + first[4:]
             + data[i + 8:])
    assert held_to_pil(moved) == "equal"
    as_item = data[:8] + b"avif" + data[12:]
    assert not avif.parse(as_item)["track"]
    assert held_to_pil(as_item) == "equal"


def _grid_tiles(px, rows, cols, tw, th, mode="RGB", **kw):
    return [_save(np.ascontiguousarray(px[r * th:(r + 1) * th,
                                          c * tw:(c + 1) * tw]), mode, **kw)
            for r in range(rows) for c in range(cols)]


GRIDS = [
    # rows, cols, tile w, h, output w, h, subsampling, alpha, 32-bit,
    # ispe (None: the output size), tiles left out, PIL's outcome
    (1, 2, 64, 64, 128, 64, "4:2:0", False, False, None, 0, "equal"),
    (2, 1, 64, 66, 64, 130, "4:2:0", False, True, None, 0, "equal"),
    (3, 3, 70, 64, 207, 185, "4:4:4", False, False, None, 0, "equal"),
    (2, 2, 64, 64, 100, 80, "4:2:2", True, False, None, 0, "equal"),
    (2, 3, 64, 64, 190, 128, "4:0:0", False, False, None, 0, "equal"),
    (1, 2, 64, 64, 128, 64, "4:2:0", True, False, (100, 50), 0, "equal"),
    (2, 2, 64, 64, 120, 100, "4:2:0", False, False, (128, 128), 0,
     "raise"),
    # what libavif refuses: small tiles, an odd 4:2:0 output, a spare
    # column, fewer tiles than cells
    (1, 2, 48, 64, 96, 64, "4:2:0", False, False, None, 0, "raise"),
    (2, 2, 64, 64, 120, 101, "4:2:0", False, False, None, 0, "raise"),
    (2, 2, 64, 64, 64, 100, "4:2:0", False, False, None, 0, "raise"),
    (2, 2, 64, 64, 128, 128, "4:2:0", False, False, None, 1, "raise"),
]


@pytest.mark.parametrize("case", range(len(GRIDS)))
def test_grids(case):
    """Grids this test builds from PIL's AV1 payloads (PIL writes none):
    1x2, 2x1 and 3x3 tiles, odd and cropped outputs, 32-bit sizes, an
    alpha grid, each subsampling, an ispe other than the output (Pillow
    reads the output's rows as rows of the ispe's width, or finds the
    file truncated), and the grids libavif refuses: each outcome PIL's."""
    rows, cols, tw, th, ow, oh, sub, alpha, big, ispe, short, want = \
        GRIDS[case]
    px, _ = _px(60 + case, alpha)
    px = np.pad(px, ((0, rows * th), (0, cols * tw), (0, 0)), "reflect")
    tiles = _grid_tiles(px, rows, cols, tw, th, "RGBA" if alpha else "RGB",
                        subsampling=sub, quality=60)
    data = fm.avif_grid(tiles[:len(tiles) - short], rows, cols, ow, oh,
                        big=big, alpha=alpha, ispe=ispe)
    assert held_to_pil(data) == want, case


@pytest.mark.parametrize("which", [1, 2])
def test_grain_flags_set_by_hand(which):
    """aom's vectors never set clip_to_restricted_range, and vector 1 no
    overlap: each set by hand in a grain file's frame header, PIL's
    bytes (dav1d clips to 16-235 for luma, 16-240 for chroma; blends the
    blocks' edges)."""
    lrgba = np.asarray(Image.open("scenes/data/logo.png"))
    base = _save(np.ascontiguousarray(lrgba[:96, :160, :3]), quality=40,
                 advanced={"film-grain-test": "1"})
    data = fm.grain_flag(base, which)
    assert data != base
    assert not np.array_equal(pil_outcome(data), pil_outcome(base))
    assert held_to_pil(data) == "equal"


# ---------------------------------------------------------------------------
# cut and mutated streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", SMALL, ids=os.path.basename)
def test_cut_streams(path):
    """Each committed file cut by 1 to 40 bytes: the port's outcome is
    PIL's on each (an item, sample or tile extent runs past the file)."""
    data = _read(path)
    for k in range(1, 41):
        held_to_pil(data[:-k])


@pytest.mark.parametrize("seed", range(4))
def test_mutation_fuzz(seed):
    """60 mutations a seed (240 in all) of the committed files but the
    2048x2048 ones, each of 1-3 bytes (a random value, or one bit
    flipped), half of them in the boxes before the media data (meta with
    its grid, iref and iloc boxes, moov with its sample tables): the port
    is byte-equal wherever PIL decodes and raises wherever PIL raises."""
    files = [_read(p) for p in SMALL]
    rng = np.random.default_rng(16200 + seed)
    seen = []
    for _ in range(60):
        data = bytearray(files[int(rng.integers(0, len(files)))])
        head = data.index(b"mdat") if b"mdat" in data else len(data)
        for _ in range(int(rng.integers(1, 4))):
            top = head if rng.random() < 0.5 else len(data)
            i = int(rng.integers(0, top))
            data[i] = (int(rng.integers(0, 256)) if rng.random() < 0.7
                       else data[i] ^ (1 << int(rng.integers(0, 8))))
        seen.append(held_to_pil(bytes(data)))
    assert "refused" not in seen
    assert seen.count("equal") >= 5


@pytest.mark.parametrize("mc", [4, 7, 8])
def test_float_conversion_of_subsampled_chroma(mc):
    """The matrix coefficients libavif converts itself in float32 (FCC,
    SMPTE 240M, YCgCo) on 4:2:0 and 4:2:2 chroma of odd and even sizes,
    with and without alpha: libavif's bilinear chroma upsampling, PIL's
    bytes."""
    for name in ("odd_grain_rgba.avif", "photo_qm_422.avif",
                 "logo_odd_grain_csfl.avif"):
        data = _read(f"{FOLDER}/{name}")
        at = data.index(b"nclx") + 9
        assert held_to_pil(data[:at] + bytes([mc]) + data[at + 1:]) == \
            "equal", (name, mc)


def _set(data: bytes, at: int, value: int) -> bytes:
    return data[:at] + bytes([value]) + data[at + 1:]


def _iloc_entry(data: bytes, k: int) -> int:
    """Where the k-th item's entry of a version-0 iloc with 4-byte
    offsets and lengths (PIL's and avif_grid's) starts."""
    return data.index(b"iloc") + 12 + 14 * k


def _ipma_entry(data: bytes, item: int) -> int:
    """Where an item's association list of a version-0 ipma starts."""
    at = data.index(b"ipma") + 12
    while True:
        i, n = int.from_bytes(data[at:at + 2], "big"), data[at + 2]
        if i == item:
            return at + 3
        at += 3 + n


def _assoc_of(data: bytes, item: int, kind: bytes) -> int:
    """Where an item's association with its `kind` property sits."""
    props, at = [], data.index(b"ipco") + 4
    end = at - 8 + int.from_bytes(data[at - 8:at - 4], "big")
    while at < end:
        props.append(data[at + 4:at + 8])
        at += int.from_bytes(data[at:at + 4], "big")
    at = _ipma_entry(data, item)
    while props[(data[at] & 0x7F) - 1] != kind:
        at += 1
    return at


# mutations that found a libavif or dav1d check (or its absence): the
# file, the change, and PIL's outcome
CONTAINER_CASES = {
    # pixi: 1 to 4 planes of one depth, whatever its flags
    "pixi of 0 planes": ("logo_qm.avif", lambda d: _set(
        d, d.index(b"pixi") + 8, 0), "raise"),
    "pixi of 5 planes": ("logo_qm.avif", lambda d: _set(
        d, d.index(b"pixi") + 8, 5), "raise"),
    "pixi of 2 planes of 3": ("logo_qm.avif", lambda d: _set(
        d, d.index(b"pixi") + 8, 2), "equal"),
    "pixi depths differ": ("odd_sequence_444.avif", lambda d: _set(
        d, d.index(b"pixi") + 9, 0), "raise"),
    "pixi flags set": ("photo_grain_400.avif", lambda d: _set(
        d, d.index(b"pixi") + 5, 161), "equal"),
    # an iref entry's ids are read on from its header, not its size
    "iref auxl of no ids": ("logo_qm.avif", lambda d: _set(
        d, d.index(b"auxl") + 7, 0), "raise"),
    # a box of size 0 only at the top level
    "ispe of size 0": ("odd_grain_rgba.avif", lambda d: _set(
        d, d.index(b"ispe") - 1, 0), "raise"),
    # two nclx colr boxes on the colour item
    "two colr": ("photo_grain_400.avif", lambda d: _set(
        d, _assoc_of(d, 1, b"pixi"), 0x80 | (d[_assoc_of(
            d, 1, b"colr")] & 0x7F)), "raise"),
    # an alpha item with no extent is not the alpha; one with no av1C
    # fails the file
    "alpha of no extent": ("logo_qm.avif", lambda d: _set(
        d, _iloc_entry(d, 1) + 5, 0), "equal"),
    "alpha of no av1C": ("logo_qm.avif", lambda d: _set(
        d, _assoc_of(d, 2, b"av1C"), 0x80 | (d[_assoc_of(
            d, 2, b"auxC")] & 0x7F)), "raise"),
    # dav1d ignores the OBU forbidden bit
    "forbidden bit": ("photo_qm_420.avif", lambda d: _set(
        d, d.index(avif.parse(d)["color"]),
        d[d.index(avif.parse(d)["color"])] | 0x80), "equal"),
    # a grid's tiles share one dav1d decoder and its sequence header: the
    # last tile's extent one byte early
    "grid tile without its header": ("grid_3x3_odd_444.avif", lambda d: _set(
        d, _iloc_entry(d, 9) + 9, d[_iloc_entry(d, 9) + 9] - 1), "equal"),
    # libavif's dimension limit on every image item's ispe
    "ispe past the limit": ("odd_grain_rgba.avif", lambda d: _set(
        d, d.index(b"ispe") + 9, 0x90), "raise"),
    # item ids are not 0
    "iloc of item 0": ("logo_sequence_rgba.avif", lambda d: _set(
        d, _iloc_entry(d, 0) + 1, 0), "raise"),
    "infe of item 0": ("logo_sequence_rgba.avif", lambda d: _set(
        d, d.index(b"infe") + 9, 0), "raise"),
    # tracks: no mvhd, hdlr or stts needed; Pillow divides by the colour
    # track's timescale (mdhd's, read at that box's version)
    "no mvhd": ("photo_sequence.avif", lambda d: _set(
        d, d.index(b"mvhd"), ord("X")), "equal"),
    "no stts": ("photo_sequence.avif", lambda d: _set(
        d, d.index(b"stts"), ord("X")), "equal"),
    "no mdhd": ("photo_sequence.avif", lambda d: _set(
        d, d.index(b"mdhd"), ord("X")), "raise"),
    "mdhd read as version 0": ("logo_sequence_rgba.avif", lambda d: _set(
        d, d.index(b"mdhd") + 4, 0), "raise"),
    # iinf: its count of boxes read, each an infe; a version above 1
    # refused
    "iinf of one entry fewer": ("odd_sequence_444.avif", lambda d: _set(
        d, d.index(b"iinf") + 9, d[d.index(b"iinf") + 9] - 1), "equal"),
    "iinf of version 2": ("logo_qm.avif", lambda d: _set(
        d, d.index(b"iinf") + 4, 2), "raise"),
    # stsd of version 0 or 1; mvhd not read
    "stsd of version 1": ("odd_sequence_444.avif", lambda d: _set(
        d, d.index(b"stsd") + 4, 1), "equal"),
    "mvhd of version 2": ("odd_sequence_444.avif", lambda d: _set(
        d, d.index(b"mvhd") + 4, 2), "equal"),
    # an essential property libavif does not know: the alpha item is
    # passed over, the colour item refused
    "alpha of an unknown essential property": (
        "logo_qm_444_rgba.avif", lambda d: _set(
            d, d.rindex(b"av1C") + 3, ord("B")), "equal"),
    "colour of an unknown essential property": (
        "photo_qm_420.avif", lambda d: _set(
            d, d.index(b"av1C") + 3, ord("B")), "raise"),
    # a track's auxi is checked as an item's auxC
    "auxi of version 1": ("logo_sequence_rgba.avif", lambda d: _set(
        d, d.index(b"auxi\x00\x00\x00\x00") + 4, 1), "raise"),
    "alpha track of no sample table": ("logo_sequence_rgba.avif", lambda d:
        _set(d, d.rindex(b"stbl"), ord("X")), "equal"),
}


@pytest.mark.parametrize("case", sorted(CONTAINER_CASES))
def test_container_checks(case):
    """Single changes to the committed files, each at a check of
    libavif's (or dav1d's) that a probe of every byte before the media
    data found: the port's outcome is PIL's."""
    name, change, want = CONTAINER_CASES[case]
    data = change(_read(f"{FOLDER}/{name}"))
    assert held_to_pil(data) == want, case
