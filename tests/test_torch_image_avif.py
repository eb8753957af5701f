"""The port's still-AVIF decoder (scene/avif.py over av1.py, and the native
AV1 tile decoder csrc/av1.cpp) against PIL 12.1's libavif 1.3 with dav1d,
the decoder behind the JAX package's `Image.open(path).convert("RGB")`:
byte-equal, no tolerance.

Every committed file of scenes/data/formats_e is held to its digest and
to the JAX package's `load_image(path, 1.0)`; a seeded sweep over PIL's
documented save options (quality, speed, subsampling, range, tiles, RGBA
and premultiplied alpha, sizes 1-70; photographic, gradient and
flat-colour content) is held to PIL's decode; streams cut by 1 to 40
bytes and a seeded mutation fuzz are held to PIL's outcome (the port
raises wherever PIL raises, decodes PIL's bytes wherever PIL decodes, or
names a feature it does not decode). The tile decoder's tool counters
show that the committed files reach each intra coding tool aom writes
here; the constant tables equal those tools/extract_av1_tables.py reads
from PIL's libavif; the features once left for later (quantizer
matrices, film grain, image sequences) decode to PIL's bytes, and a
frame libavif scales to another ispe size raises NotImplementedError
naming it.
"""
import hashlib
import io
import os
import re
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from test_torch_gpu import FORMAT_E_DIGESTS
from test_torch_image_jpeg2000 import held_to_pil, pil_outcome
from test_torch_image_modes import same_as_reference
from tools import extract_av1_tables as tables
from tools import make_image_formats as fm
from rlshaders_tpu_torch.scene import av1, avif
from rlshaders_tpu_torch.scene import texture as ttex

FOLDER = "scenes/data/formats_e"
BIG = f"{FOLDER}/texture_2048.avif"
FILES = sorted(FORMAT_E_DIGESTS)
SMALL = [f for f in FILES if f != BIG]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _save(px: np.ndarray, mode: str = None, **kw) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(px)
    (img.convert(mode) if mode else img).save(buf, "AVIF", **kw)
    return buf.getvalue()


def _content(kind: str, h: int, w: int, rng) -> np.ndarray:
    """(h, w, 3) uint8: a photograph-like field (smoothed noise), a
    gradient, or flat colour in blocks (screen content)."""
    y, x = np.mgrid[0:h, 0:w]
    if kind == "photo":
        f = rng.normal(0, 6, (h, w, 3)).cumsum(0).cumsum(1)
        return np.clip(f / max(h, w) * 4 + 128, 0, 255).astype(np.uint8)
    if kind == "gradient":
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (x + y) * 127 // max(h + w - 2, 1)],
                        -1).astype(np.uint8)
    cols = rng.integers(0, 256, (4, 3))
    step = int(rng.integers(2, 9))
    return cols[((x // step) + 2 * (y // step)) % 4].astype(np.uint8)


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def test_digests_cover_the_files():
    """Every file of scenes/data/formats_e is pinned, in both copies of the
    digests, and the folder stays under about 1.2 MB."""
    names = sorted(f"{FOLDER}/{n}" for n in os.listdir(FOLDER))
    assert names == FILES
    assert chip_smoke.FORMAT_E_DIGESTS == FORMAT_E_DIGESTS
    assert sum(os.path.getsize(f) for f in FILES) < 1_200_000


def test_the_tool_writes_the_committed_files():
    """tools/make_image_formats.py formats_e writes the committed bytes."""
    made = fm.files_e()
    assert sorted(made) == sorted(os.path.basename(f) for f in FILES)
    for path in FILES:
        assert _read(path) == made[os.path.basename(path)], path


@pytest.mark.parametrize("path", SMALL, ids=os.path.basename)
def test_committed_file(tmp_path, path):
    data = _read(path)
    assert ttex.image_format(data) == Image.open(io.BytesIO(data)).format
    want = same_as_reference(tmp_path, data, os.path.basename(path))
    assert hashlib.sha256(want.tobytes()).hexdigest() == FORMAT_E_DIGESTS[
        path]


def test_big_avif(tmp_path):
    """The 2048x2048 texture at PIL's defaults: 128x128 superblocks in 4x2
    tiles, about 390 KB, decoded to PIL's bytes, its digest and the JAX
    package's load."""
    data = _read(BIG)
    c = avif.parse(data)
    seq, frame, tiles = av1.parse(c["color"])
    assert seq["use_128"] and (frame["tile_cols"], frame["tile_rows"]) == (
        4, 2) and len(tiles) == 8
    assert 350_000 < len(data) < 420_000
    want = same_as_reference(tmp_path, data, "big.avif")
    assert hashlib.sha256(want.tobytes()).hexdigest() == FORMAT_E_DIGESTS[BIG]


def test_orientation_is_metadata_only():
    """An EXIF orientation makes Pillow write irot (6) or imir (2) boxes;
    PIL applies neither to the pixels, and neither does the port."""
    rot = avif.parse(_read(f"{FOLDER}/logo_icc_exif_xmp.avif"))["props"]
    mir = avif.parse(_read(f"{FOLDER}/grid_mirrored.avif"))["props"]
    assert "irot" in rot and "imir" in mir
    for name in ("logo_icc_exif_xmp.avif", "grid_mirrored.avif"):
        data = _read(f"{FOLDER}/{name}")
        img = Image.open(io.BytesIO(data))
        assert img.size == avif.parse(data)["props"]["ispe"]
        assert np.array_equal(ttex.decode_image(data),
                              np.asarray(img.convert("RGB")))


# tools the committed files reach in the tile decoder's counters, and those
# aom does not write here (ROADMAP names them as unverified): segmentation,
# switchable restoration, the 64-point rectangular transforms, and the
# transform types only an inter set holds
UNVERIFIED = {"segmentation", "switchable", "tx_32x64", "tx_64x32",
              "tx_16x64", "tx_64x16", "txtype_flipadst_dct",
              "txtype_dct_flipadst", "txtype_flipadst_flipadst",
              "txtype_adst_flipadst", "txtype_flipadst_adst",
              "txtype_v_adst", "txtype_h_adst", "txtype_v_flipadst",
              "txtype_h_flipadst"}


def test_tool_census():
    """Every partition type, intra mode (with non-zero angle deltas), CFL,
    filter intra, palette, intra block copy, every square transform size
    and 64x64, every intra transform type, lossless, delta q and lf,
    deblocking, CDEF, Wiener and self-guided restoration and more than one
    tile are reached by the committed files."""
    names = av1.census_names()
    total = np.zeros(len(names), np.int64)
    for path in FILES:
        c = avif.parse(_read(path))
        av1.decode_frame(c["color"], total)
        if c["alpha"] is not None:
            av1.decode_frame(c["alpha"], total)
    reached = {n for n, v in zip(names, total) if v}
    assert set(names) - reached == UNVERIFIED


# ---------------------------------------------------------------------------
# PIL's documented save options
# ---------------------------------------------------------------------------

def _sweep_case(k: int):
    """The k-th seeded case: content, size 1-70, and options."""
    rng = np.random.default_rng(7000 + k)
    h, w = (int(v) for v in rng.integers(1, 71, 2))
    px = _content(("photo", "gradient", "flat")[k % 3], h, w, rng)
    kw = {"quality": int(rng.choice([0, 10, 30, 50, 75, 90, 100])),
          "speed": int(rng.integers(0, 11)),
          "subsampling": str(rng.choice(["4:2:0", "4:2:2", "4:4:4",
                                         "4:0:0"]))}
    if rng.random() < 0.3:
        kw["range"] = "limited"
    if rng.random() < 0.2:
        kw.update(tile_rows=1, tile_cols=1, autotiling=False)
    mode = None
    if rng.random() < 0.35:
        alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
        if rng.random() < 0.3:
            alpha[:] = alpha[0, 0]
        px = np.dstack([px, alpha])
        mode = "RGBA"
        if rng.random() < 0.5:
            kw["alpha_premultiplied"] = True
    return px, mode, kw


@pytest.mark.parametrize("chunk", range(4))
def test_option_sweep(chunk):
    """64 seeded cases (16 a chunk) over PIL's documented options, each
    decoded to PIL's bytes."""
    for k in range(16 * chunk, 16 * chunk + 16):
        px, mode, kw = _sweep_case(k)
        data = _save(px, mode, **kw)
        assert held_to_pil(data) == "equal", (k, kw)


def test_one_pixel_and_odd_sizes():
    rng = np.random.default_rng(71)
    for h, w in ((1, 1), (1, 9), (9, 1), (33, 17), (65, 3)):
        for sub in ("4:2:0", "4:2:2"):
            data = _save(_content("photo", h, w, rng), quality=60,
                         subsampling=sub)
            assert held_to_pil(data) == "equal", (h, w, sub)


def test_premultiplied_alpha_edges():
    """Flat colour over noisy alpha, premultiplied, at quality 10: the
    decoded alpha reaches 1 under decoded colour of 128 and more, where
    libyuv's x86 unattenuate saturates a 16-bit lane and gives 0."""
    rng = np.random.default_rng(203016)
    w, h = (int(v) for v in rng.integers(1, 200, 2))
    cols = rng.integers(0, 256, (4, 3))
    y, x = np.mgrid[0:h, 0:w]
    sx, sy = int(rng.integers(2, 12)), int(rng.integers(2, 12))
    px = cols[((x // sx) + (y // sy)) % 4].astype(np.uint8)
    rng.random()
    rng.random()
    alpha = (rng.random((h, w)) * 255).astype(np.uint8)
    data = _save(np.dstack([px, alpha]), "RGBA", quality=10,
                 subsampling="4:2:2", speed=8, range="limited",
                 alpha_premultiplied=True)
    c = avif.parse(data)
    seq, yp, up, vp = av1.decode_frame(c["color"])
    a = av1.decode_frame(c["alpha"])[1]
    rgb = avif.to_rgb(seq, yp, up, vp, c["props"].get("nclx"))
    assert ((a == 1)[..., None] & (rgb >= 128)).any()
    assert held_to_pil(data) == "equal"


# ---------------------------------------------------------------------------
# what the port leaves out, by name
# ---------------------------------------------------------------------------

def _refusals() -> dict:
    px = _content("photo", 48, 64, np.random.default_rng(5))
    img = Image.fromarray(px)
    buf = io.BytesIO()
    img.save(buf, "AVIF", save_all=True, append_images=[
        Image.fromarray(px[::-1].copy())])
    still = _save(px, quality=50)
    at = still.index(b"ispe") + 8
    return {
        "quantizer matrices": _save(px, quality=50,
                                    advanced={"enable-qm": "1"}),
        "film grain": _save(px, quality=50,
                            advanced={"film-grain-test": "1"}),
        "image sequences": buf.getvalue(),
        # libavif scales the 64x48 frame to its item's ispe with libyuv
        "ispe size": still[:at] + struct.pack(">II", 80, 60) + still[at + 8:],
    }


@pytest.mark.parametrize("feature", ["quantizer matrices", "film grain",
                                     "image sequences", "ispe size"])
def test_refused_features_are_named(feature):
    """Files PIL opens with quantizer matrices (aom's enable-qm), film
    grain (film-grain-test), an image sequence (save_all) or a frame
    libavif scales to an ispe size of its item's that differs from the
    AV1 frame's, each once refused, decode to PIL's bytes."""
    data = _refusals()[feature]
    assert isinstance(pil_outcome(data), np.ndarray)
    assert held_to_pil(data) == "equal"


# ---------------------------------------------------------------------------
# cut and mutated streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", SMALL, ids=os.path.basename)
def test_cut_streams(path):
    """Each committed file cut by 1 to 40 bytes: PIL raises on all (the
    item's extent runs past the file), and so does the port."""
    data = _read(path)
    assert {held_to_pil(data[:-k]) for k in range(1, 41)} == {"raise"}


def test_cut_big_stream():
    data = _read(BIG)
    assert {held_to_pil(data[:-k]) for k in (1, 2, 40)} == {"raise"}


@pytest.mark.parametrize("seed", range(6))
def test_mutation_fuzz(seed):
    """60 mutations a seed (360 in all) of the committed files but the
    2048x2048 one, each of 1-3 bytes (a random value, or one bit
    flipped) anywhere in the file: the port is byte-equal wherever PIL
    decodes, raises wherever PIL raises, or names a feature it does not
    decode."""
    files = [_read(p) for p in SMALL]
    rng = np.random.default_rng(2000 + seed)
    seen = []
    for _ in range(60):
        data = bytearray(files[int(rng.integers(0, len(files)))])
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(data)))
            data[i] = (int(rng.integers(0, 256)) if rng.random() < 0.7
                       else data[i] ^ (1 << int(rng.integers(0, 8))))
        seen.append(held_to_pil(bytes(data)))
    # most mutations make dav1d or libavif refuse the file; some decode
    assert seen.count("equal") >= 5


# ---------------------------------------------------------------------------
# the tables and the native build
# ---------------------------------------------------------------------------

def test_tables_equal_the_extraction():
    """csrc/av1_tables.h is what tools/extract_av1_tables.py reads from
    PIL's libavif (its default CDFs, quantizer lookups and the rest)."""
    with open(tables.OUT) as f:
        assert f.read() == tables.header()


def test_port_imports_no_pil():
    """No module of the port imports PIL (the card's machine has none),
    the decoders' bomb limit (scene/bomb.py) and the AVIF and AV1 modules
    among them."""
    pat = re.compile(r"^\s*(import PIL|from PIL\b)", re.M)
    seen = set()
    for root, _, files in os.walk("rlshaders_tpu_torch"):
        for name in files:
            if name.endswith(".py"):
                seen.add(name)
                with open(os.path.join(root, name)) as f:
                    assert not pat.search(f.read()), name
    assert {"bomb.py", "avif.py", "av1.py", "texture.py"} <= seen


def test_no_compiler_raises(monkeypatch):
    """No g++ on PATH: the tile decoder cannot be built, and the decode
    raises."""
    data = _read(f"{FOLDER}/px_1x1.avif")
    monkeypatch.setattr(av1, "_lib", None)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="not found on PATH"):
        ttex.decode_image(data)
