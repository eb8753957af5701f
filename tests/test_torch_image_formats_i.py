"""FLI/FLC, PhotoCD, FITS and IPTC (scene/fli.py, pcd.py, fits.py, iptc.py)
against PIL 12.1.0, and the files of scenes/data/formats_i.

* The committed files (`python tools/make_image_formats.py formats_i`,
  hand writers, no PIL): each equals PIL's decode and its pinned digest,
  and `texture.image_format` names it as PIL's `format` does.
* Sweeps of hand-built files: FLI and FLC of every sub-chunk and flag
  word, palettes of skipped packets, several frames; PhotoCD of every
  orientation; FITS of each BITPIX, one to three axes, comments and "="
  forms, extension headers, GZIP_1 tiles; IPTC of every mode, band
  (negative and past the bands), field size and compression, JPEG data
  of one and three components.
* What PIL passes on or fails: an FLI magic with flags 1, an FLC whose
  frame starts with a prefix chunk, no frames, FITS of other BITPIX or
  SIMPLE = F, no image data, truncated headers; cut streams of every
  committed file (1-40 bytes) and 200-case mutation fuzzes of each
  format, held to PIL's outcome.
* Pillow's "YCC;P" unpacker over all 2^24 inputs against pcd.ycc_to_rgb.
"""
import io
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from test_torch_gpu import FORMAT_I_DIGESTS, FORMAT_I_FRAMES
from test_torch_image_jpeg2000 import held_to_pil, pil_outcome
from tools import make_image_formats as fm
from tools.make_image_modes import digest
from rlshaders_tpu_torch.scene import pcd
from rlshaders_tpu_torch.scene import texture as ttex

FOLDER = "scenes/data/formats_i"
FILES = sorted(FORMAT_I_DIGESTS)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _pil_format(data: bytes):
    try:
        return Image.open(io.BytesIO(data)).format
    except Exception:
        return None


def _named_as_pil(data: bytes) -> None:
    """Where PIL opens the file, the port names PIL's format (where PIL's
    open fails, a plugin failed it, or none took it)."""
    fmt = _pil_format(data)
    if fmt is not None:
        assert ttex.image_format(data) == fmt


def test_digests_cover_the_files():
    """Every file of scenes/data/formats_i is pinned, in both copies of
    the digests (chip_smoke.py's too, with its frames), and the tool
    writes the committed bytes."""
    import os
    names = sorted(f"{FOLDER}/{n}" for n in os.listdir(FOLDER))
    assert names == FILES
    assert chip_smoke.FORMAT_I_DIGESTS == FORMAT_I_DIGESTS
    assert chip_smoke.FORMAT_I_FRAMES == FORMAT_I_FRAMES
    made = fm.files_i()
    assert sorted(f"{FOLDER}/{n}" for n in made) == FILES
    for name, data in made.items():
        assert data == _read(f"{FOLDER}/{name}"), name


@pytest.mark.parametrize("path", FILES)
def test_committed_file(path):
    data = _read(path)
    assert digest(data) == FORMAT_I_DIGESTS[path]
    assert held_to_pil(data) == "equal"
    assert ttex.image_format(data) == _pil_format(data)


# ---------------------------------------------------------------------------
# FLI / FLC
# ---------------------------------------------------------------------------

def _index(h: int, w: int, seed: int, colours: int = 40) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, colours, (h, w)).astype(
        np.uint8)


def _fli_cases() -> dict:
    rng = np.random.default_rng(19700)
    pal = rng.integers(0, 256, (256, 3))
    out = {}
    for h, w in ((1, 1), (3, 2), (9, 17), (40, 31)):
        a, b = _index(h, w, w), _index(h, w, w + 1)
        b[::2] = a[::2]
        out[f"brun_{w}x{h}"] = fm.fli_bytes(w, h, [[
            (4, fm.fli_colour(pal)), (15, fm.fli_brun(a))]])
        out[f"lc_{w}x{h}"] = fm.fli_bytes(w, h, [[
            (11, fm.fli_colour(pal, six_bit=True)), (16, a.tobytes()),
            (12, fm.fli_lc(a, b))]], flc=False, flags=0)
        out[f"ss2_{w}x{h}"] = fm.fli_bytes(w, h, [[
            (16, a.tobytes()), (7, fm.fli_ss2(a, b))]])
        out[f"ss2_noskip_{w}x{h}"] = fm.fli_bytes(w, h, [[
            (16, a.tobytes()), (7, fm.fli_ss2(a, b, skip_words=False))]])
    a = _index(12, 10, 3)
    out["black_after_copy"] = fm.fli_bytes(10, 12, [[(16, a.tobytes()),
                                                     (13, b"")]])
    out["stamp_and_frames"] = fm.fli_bytes(10, 12, [
        [(18, bytes(30)), (16, a.tobytes())], [(13, b"")], [(13, b"")]])
    out["palette_packets"] = fm.fli_bytes(10, 12, [[
        (4, fm.fli_colour(pal, packets=[(10, 5), (0, 3), (200, 30)])),
        (16, (a * 6).tobytes())]])
    out["palette_past_256"] = fm.fli_bytes(10, 12, [[
        (4, fm.fli_colour(pal, packets=[(10, 5), (0, 3), (200, 40)])),
        (16, (a * 6).tobytes())]])
    out["palette_256_count0"] = fm.fli_bytes(10, 12, [[
        (4, fm.fli_colour(pal, packets=[(0, 256)])), (16, a.tobytes())]])
    out["six_bit_past_63"] = fm.fli_bytes(10, 12, [[
        (11, fm.fli_colour(pal)), (16, a.tobytes())]], flc=False)
    out["no_chunks"] = fm.fli_bytes(10, 12, [[]])
    out["unknown_chunk"] = fm.fli_bytes(10, 12, [[(99, bytes(8))]])
    out["prefix_chunk"] = fm.fli_bytes(10, 12, [[(16, a.tobytes())]],
                                       prefix=bytes(20))
    out["copy_short"] = fm.fli_bytes(10, 12, [[(16, a.tobytes()[:50])]])
    out["brun_short_line"] = fm.fli_bytes(10, 12, [[
        (15, bytes([1, 5, 7]) * 12)]])
    out["lc_past_rows"] = fm.fli_bytes(10, 12, [[
        (12, struct.pack("<HH", 10, 5) + bytes(5))]])
    skip = bytearray(fm.fli_bytes(10, 12, [[(16, a.tobytes()),
                                            (7, fm.fli_ss2(a, a[::-1]))]]))
    out["ss2_reversed"] = bytes(skip)
    flags1 = bytearray(out["brun_17x9"])
    struct.pack_into("<H", flags1, 14, 1)
    out["flags_1"] = bytes(flags1)
    nonzero = bytearray(out["brun_17x9"])
    nonzero[50] = 1
    out["header_byte_50"] = bytes(nonzero)
    no_frames = bytearray(out["brun_17x9"])
    struct.pack_into("<H", no_frames, 6, 0)
    out["no_frames"] = bytes(no_frames)
    return out


@pytest.mark.parametrize("name", sorted(_fli_cases()))
def test_fli_sweep(name):
    """Hand-built FLI and FLC files of every sub-chunk, and the files PIL
    passes on (flags 1, a nonzero reserved byte, no frames: the port
    names the format PIL then opens them as, if any) or fails (a prefix
    chunk where the frame is read, an unknown chunk, data that ends
    early): the port's outcome is PIL's."""
    data = _fli_cases()[name]
    _named_as_pil(data)
    assert held_to_pil(data) in ("equal", "raise")


def test_fli_outcomes():
    """The sweep decodes where PIL decodes (every sub-chunk), fails where
    PIL fails (an unknown chunk, a prefix chunk where PIL reads the frame,
    a copy or line that runs short, a sub-chunk under 10 bytes at the
    frame's end, which Pillow's bound check refuses), and passes on what
    PIL passes on."""
    cases = _fli_cases()
    for name in ("brun_31x40", "lc_31x40", "ss2_31x40", "ss2_noskip_31x40",
                 "palette_packets", "palette_256_count0", "six_bit_past_63",
                 "no_chunks", "stamp_and_frames", "ss2_reversed"):
        assert held_to_pil(cases[name]) == "equal", name
    for name in ("unknown_chunk", "prefix_chunk", "copy_short",
                 "brun_short_line", "lc_past_rows", "black_after_copy",
                 "brun_1x1"):
        assert _pil_format(cases[name]) == "FLI", name
        assert isinstance(pil_outcome(cases[name]), str), name
    for name in ("flags_1", "header_byte_50", "no_frames",
                 "palette_past_256"):
        assert _pil_format(cases[name]) != "FLI"
        assert ttex.image_format(cases[name]) != "FLI"


# ---------------------------------------------------------------------------
# PhotoCD
# ---------------------------------------------------------------------------

def test_pcd_orientations_and_cuts():
    """Orientations 0-3 (1 and 3 turn the image, 2 does not), a file cut
    inside its base image, one whose header is too short for the
    orientation byte (PIL passes it on) and one without the magic."""
    rgb = np.random.default_rng(19800).integers(0, 256, (512, 768, 3))
    base = fm.pcd_bytes(rgb)
    for turn in range(4):
        data = bytearray(base)
        data[2048 + 1538] = turn | 0x14
        assert held_to_pil(bytes(data)) == "equal"
        assert ttex.image_format(bytes(data)) == "PCD"
    assert held_to_pil(base[:-1]) == "raise"
    assert held_to_pil(base[:96 * 2048 + 1000]) == "raise"
    short = base[:2048 + 1000]
    assert _pil_format(short) is None
    assert ttex.image_format(short) != "PCD"
    assert ttex.image_format(base[:2048] + b"PCX_" + base[2052:]) != "PCD"


def test_ycc_unpacker_all_inputs():
    """pcd.ycc_to_rgb equals Pillow's "YCC;P" raw unpacker on all 2^24
    (Y, C1, C2) triples."""
    y, c1, c2 = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                            indexing="ij")
    raw = np.stack([y, c1, c2], -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("RGB", (1 << 24, 1), raw.tobytes(),
                                      "raw", "YCC;P")).reshape(-1, 3)
    got = pcd.ycc_to_rgb(y.reshape(-1), c1.reshape(-1), c2.reshape(-1))
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# FITS
# ---------------------------------------------------------------------------

def _fits_cases() -> dict:
    rng = np.random.default_rng(19900)
    v = rng.integers(0, 256, (7, 11))
    card = fm._card
    out = {}
    for bits in (8, 16, 32, -32, -64):
        vals = v if bits > 0 else v - 99.75
        if bits == 16:
            vals = (v << 8) + (v > 200)
        out[f"bitpix_{bits}"] = fm.fits_bytes(vals, bits)
        out[f"bitpix_{bits}_unpadded"] = fm.fits_bytes(vals, bits, pad=False)
    out["naxis1"] = fm.fits_bytes(v[:1], 8, naxis=1)
    out["naxis3"] = fm.fits_bytes(v, 16, naxis=3)
    out["bitpix_24"] = fm.fits_bytes(v, 8).replace(
        card("BITPIX", "8"), card("BITPIX", "24"))
    out["simple_f"] = fm.fits_bytes(v, 8).replace(card("SIMPLE", "T"),
                                                  card("SIMPLE", "F"))
    out["comments"] = fm.fits_bytes(v, 8, cards=[
        card("COMMENT   a note / with a slash"), ("BZERO", "32768"),
        ("BSCALE", "2.5"), card("HISTORY   hand-written")])
    out["value_forms"] = fm.fits_bytes(v, 8).replace(
        card("NAXIS1", "11"), b"NAXIS1  =                   11 / width".ljust(
            80))
    out["no_axes"] = fm.fits_bytes(v, 8).replace(card("NAXIS", "2"),
                                                 card("NAXIS", "0"))
    out["zero_width"] = fm.fits_bytes(v, 8).replace(card("NAXIS1", "11"),
                                                    card("NAXIS1", "0"))
    out["bad_int"] = fm.fits_bytes(v, 8).replace(card("NAXIS1", "11"),
                                                 card("NAXIS1", "eleven"))
    out["no_naxis2"] = fm.fits_bytes(v, 8).replace(card("NAXIS2", "7"),
                                                   card("COMMENT", "x"))
    out["header_cut"] = fm.fits_bytes(v, 8)[:400]
    out["data_cut"] = fm.fits_bytes(v, 8, pad=False)[:-5]
    for tiles in (1, 2, 7):
        out[f"gzip_{tiles}"] = fm.fits_gzip((v << 16) + v, 16, tiles)
    out["gzip_8"] = fm.fits_gzip(v, 8, 2)
    out["gzip_32"] = fm.fits_gzip((v << 20) - (1 << 30), 32, 3)
    out["gzip_float"] = fm.fits_gzip(v, -32, 1)
    out["gzip_padded"] = fm.fits_gzip(v, 16, 1) + bytes(2880)
    out["gzip_cut"] = fm.fits_gzip(v, 16, 1)[:-4]
    # a primary header of no axes, then an IMAGE extension of the data
    prim = fm.fits_bytes(v, 8).replace(card("NAXIS", "2"), card("NAXIS", "0"))
    ext = fm.fits_bytes(v, 16).replace(card("SIMPLE", "T"),
                                       card("XTENSION", "'IMAGE   '"))
    out["image_extension"] = prim[:2880] + ext
    return out


@pytest.mark.parametrize("name", sorted(_fits_cases()))
def test_fits_sweep(name):
    """Hand-built FITS files: the port's outcome is PIL's on each, and it
    names PIL's format."""
    data = _fits_cases()[name]
    _named_as_pil(data)
    assert held_to_pil(data) in ("equal", "raise")


def test_fits_outcomes():
    """Every BITPIX and layout decodes; a file cut inside its data decodes
    where PIL's offset (the position after the first data card read,
    less 80) moves back into the header's padding far enough; gzip data
    with zeros after it decodes (Python's gzip strips them); no axes, a
    value int() refuses, a cut header, GZIP_1 of a float BITPIX and a cut
    gzip member fail; what PIL passes on is passed on."""
    cases = _fits_cases()
    for name in ("bitpix_8", "bitpix_16", "bitpix_32", "bitpix_-32",
                 "bitpix_-64", "naxis1", "naxis3", "comments", "value_forms",
                 "gzip_1", "gzip_7", "gzip_8", "gzip_32", "image_extension",
                 "data_cut", "gzip_padded"):
        assert held_to_pil(cases[name]) == "equal", name
    for name in ("no_axes", "bad_int", "header_cut", "gzip_float",
                 "gzip_cut"):
        assert isinstance(pil_outcome(cases[name]), str), name
    for name in ("bitpix_24", "simple_f", "zero_width", "no_naxis2"):
        assert _pil_format(cases[name]) != "FITS"
        assert ttex.image_format(cases[name]) != "FITS"


# ---------------------------------------------------------------------------
# IPTC
# ---------------------------------------------------------------------------

def _iptc_cases() -> dict:
    rng = np.random.default_rng(20000)
    g = rng.integers(0, 256, (9, 13)).astype(np.uint8)
    grey_jpeg = fm.jpeg_grey(g)
    out = {"grey": fm.iptc_bytes(13, 9, g.tobytes())}
    for band in (None, 0, 1, 2, 3, 4, 5, 255):
        out[f"rgb_band_{band}"] = fm.iptc_bytes(13, 9, g.tobytes(), 3, 1,
                                                band=band)
        out[f"cmyk_band_{band}"] = fm.iptc_bytes(13, 9, g.tobytes(), 4, 1,
                                                 band=band)
    out["grey_many_fields"] = fm.iptc_bytes(13, 9, g.tobytes(), chunk=10)
    out["grey_extended"] = b"".join(
        fm.iptc_field(*f) for f in ((3, 60, b"\x01\x00"),
                                    (3, 20, b"\x00\x0d"),
                                    (3, 30, b"\x00\x09"),
                                    (3, 120, b"\x01"))) + fm.iptc_field(
        8, 10, g.tobytes(), extended=True)
    out["grey_short"] = fm.iptc_bytes(13, 9, g.tobytes()[:50])
    out["grey_long"] = fm.iptc_bytes(13, 9, g.tobytes() + bytes(40))
    out["jpeg_grey"] = fm.iptc_bytes(13, 9, grey_jpeg, compression=5)
    out["jpeg_grey_band"] = fm.iptc_bytes(13, 9, grey_jpeg, 3, 1,
                                          compression=5, band=3)
    colour = open("scenes/data/grid.jpg", "rb").read()
    out["jpeg_colour"] = fm.iptc_bytes(256, 256, colour, compression=5)
    out["jpeg_colour_band"] = fm.iptc_bytes(256, 256, colour, 3, 1,
                                            compression=5, band=1)
    out["compression_7"] = fm.iptc_bytes(13, 9, g.tobytes(), compression=7)
    out["no_image_field"] = fm.iptc_bytes(13, 9, b"")
    out["two_layers"] = fm.iptc_bytes(13, 9, g.tobytes(), 2, 1)
    out["trailing_zero_field"] = out["grey"] + bytes(5)
    return out


@pytest.mark.parametrize("name", sorted(_iptc_cases()))
def test_iptc_sweep(name):
    """Hand-built IPTC files: the port's outcome is PIL's on each (a band
    past the image's fails in PIL's merge, a colour JPEG in a band fails
    its mode check, a negative band fills the last), and it names PIL's
    format."""
    data = _iptc_cases()[name]
    _named_as_pil(data)
    assert held_to_pil(data) in ("equal", "raise")


def test_iptc_outcomes():
    cases = _iptc_cases()
    for name in ("grey", "rgb_band_0", "rgb_band_2", "rgb_band_3",
                 "cmyk_band_0", "cmyk_band_4", "cmyk_band_None",
                 "grey_many_fields", "grey_extended", "grey_long",
                 "jpeg_grey", "jpeg_grey_band", "jpeg_colour",
                 "trailing_zero_field"):
        assert held_to_pil(cases[name]) == "equal", name
    for name in ("rgb_band_4", "rgb_band_5", "rgb_band_255", "cmyk_band_5",
                 "grey_short", "jpeg_colour_band", "compression_7",
                 "no_image_field"):
        assert isinstance(pil_outcome(cases[name]), str), name
    assert _pil_format(cases["two_layers"]) is None
    assert ttex.image_format(cases["two_layers"]) != "IPTC"


# ---------------------------------------------------------------------------
# cut and mutated streams, PIL's plugin order
# ---------------------------------------------------------------------------

CUT = [f"{FOLDER}/{n}" for n in (
    "grid_brun.flc", "logo_color64_lc.fli", "odd_copy_ss2.flc",
    "odd_8bit.fits", "odd_float64.fits", "odd_gzip_tiles.fits",
    "odd_raw_grey.iptc", "odd_jpeg_grey.iptc", "odd_raw_cmyk_band.iptc",
    "photo_768_turn90.pcd")]


@pytest.mark.parametrize("path", CUT)
def test_cut_streams(path):
    """A file of each new format cut by 1 to 40 bytes: the port's outcome
    is PIL's on each."""
    data = _read(path)
    for k in range(1, 41):
        assert held_to_pil(data[:-k]) in ("equal", "raise")


FUZZ = {
    "fli": (["grid_brun.flc", "logo_color64_lc.fli", "odd_copy_ss2.flc"],
            144),
    "fits": (["odd_8bit.fits", "odd_16bit.fits", "odd_32bit.fits",
              "odd_float32.fits", "odd_float64.fits", "odd_naxis1.fits",
              "odd_gzip_tiles.fits"], 0),
    "iptc": (["odd_raw_grey.iptc", "odd_raw_cmyk_band.iptc",
              "odd_jpeg_grey.iptc", "logo_raw_rgb_band.iptc"], 0),
    "pcd": (["photo_768_turn90.pcd"], 2048),
}


@pytest.mark.parametrize("kind", sorted(FUZZ))
def test_mutation_fuzz(kind):
    """200 mutations of each format's files, of 1-3 bytes (a random value,
    or one bit flipped), half of them in the first 300 bytes past `lo`
    (the headers; FLI's first frame and its chunk headers, PhotoCD's
    header block), some also cut: the port is byte-equal wherever PIL
    decodes and raises wherever PIL raises."""
    names, lo = FUZZ[kind]
    files = [_read(f"{FOLDER}/{n}") for n in names]
    rng = np.random.default_rng(20100 + sorted(FUZZ).index(kind))
    seen = []
    for _ in range(200):
        data = bytearray(files[int(rng.integers(0, len(files)))])
        for _ in range(int(rng.integers(1, 4))):
            hi = len(data) if rng.random() < 0.5 else min(len(data),
                                                          lo + 300)
            i = int(rng.integers(min(lo, hi - 1), hi))
            data[i] = (int(rng.integers(0, 256)) if rng.random() < 0.7
                       else data[i] ^ (1 << int(rng.integers(0, 8))))
        if rng.random() < 0.15:
            data = data[:int(rng.integers(1, len(data)))]
        outcome = held_to_pil(bytes(data))
        assert outcome in ("equal", "raise")
        seen.append(outcome)
    assert seen.count("equal") >= 20


def test_plugin_order():
    """FITS and FLI come after EPS, IPTC after IMT, PCD after MSP, as PIL
    tries them, and each is among the formats the port decodes."""
    names = [n for n, _, _ in ttex._FORMATS]
    assert names.index("EPS") < names.index("FITS") < names.index("FLI") \
        < names.index("FTEX")
    assert names.index("IMT") < names.index("IPTC") < names.index("MCIDAS")
    assert names.index("MSP") < names.index("PCD") < names.index("PIXAR")
    for name in ("FITS", "FLI", "IPTC", "PCD"):
        assert name in ttex.DECODED
