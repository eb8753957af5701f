"""The seventeenth slice's decoders against PIL 12.1.0, the decoder behind
the JAX package's `Image.open(path).convert("RGB")`: byte-equal, no
tolerance.

* float and signed TIFF (scene/tiff.py): every OPEN_INFO layout of
  SampleFormat 2 and 3 (8-bit signed grey read as "L", 16- and 32-bit
  signed as mode I, 32-bit float as mode F under photometric 0 and 1)
  and unsigned 32-bit grey, in both byte orders, raw, LZW, Deflate,
  Adobe Deflate, PackBits and LZMA, predictors 1, 2 and 3, strips and
  tiles, both planar configurations; Pillow's F and I to RGB rules;
* YCbCr TIFF outside JPEG: libtiff's RGBA reader at every subsampling
  it converts, odd sizes, clipped tiles, predictor 2, YCbCrCoefficients
  and ReferenceBlackWhite (valid and invalid), PIL's own files;
* sYCC JPEG 2000: PIL's YCbCr files and an RGBA codestream under
  colour space 18;
* PSD (scene/psd.py): every mode of PsdImagePlugin.MODES, raw and RLE,
  with a layer section or not, odd sizes, rows whose last record runs
  on; LAB, once refused by name, decoded;
* AVIF frames libavif scales to their ispe or track size
  (scene/yuvscale.py): libyuv's ScalePlane held to the bundled
  libavif's `avifImageScale` on every path, then stills, alpha, grids
  and sequences held to PIL.

The committed files of scenes/data/formats_g are held to their digests,
the tool that writes them and the JAX package's `load_image(path, 1.0)`;
streams cut by 1-40 bytes and a seeded mutation fuzz (200 cases a
format) to PIL's outcome, where a named refusal is allowed only for the
features listed in `REFUSALS`. Last, every mode PIL writes is saved, at
53x37, in every format and TIFF compression PIL writes here, and held to
PIL: only CCITT RLEW TIFF is refused (LAB and ZSTD once were too).
"""
import ctypes
import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from test_torch_gpu import FORMAT_G_DIGESTS
from test_torch_image_jpeg2000 import _ask, held_to_pil, pil_outcome
from test_torch_image_modes import pil_rgb, same_as_reference
from tools import make_image_formats as fm
from tools.make_image_modes import digest, tiff_bytes
from rlshaders_tpu_torch.scene import texture as ttex
from rlshaders_tpu_torch.scene import yuvscale
from rlshaders_tpu_torch.scene.tiff import decode_tiff

FOLDER = "scenes/data/formats_g"
FILES = sorted(FORMAT_G_DIGESTS)
# the refusals a cut or mutated file of this slice may meet (PIL decodes
# it, the port names what it does not decode)
REFUSALS = ("fails part way", "read differently", "uncompressed YCbCr",
            "old-style", "LAB", "code-block", "subsampled components",
            "(8 and 16 only)", "superres", "bit depth",
            "not a shown key frame", "which PIL misreads")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _same(data: bytes) -> str:
    """"equal" where PIL and the port decode the bytes alike, "raise"
    where both raise (PIL in this process: the files are well-formed)."""
    try:
        want = pil_rgb(data)
    except Exception:
        with pytest.raises((ValueError, NotImplementedError)):
            ttex.decode_image(data)
        return "raise"
    got = ttex.decode_image(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    return "equal"


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def test_digests_cover_the_files():
    """Every file of scenes/data/formats_g is pinned in both copies of the
    digests, the tool writes the committed bytes, and frames O and P name
    committed files."""
    assert chip_smoke.FORMAT_G_DIGESTS == FORMAT_G_DIGESTS
    assert sorted(f"{FOLDER}/{n}" for n in os.listdir(FOLDER)) == FILES
    made = fm.files_g()
    assert sorted(f"{FOLDER}/{n}" for n in made) == FILES
    for name, data in made.items():
        assert data == _read(f"{FOLDER}/{name}"), name
    for images in chip_smoke.FORMAT_G_FRAMES.values():
        assert all(f"scenes/data/{n}" in FORMAT_G_DIGESTS for n in images)


@pytest.mark.parametrize("path", FILES)
def test_committed_file(tmp_path, path):
    """The port's decode equals PIL's (and the JAX package's load_image)
    and the pinned digest."""
    data = _read(path)
    same_as_reference(tmp_path, data)
    assert digest(data) == FORMAT_G_DIGESTS[path]


# ---------------------------------------------------------------------------
# float and signed TIFF
# ---------------------------------------------------------------------------

def _samples(kind: str, rng, h: int, w: int) -> np.ndarray:
    """(h, w, 1) sample bits of a layout, with values on both sides of
    PIL's clamps (negative, past 255, NaN and infinities for floats)."""
    if kind == "float":
        f = rng.normal(100, 120, (h, w)).astype(np.float32)
        f.reshape(-1)[:6] = [np.nan, np.inf, -np.inf, 1e10, -0.5, 255.5]
        return f.view(np.uint32).astype(np.int64)[..., None]
    bits = {"int8": 8, "int16": 16, "int32": 32, "uint32": 32}[kind]
    v = rng.integers(-400, 700, (h, w)) if kind != "uint32" else \
        rng.integers(0, 1 << 32, (h, w))
    return (v % (1 << bits))[..., None]


@pytest.mark.parametrize("kind,bits,fmt,photo", [
    ("int8", 8, 2, 1), ("int16", 16, 2, 1), ("int32", 32, 2, 1),
    ("uint32", 32, 1, 1), ("float", 32, 3, 1), ("float", 32, 3, 0)])
def test_float_and_signed_tiff(kind, bits, fmt, photo):
    """Both byte orders, every compression, predictors 1-3, strips and
    tiles, both planar configurations: equal to PIL wherever PIL reads
    the file (a big-endian file's samples byte-swapped where libtiff
    decodes them), raising where it does not; only uncompressed planes
    PIL misreads are refused by name."""
    rng = np.random.default_rng(17000 + bits + fmt + photo)
    seen = []
    for order in ("II", "MM"):
        for comp in (1, 5, 8, 32946, 32773, 34925):
            for pred in (1, 2, 3):
                for planar, tile in ((1, None), (1, (16, 16)), (2, None)):
                    data = tiff_bytes(
                        _samples(kind, rng, 19, 23), bits, photo,
                        order=order, compression=comp, predictor=pred,
                        planar=planar, tile=tile, rows_per_strip=5,
                        tags=[(339, 3, [fmt])])
                    try:
                        seen.append(_same(data))
                    except NotImplementedError as e:
                        assert "planar" in str(e)
                        seen.append("refused")
    assert seen.count("equal") >= 40


def test_float_and_int_conversions():
    """Pillow's mode F to RGB truncates toward zero and clamps, NaN to 0
    (-3.5, 0.4, 0.6, 1.5, 254.5, 255.5, 300, NaN, -inf, inf give 0, 0, 0,
    1, 254, 255, 255, 0, 0, 255); mode I clamps to 0..255; a big-endian
    LZW file's floats come out byte-swapped, as PIL reads them."""
    v = np.array([[-3.5, 0.4, 0.6, 1.5, 254.5, 255.5, 300, np.nan, -np.inf,
                   np.inf]], np.float32)
    data = fm.float_tiff(v)
    assert decode_tiff(data)[0, :, 0].tolist() == [0, 0, 0, 1, 254, 255,
                                                   255, 0, 0, 255]
    assert np.array_equal(decode_tiff(data), pil_rgb(data))
    data = fm.signed_tiff(np.array([[-70000, -1, 0, 255, 256, 70000]]), 32)
    assert decode_tiff(data)[0, :, 0].tolist() == [0, 0, 0, 255, 255, 255]
    assert np.array_equal(decode_tiff(data), pil_rgb(data))
    swapped = fm.float_tiff(np.full((1, 2), 100.0, np.float32), order="MM",
                            compression=5)
    want = np.float32(100.0).byteswap()         # 4.6e-41: black
    assert np.array_equal(decode_tiff(swapped), pil_rgb(swapped))
    assert decode_tiff(swapped)[0, 0, 0] == min(max(int(want), 0), 255)


@pytest.mark.parametrize("orientation", [2, 3, 4])
def test_tiff_orientations(orientation):
    """PIL's exif_transpose turns a TIFF of orientation 2, 3 or 4 (mirror,
    half turn, flip) whatever decodes it, as the port now does (before
    this slice it returned the stored rows): raw and LZW RGB, float and
    YCbCr."""
    rng = np.random.default_rng(17050 + orientation)
    tag = [(274, 3, [orientation])]
    rgb = rng.integers(0, 256, (6, 5, 3))
    for data in (tiff_bytes(rgb, 8, 2, tags=tag),
                 tiff_bytes(rgb, 8, 2, compression=5, tags=tag),
                 fm.float_tiff(rng.normal(100, 50, (6, 5)), compression=8,
                               tags=tag),
                 fm.ycbcr_tiff(rgb, 2, 2, tags=tag)):
        got = decode_tiff(data)
        assert np.array_equal(got, pil_rgb(data))
        plain = decode_tiff(data.replace(
            struct.pack("<HHII", 274, 3, 1, orientation),
            struct.pack("<HHII", 274, 3, 1, 1)))
        flips = {2: plain[:, ::-1], 3: plain[::-1, ::-1], 4: plain[::-1]}
        assert np.array_equal(got, flips[orientation])


# ---------------------------------------------------------------------------
# YCbCr TIFF outside JPEG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hs,vs", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                   (4, 2), (4, 4)])
def test_ycbcr_subsampling(hs, vs):
    """Each subsampling libtiff's RGBA reader converts, at odd and even
    sizes, in strips and clipped 16x16 tiles (libtiff's 4x4 routine skips
    10 bytes a block at a clipped tile's rows, which moves the rows after
    the first), LZW, Deflate and PackBits, predictor 2 where libtiff's
    row size divides, both byte orders."""
    rng = np.random.default_rng(17100 + 16 * hs + vs)
    n = 0
    for h, w in ((19, 23), (16, 32), (7, 5)):
        ycc = rng.integers(0, 256, (h, w, 3))
        for comp, pred in ((5, 1), (5, 2), (8, 2), (32773, 1)):
            for tile in (None, (16, 16)):
                data = fm.ycbcr_tiff(ycc, hs, vs, compression=comp,
                                     predictor=pred, tile=tile,
                                     rows_per_strip=4 * vs,
                                     order="MM" if n % 3 else "II")
                assert _same(data) == "equal"
                n += 1


@pytest.mark.parametrize("coefficients,reference,want", [
    ([(299, 1000), (587, 1000), (114, 1000)], None, "equal"),
    ([(2126, 10000), (7152, 10000), (722, 10000)],
     [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)], "equal"),
    (None, [(0, 1), (255, 1), (0, 1), (255, 1), (0, 1), (255, 1)], "equal"),
    ([(1, 3), (1, 3), (1, 3)],
     [(5, 2), (250, 1), (100, 1), (200, 1), (160, 1), (255, 1)], "equal"),
    (None, [(255, 1), (0, 1), (128, 1), (255, 1), (128, 1), (255, 1)],
     "equal"),
    ([(1, 1), (0, 1), (1, 1)], None, "raise"),
    ([(0, 1), (1, 1), (0, 1)], None, "equal")],
    ids=["rec601", "rec709_studio", "zero_chroma_reference", "thirds",
         "inverted_luma", "green_zero", "green_only"])
def test_ycbcr_tables(coefficients, reference, want):
    """TIFFYCbCrToRGB's tables from YCbCrCoefficients and
    ReferenceBlackWhite (float32, 16.16 fixed point): libtiff refuses a
    green coefficient of 0."""
    ycc = np.random.default_rng(17200).integers(0, 256, (13, 17, 3))
    for hs, vs in ((1, 1), (2, 2)):
        data = fm.ycbcr_tiff(ycc, hs, vs, coefficients=coefficients,
                             reference=reference)
        assert _same(data) == want


@pytest.mark.parametrize("compression", ["tiff_lzw", "packbits",
                                         "tiff_deflate",
                                         "tiff_adobe_deflate"])
def test_ycbcr_pil_written(compression):
    """PIL's own YCbCr TIFF (1x1, studio reference), with predictor 2
    where the codec takes one; a file without YCbCrSubsampling (libtiff's
    2x2 default); one of 2x4, which libtiff's reader does not convert."""
    img = Image.fromarray(np.random.default_rng(17300).integers(
        0, 256, (37, 53, 3), np.uint8)).convert("YCbCr")
    for info in ({}, {317: 2}):
        buf = io.BytesIO()
        img.save(buf, "TIFF", compression=compression, tiffinfo=info)
        assert _same(buf.getvalue()) == "equal"
    ycc = np.asarray(img).astype(np.int64)
    assert _same(fm.ycbcr_tiff(ycc, 2, 2, subsampling_tag=False)) == "equal"
    assert _same(fm.ycbcr_tiff(ycc, 2, 4)) == "raise"


def test_ycbcr_refusals():
    """Uncompressed YCbCr, which PIL reads as RGBX samples (misreading or
    truncating it), and planar YCbCr stay refused by name."""
    ycc = np.random.default_rng(17400).integers(0, 256, (9, 11, 3))
    with pytest.raises(NotImplementedError, match="uncompressed YCbCr"):
        decode_tiff(fm.ycbcr_tiff(ycc, 1, 1, compression=1))
    planar = tiff_bytes(ycc, 8, 6, compression=5, planar=2,
                        tags=[(530, 3, [1, 1])])
    with pytest.raises(NotImplementedError, match="planar YCbCr"):
        decode_tiff(planar)


# ---------------------------------------------------------------------------
# sYCC JPEG 2000
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"irreversible": True}, {"no_jp2": True},
                                {"quality_mode": "rates",
                                 "quality_layers": [20]}],
                         ids=["jp2", "irreversible", "j2k", "lossy"])
def test_sycc(kw):
    """PIL's JPEG 2000 of a YCbCr image (a JP2 says colour space 18; a bare
    codestream is read as sRGB), and an RGBA codestream under colour space
    18 (Pillow's sYCC unpacker with alpha): equal to PIL."""
    rng = np.random.default_rng(17500)
    img = Image.fromarray(rng.integers(0, 256, (37, 53, 3), np.uint8))
    buf = io.BytesIO()
    img.convert("YCbCr").save(buf, "JPEG2000", **kw)
    assert _same(buf.getvalue()) == "equal"
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (21, 30, 4), np.uint8)).save(
        buf, "JPEG2000", **{**kw, "no_jp2": True})
    data = fm.jp2_wrap(buf.getvalue(), 30, 21, 4,
                       colr=b"\x01\x00\x00\x00\x00\x00\x12")
    assert _same(data) == "equal"


# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,nch,bits", [
    (0, 1, 1), (0, 1, 8), (1, 1, 8), (1, 2, 8), (2, 1, 8), (3, 3, 8),
    (3, 4, 8), (3, 5, 8), (4, 4, 8), (4, 5, 8), (7, 3, 8), (8, 1, 8),
    (3, 2, 8), (3, 3, 16)])
def test_psd_modes(mode, nch, bits):
    """Every mode of PsdImagePlugin.MODES (bitmap, grey, indexed with and
    without its palette, RGB, RGBA, CMYK, multichannel, duotone; too few
    channels and 16 bits, which PIL refuses), raw and RLE, with and
    without image resources and a layer section, a first row whose
    record runs on into the next, at 1x1, odd and wide sizes."""
    rng = np.random.default_rng(17600 + 16 * mode + nch + bits)
    refused = nch < 3 and mode == 3 or bits == 16
    seen = []
    for h, w in ((1, 1), (5, 7), (17, 33), (8, 130)):
        for rle, layers, res, spill in ((False, False, True, False),
                                        (True, False, False, False),
                                        (True, True, True, False),
                                        (True, True, True, True),
                                        (False, True, False, False)):
            ch = rng.integers(0, 2 if bits == 1 else 256, (nch, h, w))
            ch[:, :, :w // 2] = ch[:, :, :1]               # runs
            pal = rng.integers(0, 256, (256, 3)) if mode == 2 and rle \
                else None
            data = fm.psd_bytes(ch, mode, bits, rle=rle, layers=layers,
                                resources=res, spill=spill, palette=pal)
            seen.append(_same(data))
    # PIL reads the byte counts of the channels its mode takes only, so
    # with more channels it decodes the rest of the table as rows, and a
    # row whose record runs on moves the rows after it: either may then
    # run past the end of the file, in PIL and the port alike
    if refused:
        assert set(seen) == {"raise"}
    else:
        assert seen.count("equal") >= 12


def test_psd_refusals():
    """LAB (refused by name before its slice) decodes as PIL converts it,
    through LittleCMS; a compression PIL does not know and a PSB (version
    2) file raise, as in PIL."""
    ch = np.random.default_rng(17700).integers(0, 256, (3, 5, 7))
    assert isinstance(pil_outcome(fm.psd_bytes(ch, 9)), np.ndarray)
    assert _same(fm.psd_bytes(ch, 9)) == "equal"
    assert _same(fm.psd_bytes(ch, 9, rle=True)) == "equal"
    assert _same(fm.psd_bytes(ch, 3, compression=2)) == "raise"
    assert _same(fm.psd_bytes(ch, 3, version=2)) == "raise"


# ---------------------------------------------------------------------------
# AVIF frames libavif scales
# ---------------------------------------------------------------------------

def _libavif_scale():
    """The bundled libavif's avifImageScale on one grey plane (ctypes): the
    libyuv ScalePlane that PIL's AVIF decode runs."""
    import PIL._avif  # noqa: F401  (loads the library and its libyuv)
    lib = ctypes.CDLL(glob.glob(os.path.join(
        os.path.dirname(Image.__file__), "..", "pillow.libs",
        "libavif-*.so*"))[0])
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.avifImageScale.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                   ctypes.c_uint32, ctypes.c_void_p]
    lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
    diag = ctypes.create_string_buffer(1 << 16)

    def scale(plane, dw, dh):
        h, w = plane.shape
        im = lib.avifImageCreate(w, h, 8, 4)            # 8-bit 4:0:0
        lib.avifImageAllocatePlanes(im, 1)

        def field(off, typ):
            return typ.from_address(im + off).value
        p, rb = field(24, ctypes.c_void_p), field(48, ctypes.c_uint32)
        for y in range(h):
            ctypes.memmove(p + y * rb, plane[y].tobytes(), w)
        assert lib.avifImageScale(im, dw, dh, diag) == 0
        assert (field(0, ctypes.c_uint32), field(4, ctypes.c_uint32)) == (
            dw, dh)
        p, rb = field(24, ctypes.c_void_p), field(48, ctypes.c_uint32)
        out = np.array([np.frombuffer(ctypes.string_at(p + y * rb, dw),
                                      np.uint8) for y in range(dh)])
        lib.avifImageDestroy(im)
        return out
    return scale


def test_scale_plane_is_libyuvs():
    """scale_plane against the libavif PIL runs, on sizes that reach every
    path of libyuv's ScalePlane with the box filter: copies, vertical
    only, 3/4, 1/2, 3/8 and 1/4 down (the SSSE3 rows for 3/4 and 3/8 and
    the C rows that finish their widths), box averages, the exact 2x
    linear and bilinear up-samplers (odd and even widths), bilinear up
    and down, point sampling of one-pixel sources."""
    scale = _libavif_scale()
    rng = np.random.default_rng(17800)
    pairs = set()
    for sw, sh in ((1, 1), (1, 5), (5, 1), (3, 2), (8, 8), (13, 17),
                   (32, 24), (48, 16), (64, 33), (65, 12), (96, 64)):
        for dw in {1, 2, sw // 4 or 1, sw // 2 or 1, 3 * sw // 4 or 1,
                   3 * sw // 8 or 1, sw - 1 or 1, sw, sw + 1, 2 * sw - 1,
                   2 * sw, 3 * sw}:
            for dh in {1, sh // 4 or 1, sh // 2 or 1, 3 * sh // 4 or 1,
                       3 * sh // 8 or 1, sh, sh + 1, 2 * sh - 1, 2 * sh}:
                pairs.add((sw, sh, dw, dh))
    pairs |= {(700, 700, 1, 1), (1023, 767, 100, 77), (640, 480, 960, 720)}
    for sw, sh, dw, dh in sorted(pairs):
        p = rng.integers(0, 256, (sh, sw), dtype=np.uint8)
        if (sw * sh) % 3 == 0:
            p = np.where(rng.random((sh, sw)) < 0.5, 0, 255).astype(np.uint8)
        assert np.array_equal(yuvscale.scale_plane(p, dw, dh),
                              scale(p, dw, dh)), (sw, sh, dw, dh)


@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_avif_scaled_stills(sub):
    """A still (with and without alpha) whose ispe libavif scales it to,
    up and down, odd sizes and a 1x1: each plane scaled on its own
    (chroma to the subsampled size), then libavif's YUV to RGB."""
    rng = np.random.default_rng(17900)
    for h, w, c in ((48, 64, 3), (33, 17, 4)):
        px = rng.integers(0, 256, (h, w, c), np.uint8)
        px[:, : w // 2] = px[:, :1]
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "AVIF", quality=60, subsampling=sub,
                                 max_threads=1)
        for dw, dh in ((2 * w, 2 * h), (w + 3, h - 1), (w // 2, h // 2),
                       (3 * w // 4, 3 * h // 4), (w, h + 5), (1, 1)):
            assert held_to_pil(fm.scaled_avif(buf.getvalue(), dw,
                                              dh)) == "equal"


def test_avif_scaled_grid_and_sequence():
    """A grid's tiles scaled to their ispe (libavif's tile checks then see
    the scaled size) and an image sequence's first frame scaled to its
    track header size."""
    grid = _read("scenes/data/formats_f/grid_1x2.avif")
    for tw, th in ((70, 64), (64, 70), (60, 64), (128, 64)):
        assert held_to_pil(fm.scaled_avif(grid, tw, th, which=(0,))) in (
            "equal", "raise")
    assert held_to_pil(fm.scaled_avif(grid, 70, 64, which=(0,))) == "equal"
    seq = _read("scenes/data/formats_f/photo_sequence.avif")
    for w, h in ((512, 512), (251, 259)):
        assert held_to_pil(fm.scaled_avif(seq, w, h)) == "equal"


# ---------------------------------------------------------------------------
# cut and mutated streams
# ---------------------------------------------------------------------------

CUT = [f"{FOLDER}/{n}" for n in (
    "logo_int16_signed.tif", "odd_float_mm_tiles_lzw_pred3.tif",
    "odd_ycbcr_4x4_tiles_deflate.tif", "odd_ycbcr_2x1_mm_pred2.tif",
    "odd_sycc.j2k", "odd_sycc_rgba.jp2", "odd_rgba_rle.psd",
    "odd_bitmap.psd", "odd_scaled_420_rgba.avif", "sequence_scaled.avif")]


def _allowed(outcome: str, data: bytes) -> bool:
    if outcome != "refused":
        return True
    with pytest.raises(NotImplementedError) as e:
        ttex.decode_image(data)
    return any(r in str(e.value) for r in REFUSALS)


@pytest.mark.parametrize("path", CUT)
def test_cut_streams(path):
    """A file of each new layout cut by 1 to 40 bytes: the port's outcome
    is PIL's on each."""
    data = _read(path)
    for k in range(1, 41):
        cut = data[:-k]
        assert _allowed(held_to_pil(cut), cut)


FUZZ = {
    "float_signed_tiff": ["logo_int16_signed.tif",
                          "odd_float_mm_tiles_lzw_pred3.tif",
                          "odd_float_minwhite_raw.tif",
                          "odd_int32_signed_packbits.tif",
                          "odd_uint32_lzw_pred2.tif"],
    "ycbcr_tiff": ["odd_ycbcr_4x4_tiles_deflate.tif",
                   "odd_ycbcr_4x2_bt709_studio.tif",
                   "odd_ycbcr_2x1_mm_pred2.tif", "odd_ycbcr_1x2_lzw.tif",
                   "odd_ycbcr_pil_packbits.tif"],
    "sycc_jpeg2000": ["odd_sycc.j2k", "odd_sycc_rgba.jp2"],
    "psd": ["odd_bitmap.psd", "odd_grey_rle.psd", "odd_indexed.psd",
            "odd_multichannel_spill.psd", "odd_rgba_rle.psd",
            "odd_cmyk5_raw.psd", "odd_duotone_layers.psd"],
    "scaled_avif": ["odd_scaled_420_rgba.avif", "sequence_scaled.avif",
                    "grid_scaled_tiles.avif"],
}


@pytest.mark.parametrize("kind", sorted(FUZZ))
def test_mutation_fuzz(kind):
    """200 mutations of the kind's small committed files, each of 1-3
    bytes (a random value, or one bit flipped), half of them in the
    headers (a TIFF's directory, a PSD's sections, the boxes before a
    JP2's codestream or an AVIF's media data): the port is byte-equal
    wherever PIL decodes, raises wherever PIL raises, and names only the
    features of REFUSALS."""
    files = [_read(f"{FOLDER}/{n}") for n in FUZZ[kind]]
    rng = np.random.default_rng(18000 + sorted(FUZZ).index(kind))
    seen = []
    for _ in range(200):
        data = bytearray(files[int(rng.integers(0, len(files)))])
        if data[:2] in (b"II", b"MM"):
            head = (struct.unpack((">" if data[:2] == b"MM" else "<") + "I",
                                  data[4:8])[0], len(data))
        elif data.startswith(b"8BPS"):
            head = (0, min(len(data), 200))
        elif b"mdat" in data:
            head = (0, data.index(b"mdat"))
        else:
            head = (0, min(len(data), 160))
        for _ in range(int(rng.integers(1, 4))):
            lo, hi = head if rng.random() < 0.5 else (0, len(data))
            i = int(rng.integers(lo, hi))
            data[i] = (int(rng.integers(0, 256)) if rng.random() < 0.7
                       else data[i] ^ (1 << int(rng.integers(0, 8))))
        outcome = held_to_pil(bytes(data))
        assert _allowed(outcome, bytes(data))
        seen.append(outcome)
    assert seen.count("equal") >= 20


# ---------------------------------------------------------------------------
# every mode PIL writes, in every format and TIFF compression it writes
# ---------------------------------------------------------------------------

SCAN_MODES = ("1", "L", "LA", "La", "P", "PA", "RGB", "RGBA", "RGBa",
              "RGBX", "CMYK", "YCbCr", "LAB", "HSV", "I", "I;16", "I;16L",
              "I;16B", "I;16N", "F")
# PIL's writers here (BUFR, GRIB, HDF5 and WMF need handlers it lacks);
# ICNS writes every size of the image as PNG or JPEG 2000 entries, so
# three modes cover its entries
SCAN_FORMATS = ("AVIF", "BLP", "BMP", "DDS", "DIB", "EPS", "GIF", "ICNS",
                "ICO", "IM", "JPEG", "JPEG2000", "MPO", "MSP", "PALM",
                "PCX", "PDF", "PNG", "PPM", "QOI", "SGI", "SPIDER", "TGA",
                "TIFF", "WEBP", "XBM")
SCAN_TIFF = ("tiff_lzw", "packbits", "tiff_deflate", "tiff_adobe_deflate",
             "jpeg", "group3", "group4", "tiff_ccitt", "tiff_raw_16",
             "lzma", "zstd")
SCAN_REFUSED = ("CCITT RLEW",)


def _scan_cases(fmt: str):
    if fmt.startswith("TIFF-"):
        comp = fmt[5:]
        # libtiff's JPEG and CCITT coders abort the process on other modes
        modes = {"jpeg": ("L", "RGB", "RGBX", "CMYK", "YCbCr", "LAB")}.get(
            comp, ("1",) if comp in SCAN_TIFF[5:9] else SCAN_MODES)
        return "TIFF", modes, {"compression": comp}
    modes = ("1", "P", "RGBA") if fmt == "ICNS" else SCAN_MODES
    return fmt, modes, {}


@pytest.mark.parametrize("fmt", SCAN_FORMATS + tuple(
    f"TIFF-{c}" for c in SCAN_TIFF))
def test_mode_by_format_scan(fmt):
    """A seeded 53x37 image in every mode PIL writes in this format: each
    file PIL writes decodes equal to PIL, raises where PIL raises, or is
    refused naming CCITT RLEW TIFF."""
    save_fmt, modes, kw = _scan_cases(fmt)
    rng = np.random.default_rng(17)
    px4 = rng.integers(0, 256, (37, 53, 4), np.uint8)
    px16 = rng.integers(0, 600, (37, 53)).astype(np.uint16)
    for mode in modes:
        res = _ask(save_fmt, px16 if mode.startswith("I;16") else px4,
                   mode=mode, **kw)
        if res is None or res[0] != "ok":
            continue                      # PIL does not write this mode
        data = res[1]
        outcome = held_to_pil(data)
        if outcome == "refused":
            with pytest.raises(NotImplementedError) as e:
                ttex.decode_image(data)
            assert any(r in str(e.value) for r in SCAN_REFUSED), (
                mode, str(e.value))
