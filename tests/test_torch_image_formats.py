"""The port's decoders of the texture formats beyond PNG, JPEG, GIF, BMP and
plain TIFF (scene/tga.py, pnm.py, dds.py, sgi.py, pcx.py, qoi.py and
bmp.py's DIB, behind scene/texture.py::load_image) against PIL and the
JAX package's `load_image(path, 1.0)`: array-equal on every file, no
tolerance; and `texture.image_format` names every file as PIL's `open`
names it (its `format`), the weak and missing signatures (TGA, DIB, PCX)
included.

This file holds the committed files of scenes/data/formats (pinned
digests, PIL, the JAX package, the PNG each lossless one re-encodes),
sweeps of each format's modes and layouts on seeded images of several
sizes, written by PIL where it writes them and by
tools/make_image_formats.py's writers where it does not, and the
refusals: a valid file of a mode still left raises NotImplementedError
naming the format and the mode, malformed data ValueError. The TIFF
compressions (JPEG, CCITT) are in test_torch_image_formats_tiff.py.
"""
import hashlib
import io
import os
import struct
import time

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from rlshaders_tpu.scene import texture as jtex
from test_torch_gpu import FORMAT_DIGESTS
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from tools import make_image_modes as modes
from rlshaders_tpu_torch.scene import texture as ttex
from rlshaders_tpu_torch.scene.bmp import decode_dib
from rlshaders_tpu_torch.scene.dds import decode_dds
from rlshaders_tpu_torch.scene.pcx import decode_pcx
from rlshaders_tpu_torch.scene.pnm import decode_pnm
from rlshaders_tpu_torch.scene.qoi import decode_qoi
from rlshaders_tpu_torch.scene.sgi import decode_sgi
from rlshaders_tpu_torch.scene.tga import decode_tga

SIZES = [(1, 1), (5, 3), (13, 9), (37, 23)]   # (width, height)
SMALL = 64 * 1024
BIG = "scenes/data/formats/texture_2048_dxt1.dds"


def same(tmp_path, data: bytes, name: str = "x") -> np.ndarray:
    """same_as_reference, and the port names the format as PIL does."""
    assert ttex.image_format(data) == Image.open(io.BytesIO(data)).format
    return same_as_reference(tmp_path, data, name)


def _image(w: int, h: int, seed: int, channels: int = 4) -> np.ndarray:
    """Seeded pixels of few colours in runs (so run-length coders find
    repeats) with noise between them."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (6, channels))
    idx = np.repeat(rng.integers(0, 6, (h, (w + 2) // 3)), 3, axis=1)[:, :w]
    px = colours[idx]
    noise = rng.random((h, w)) < 0.3
    px[noise] = rng.integers(0, 256, (int(noise.sum()), channels))
    return px.astype(np.uint8)


def _pil(px, mode: str, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(px)
    if mode == "P":
        img = img.convert("RGB").quantize(5, dither=0)
    elif mode:
        img = img.convert(mode)
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

FORMAT_FILES = sorted(FORMAT_DIGESTS)
# the files that re-encode scenes/data/grid.png or logo.png losslessly
LOSSLESS = ("grid.qoi", "logo_rle.tga", "logo_palette.pcx",
            "logo_palette.dib", "grid_rle.sgi", "grid_rgb.pcx",
            "grid_planes4.pcx", "logo_rgba.qoi")


def test_digests_cover_the_files():
    """Every file of scenes/data/formats is pinned, in both copies of the
    digests, the tool writes the committed bytes, and every file but the
    2048x2048 DDS is at most 64 KB."""
    names = sorted(f"scenes/data/formats/{n}"
                   for n in os.listdir("scenes/data/formats"))
    assert names == FORMAT_FILES
    assert chip_smoke.FORMAT_DIGESTS == FORMAT_DIGESTS
    made = fm.files()
    for path in FORMAT_FILES:
        with open(path, "rb") as f:
            assert f.read() == made[os.path.basename(path)], path
        if path != BIG:
            assert os.path.getsize(path) <= SMALL, path


@pytest.mark.parametrize("path", FORMAT_FILES, ids=os.path.basename)
def test_committed_file(tmp_path, path):
    with open(path, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    want = same(tmp_path, data, os.path.basename(path))
    assert time.perf_counter() - t0 < 30.0
    assert hashlib.sha256(want.tobytes()).hexdigest() == FORMAT_DIGESTS[path]
    name = os.path.basename(path)
    if name in LOSSLESS:
        source = "grid" if name.startswith("grid") else "logo"
        ref = jtex.load_image(f"scenes/data/{source}.png", 1.0)
        assert np.array_equal(ttex.load_image(path), ref)


COMMITTED = sorted(os.path.join(d, n) for d, _, names in os.walk("scenes/data")
                   for n in names)


@pytest.mark.parametrize("path", COMMITTED)
def test_every_committed_image_is_named_as_pil_names_it(path):
    """Every image file of scenes/data (the textures, the image modes and
    the formats) is named by the port as PIL's `open` names it."""
    with open(path, "rb") as f:
        data = f.read()
    assert ttex.image_format(data) == Image.open(io.BytesIO(data)).format


def test_big_dds_is_made_from_the_seed():
    """The 2048x2048 texture is DXT1 blocks of make_image_modes'
    seeded texture: a game texture's size and format."""
    with open(BIG, "rb") as f:
        data = f.read()
    assert data[84:88] == b"DXT1"
    assert struct.unpack_from("<II", data, 12) == (2048, 2048)
    assert len(data) == 128 + 2048 * 2048 // 2
    px = decode_dds(data).astype(np.int64)
    src = modes.big_texture().astype(np.int64)
    assert np.abs(px - src).mean() < 4.0
    assert np.abs(px - modes.big_texture(modes.SEED + 1)).mean() > 20.0


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("orientation", [-1, 1], ids=["up", "down"])
def test_tga_pil_modes(tmp_path, mode, rle, orientation):
    """PIL's own TGAs of every mode it writes; PIL cannot read its own
    run-length mode "1" files, which the port refuses by name."""
    for w, h in SIZES:
        data = _pil(_image(w, h, w + h), mode, "TGA", rle=rle,
                    orientation=orientation)
        if mode == "1" and rle:
            with pytest.raises(OSError):
                Image.open(io.BytesIO(data)).load()
            with pytest.raises(NotImplementedError, match="TGA.*1-bit"):
                ttex.decode_image(data)
            continue
        same(tmp_path, data)


TGA_LAYOUTS = [
    # (image type, bits, colour-map bits, map start, descriptor, across)
    (1, 8, 24, 0, 0x00, False), (1, 8, 16, 2, 0x20, False),
    (1, 8, 24, 7, 0x10, False), (9, 8, 24, 0, 0x30, True),
    (9, 8, 16, 5, 0x00, False), (2, 16, None, 0, 0x00, False),
    (10, 16, None, 0, 0x30, True), (2, 24, None, 0, 0x10, False),
    (10, 24, None, 0, 0x20, True), (10, 32, None, 0, 0x10, False),
    (3, 8, None, 0, 0x30, False), (11, 8, None, 0, 0x00, True),
    (3, 16, None, 0, 0x10, False), (11, 16, None, 0, 0x20, False),
    (3, 1, None, 0, 0x20, False), (3, 1, None, 0, 0x10, False),
]


@pytest.mark.parametrize("layout", TGA_LAYOUTS, ids=str)
def test_tga_layouts(tmp_path, layout):
    """Every image type and depth PIL reads, colour maps of 16 and 24 bits
    with a first entry past 0 (indices past the map read black),
    both origin bits, and literal packets that run on across rows."""
    itype, depth, cdepth, start, flags, across = layout
    for w, h in SIZES:
        px = _image(w, h, w * h + depth)
        cmap = None
        if itype & 7 == 1:
            cmap = px[0, :3, :3].repeat(2, 0)            # 6 entries
            img = np.random.default_rng(w).integers(0, start + 8, (h, w))
        elif itype & 7 == 3:
            img = (px[..., 0] & 1 if depth == 1 else
                   px[..., :depth // 8] if depth == 16 else px[..., 0])
        else:
            img = px
        data = fm.tga_bytes(img, itype, depth, cmap=cmap,
                            cmap_depth=cdepth or 24, cmap_start=start,
                            flags=flags, across=across,
                            ident=bytes(range(w % 7 + 1)))
        same(tmp_path, data)


def test_tga_and_pcx_share_a_signature_as_in_pil():
    """TGA has no signature: a TGA whose ID field is 10 bytes long and
    which has no colour map starts as a PCX does, and PIL takes it for a
    PCX (and then fails: no PCX mode of its header). The port names it
    PCX too and refuses it; with a colour map both take it as TGA."""
    px = _image(6, 4, 1)
    data = fm.tga_bytes(px, 2, 24, ident=b"0123456789")
    with pytest.raises(OSError, match="PCX"):
        Image.open(io.BytesIO(data))
    assert ttex.image_format(data) == "PCX"
    with pytest.raises(NotImplementedError, match="PCX"):
        ttex.decode_image(data)
    mapped = fm.tga_bytes(px[..., 0] % 3, 1, 8, cmap=px[0, :3, :3],
                          ident=b"0123456789")
    assert Image.open(io.BytesIO(mapped)).format == "TGA"
    assert ttex.image_format(mapped) == "TGA"
    assert np.array_equal(ttex.decode_image(mapped), np.asarray(
        Image.open(io.BytesIO(mapped)).convert("RGB")))


# ---------------------------------------------------------------------------
# PNM and PFM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "I", "RGB", "RGBA"])
def test_pnm_pil_modes(tmp_path, mode):
    """PIL's P4, P5 (maxval 255, and 65535 from mode "I", which PIL opens
    as "I" and converts clamped to 255) and P6 files."""
    for w, h in SIZES:
        px = _image(w, h, w + 7)
        if mode == "I":
            img = Image.fromarray((px[..., 0].astype(np.int32) * 3) % 700)
            buf = io.BytesIO()
            img.save(buf, "PPM")
            data = buf.getvalue()
        else:
            data = _pil(px, mode, "PPM")
        same(tmp_path, data)


@pytest.mark.parametrize("magic,maxval", [
    (m, v) for m in ("P1", "P2", "P3", "P4", "P5", "P6")
    for v in ((1,) if m in ("P1", "P4") else (1, 15, 255, 256, 1000, 65535))])
def test_pnm_layouts(tmp_path, magic, maxval):
    """Plain and binary bit, grey and colour maps at maxvals of 1 to 65535
    (one and two bytes a binary sample; samples scaled as round(v /
    maxval * top), halves to even; grey above 255 opens as mode "I"),
    comments in the header and in plain data."""
    for w, h in SIZES:
        rng = np.random.default_rng(w * maxval)
        shape = (h, w, 3) if magic in ("P3", "P6") else (h, w)
        px = rng.integers(0, maxval + 1, shape)
        px.flat[0] = maxval // 2                  # a half-way sample
        same(tmp_path, fm.pnm_bytes(px, magic, maxval))


def test_pfm_values(tmp_path):
    """PFM grey in both byte orders: PIL's mode "F" converts to RGB
    truncating toward zero and clamping (0.6 -> 0, 2.5 -> 2, 300 -> 255,
    negatives 0), rows from the bottom up."""
    vals = np.array([[0.6, 2.5, 300.0, -0.6, -3.0, 255.9],
                     [1e30, -1e30, 254.99, 128.5, 0.0, 17.0]], np.float32)
    data = _pil(vals, "", "PPM")
    assert data.startswith(b"Pf\n") and b"-1.0" in data
    same(tmp_path, data)
    assert decode_pnm(data)[:, :, 0].tolist() == [[0, 2, 255, 0, 0, 255],
                                                  [255, 0, 254, 128, 0, 17]]
    big = b"Pf\n6 2\n1.0\n" + vals[::-1].astype(">f4").tobytes()
    same(tmp_path, big)
    for w, h in SIZES:
        f = np.random.default_rng(w).normal(100, 120, (h, w))
        same(tmp_path, _pil(f.astype(np.float32), "", "PPM"))


# ---------------------------------------------------------------------------
# SGI, PCX, QOI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("rle", [False, True], ids=["verbatim", "rle"])
def test_sgi(tmp_path, mode, bpc, rle):
    """PIL's verbatim SGI files (one and two bytes a sample) and run-length
    ones by hand; 16-bit samples keep their high byte."""
    z = len(mode)
    for w, h in SIZES:
        px = _image(w, h, w + z, z)
        if rle:
            wide = px.astype(np.int64) * 256 + np.random.default_rng(
                w).integers(0, 256, px.shape)
            data = fm.sgi_bytes(wide if bpc == 2 else px, bpc)
        else:
            data = _pil(px[..., 0] if z == 1 else px, mode, "SGI", bpc=bpc)
        same(tmp_path, data)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_pcx_pil_modes(tmp_path, mode):
    for w, h in SIZES + [(2, 3), (16, 5), (31, 4)]:
        data = _pil(_image(w, h, w + 3), mode, "PCX")
        if (w, h) == (1, 1) and mode == "RGB":
            # PIL reads too few bytes of its own 1x1 RGB file
            with pytest.raises(OSError):
                Image.open(io.BytesIO(data)).load()
            with pytest.raises(ValueError):
                decode_pcx(data)
            continue
        same(tmp_path, data)


@pytest.mark.parametrize("planes", [2, 4])
def test_pcx_bit_planes(tmp_path, planes):
    """1-bit planes through the header's 16-colour palette, at widths
    where PIL's unpacker reads the planes where its line buffer does not
    hold them (as PIL does)."""
    for w, h in SIZES + [(8, 2), (16, 3), (24, 5)]:
        idx = np.random.default_rng(w).integers(0, 1 << planes, (h, w))
        pal = np.random.default_rng(h).integers(0, 256, (16, 3))
        same(tmp_path, fm.pcx_planes_bytes(idx, pal.astype(np.uint8),
                                           planes))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi(tmp_path, mode):
    """PIL's QOI files: runs, index hits, small and luma differences and
    full pixels all occur in the seeded images."""
    for w, h in SIZES + [(64, 40)]:
        px = _image(w, h, w, 4)
        px[h // 2:, :, 3] = 255
        ramp = np.cumsum(np.random.default_rng(w).integers(-2, 3, (h, w, 4)),
                         axis=1) % 256
        px[: h // 3] = ramp[: h // 3]
        same(tmp_path, _pil(px, mode, "QOI"))


# ---------------------------------------------------------------------------
# DDS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,fmt", [
    ("RGB", None), ("RGBA", None), ("L", None), ("LA", None),
    ("RGB", "DXT1"), ("RGBA", "DXT1"), ("RGBA", "DXT3"), ("RGBA", "DXT5"),
    ("RGBA", "BC2"), ("RGBA", "BC3"), ("RGB", "BC5")])
def test_dds_pil(tmp_path, mode, fmt):
    """PIL's DDS files: uncompressed, DXT1/BC1 (both colour modes occur:
    PIL's encoder writes c0 <= c1 blocks for transparent pixels), DXT3,
    DXT5, BC2, BC3 (as DX10) and BC5, at sizes that are no multiple of
    the 4x4 block."""
    for w, h in SIZES + [(8, 8), (17, 6)]:
        px = _image(w, h, w + 11)
        px[..., 3] = np.where(px[..., 3] < 40, 0, 255)
        kw = {"pixel_format": fmt} if fmt else {}
        same(tmp_path, _pil(px, mode, "DDS", **kw))


def _blocks(w: int, h: int, size: int, seed: int) -> bytes:
    n = -(-w // 4) * -(-h // 4)
    return np.random.default_rng(seed).integers(
        0, 256, n * size).astype(np.uint8).tobytes()


DDS_LAYOUTS = {
    # name: (pixel format flags, fourcc, bits, masks, DXGI format, block)
    "bc1_random": (0x4, b"DXT1", 0, (0,) * 4, None, 8),
    "bc3_random": (0x4, b"DXT5", 0, (0,) * 4, None, 16),
    "bc5_ati2": (0x4, b"ATI2", 0, (0,) * 4, None, 16),
    "bc5_signed": (0x4, b"BC5S", 0, (0,) * 4, None, 16),
    "dx10_bc1": (0x4, b"DX10", 0, (0,) * 4, 71, 8),
    "dx10_bc5_snorm": (0x4, b"DX10", 0, (0,) * 4, 84, 16),
    "dx10_rgba8": (0x4, b"DX10", 0, (0,) * 4, 28, None),
    "rgb565": (0x40, b"\0" * 4, 16, (0xF800, 0x7E0, 0x1F, 0), None, None),
    "rgba4444": (0x41, b"\0" * 4, 16, (0xF00, 0xF0, 0xF, 0xF000), None,
                 None),
    "bgr24": (0x40, b"\0" * 4, 24, (0xFF, 0xFF00, 0xFF0000, 0), None, None),
    "palette8": (0x20, b"\0" * 4, 8, (0,) * 4, None, None),
}


@pytest.mark.parametrize("name", DDS_LAYOUTS)
def test_dds_layouts(tmp_path, name):
    """Random blocks (every selector and both end-point orders), the
    signed BC5 end points, DX10 headers, masks PIL scales as
    int(v / max * 255), and a palette of RGBA entries."""
    flags, fourcc, bits, masks, dxgi, block = DDS_LAYOUTS[name]
    for w, h in SIZES + [(8, 4)]:
        rng = np.random.default_rng(w + h)
        if block:
            body = _blocks(w, h, block, w * h)
        elif fourcc == b"DX10" or flags == 0x20:
            body = rng.integers(0, 256, 4 * w * h + (1024 if flags == 0x20
                                                     else 0))
            body = body.astype(np.uint8).tobytes()
            if flags == 0x20:
                body = body[:1024 + w * h]
        else:
            body = rng.integers(0, 256, bits // 8 * w * h).astype(
                np.uint8).tobytes()
        same(tmp_path, fm.dds_bytes(w, h, body, flags, fourcc, bits, masks,
                                    dxgi))


# ---------------------------------------------------------------------------
# DIB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_dib_pil_modes(tmp_path, mode):
    """PIL's DIB files (a BMP without its file header), which PIL tells
    from other data by the header size in its first four bytes."""
    for w, h in SIZES:
        data = _pil(_image(w, h, w + 5), mode, "DIB")
        assert data[:4] == b"\x28\x00\x00\x00"
        same(tmp_path, data)


@pytest.mark.parametrize("bits,compression,masks,header", [
    (4, 2, None, 40), (8, 1, None, 40), (16, 3, (0xF800, 0x7E0, 0x1F), 40),
    (32, 3, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 108), (1, 0, None, 12),
    (8, 0, None, 124), (24, 0, None, 56)])
def test_dib_layouts(tmp_path, bits, compression, masks, header):
    """make_image_modes' BMPs without their file header: RLE, bitfields
    (read from after a 40-byte header), OS/2 and V5 headers."""
    for w, h in SIZES:
        rng = np.random.default_rng(w + bits)
        if bits <= 8:
            px = rng.integers(0, 1 << min(bits, 3), (h, w))
            pal = rng.integers(0, 256, (1 << min(bits, 3), 3))
            data = modes.bmp_bytes(px, bits, palette=pal,
                                   compression=compression, header=header)
        else:
            data = modes.bmp_bytes(_image(w, h, w)[..., :3], bits,
                                   compression=compression, masks=masks,
                                   header=header)
        same(tmp_path, data[14:])


# ---------------------------------------------------------------------------
# refusals and malformed data
# ---------------------------------------------------------------------------

def _dx10(dxgi: int) -> bytes:
    return fm.dds_bytes(8, 8, bytes(64), 0x4, b"DX10", dxgi=dxgi)


@pytest.mark.parametrize("data,fmt,what", [
    (_dx10(2), "DDS", "DXGI format 2"), (_dx10(94), "DDS", "BC6H"),
    (_dx10(81), "DDS", "BC4"),
    (fm.dds_bytes(8, 8, bytes(64), 0x4, b"BC4S"), "DDS", "BC4"),
    (fm.dds_bytes(4, 4, bytes(32), 0x20000, bitcount=16), "DDS",
     "luminance of 16 bits"),
    (fm.tga_bytes(np.zeros((2, 9), np.int64), 11, 1), "TGA", "1-bit"),
    (fm.tga_bytes(np.zeros((2, 3), np.int64), 1, 8, cmap=[(1, 2, 3)] * 3,
                  cmap_depth=32), "TGA", "32-bit entries"),
    (b"PyRGBA\n2 2\n255\n" + bytes(16), "PPM", "PyRGBA"),
    (modes.bmp_bytes(np.zeros((2, 2), np.int64), 2,
                     palette=[(1, 2, 3)] * 4)[14:], "DIB", "2-bit BMP"),
    (fm.sgi_bytes(np.zeros((2, 2, 2), np.int64), rle=False), "SGI",
     "2 channels"),
], ids=["dxgi-2", "bc6h", "bc4-dx10", "bc4", "dds-l16", "tga-rle1",
        "tga-map32",
        "pnm-ext",
        "dib-2bit", "sgi-2ch"])
def test_modes_still_left_raise(data, fmt, what):
    """A valid file of a mode the port does not decode raises
    NotImplementedError naming the format and the mode; PIL takes it for
    the same format (and opens it, or refuses the mode too). The DDS
    cases are formats PIL refuses as well: a float DXGI format, BC6H
    TYPELESS and BC4 SNORM (DXGI 81, FourCC BC4S)."""
    assert ttex.image_format(data) == fmt
    try:
        assert Image.open(io.BytesIO(data)).format == fmt
    except (OSError, ValueError, NotImplementedError):
        pass                               # PIL refuses the mode too
    with pytest.raises(NotImplementedError, match=f"{fmt}.*{what}|"
                                                  f"{what}.*{fmt}"):
        ttex.decode_image(data)


def test_pam_is_not_a_pil_format():
    """PIL 12.1.0 opens no PAM (P7) file, so the JAX package cannot load
    one; the port names it and refuses it."""
    data = fm.pam_bytes(np.zeros((2, 3, 3), np.int64))
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data))
    with pytest.raises(NotImplementedError, match="PAM"):
        ttex.decode_image(data)


@pytest.mark.parametrize("decode,data", [
    (decode_tga, _pil(_image(9, 7, 1), "RGB", "TGA")[:100]),
    (decode_tga, _pil(_image(9, 7, 1), "RGB", "TGA", rle=True)[:60]),
    (decode_pnm, b"P6\n4 4\n255\n" + bytes(10)),
    (decode_pnm, b"P2\n2 1\n15\n3 16\n"),
    (decode_pnm, b"P6\n4 x\n255\n"),
    (decode_dds, _pil(_image(8, 8, 1), "RGB", "DDS",
                      pixel_format="DXT1")[:140]),
    (decode_sgi, _pil(_image(5, 5, 1), "RGB", "SGI")[:520]),
    (decode_sgi, fm.sgi_bytes(_image(5, 5, 1)[..., :3])[:700]),
    (decode_pcx, _pil(_image(9, 7, 1), "RGB", "PCX")[:130]),
    (decode_qoi, _pil(_image(9, 7, 1), "RGB", "QOI")[:30]),
    (decode_dib, b"\x28\x00\x00\x00" + bytes(8)),
], ids=["tga", "tga-rle", "ppm", "pgm-plain", "ppm-header", "dds", "sgi",
        "sgi-rle", "pcx", "qoi", "dib"])
def test_malformed_data_raises_value_error(decode, data):
    with pytest.raises(ValueError):
        decode(data)
