"""ZSTD TIFF, LAB and nine more of PIL's plugins against PIL 12.1.0, the
decoder behind the JAX package's `Image.open(path).convert("RGB")`:
byte-equal, no tolerance.

* ZSTD TIFF (scene/zstd.py over csrc/zstd.cpp): the frame decoder held
  to `zstandard` on a sweep of levels -7 to 22, checksums and content
  sizes on and off, long-distance matching, raw and RLE blocks, several
  and skippable frames; then TIFF strips and tiles, predictors 1-3, both
  byte orders and every frame layout held to PIL (libtiff's codec reads
  one frame a strip and stops where the rows are full), cut and mutated;
* LAB (scene/lab.py): all 2^24 8-bit inputs held to Pillow's LittleCMS
  transform, in four cases; LAB TIFF under the seven compressions PIL
  writes, in strips and tiles, both byte orders; LAB PSD raw and RLE;
  ICCLab and ITULab raise as in PIL;
* Sun raster, XPM, DCX, FTEX, GBR, PIXAR, IMT, McIdas and XV thumbnail:
  seeded sweeps of what PIL opens, cut streams and a mutation fuzz;
* PIL's plugin order with IMT and IPTC after IM (fault 9), MPEG, which
  PIL opens and cannot load, and the decompression-bomb limit of each
  new decoder.

The committed files of scenes/data/formats_h are held to their digests,
the tool that writes them and the JAX package's `load_image(path, 1.0)`.
"""
import io
import os
import struct

import numpy as np
import pytest
import zstandard
from PIL import Image

import chip_smoke
from test_torch_gpu import FORMAT_H_DIGESTS
from test_torch_image_jpeg2000 import _ask, held_to_pil, pil_outcome
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from tools.make_image_modes import digest, tiff_bytes
from rlshaders_tpu_torch.scene import lab, zstd
from rlshaders_tpu_torch.scene import texture as ttex

FOLDER = "scenes/data/formats_h"
FILES = sorted(FORMAT_H_DIGESTS)
# what a cut or mutated file of these formats may be refused for (PIL
# decodes it, the port names what it does not decode)
REFUSALS = ("legacy (v0.5-v0.7) Zstandard", "read differently",
            "fails part way", "IPTC")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _allowed(outcome: str, data: bytes) -> bool:
    if outcome != "refused":
        return True
    with pytest.raises(NotImplementedError) as e:
        ttex.decode_image(data)
    return any(r in str(e.value) for r in REFUSALS)


def _odd(seed: int, h: int = 37, w: int = 53) -> np.ndarray:
    """(h, w, 3) uint8: smooth ramps with noise, so that coders find runs
    and matches as well as literals."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 4, y * 6, (x + y) * 3], -1) + rng.integers(
        0, 3, (h, w, 3))
    return (px % 256).astype(np.uint8)


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def test_digests_cover_the_files():
    """Every file of scenes/data/formats_h is pinned in both copies of the
    digests, the tool writes the committed bytes, and frames Q and R name
    committed files."""
    assert chip_smoke.FORMAT_H_DIGESTS == FORMAT_H_DIGESTS
    assert sorted(f"{FOLDER}/{n}" for n in os.listdir(FOLDER)) == FILES
    made = fm.files_h()
    assert sorted(f"{FOLDER}/{n}" for n in made) == FILES
    for name, data in made.items():
        assert data == _read(f"{FOLDER}/{name}"), name
    for images in chip_smoke.FORMAT_H_FRAMES.values():
        assert all(f"scenes/data/{n}" in FORMAT_H_DIGESTS for n in images)
    assert chip_smoke.FORMAT_H_SPLIT in FORMAT_H_DIGESTS


@pytest.mark.parametrize("path", FILES)
def test_committed_file(tmp_path, path):
    """The port's decode equals PIL's (and the JAX package's load_image)
    and the pinned digest; the port names the format as PIL does."""
    data = _read(path)
    same_as_reference(tmp_path, data)
    assert digest(data) == FORMAT_H_DIGESTS[path]
    assert ttex.image_format(data) == Image.open(io.BytesIO(data)).format


# ---------------------------------------------------------------------------
# Zstandard frames
# ---------------------------------------------------------------------------

def _sources() -> dict:
    rng = np.random.default_rng(18100)
    ramp = _odd(18101, 64, 96).tobytes()
    return {"empty": b"", "one": b"a", "zeros": bytes(70000),
            "noise": rng.integers(0, 256, 9000, np.uint8).tobytes(),
            "ramp": ramp, "ramp_x8": ramp * 8,
            "text": b"the quick brown fox jumps over the lazy dog. " * 900,
            "small_alphabet": rng.integers(0, 3, 150000,
                                           np.uint8).tobytes()}


@pytest.mark.parametrize("level", range(-7, 23))
def test_frames_held_to_zstandard(level):
    """Every source at each level, checksum and content size on and off
    (long-distance matching from level 16): `zstd.frames` gives back the
    source, as zstandard's decoder does."""
    for name, src in _sources().items():
        for checksum in (False, True):
            for size in (False, True):
                frame = fm.zstd_coder(level, checksum, size,
                                      ldm=level >= 16)(src)
                assert zstandard.ZstdDecompressor().decompressobj(
                ).decompress(frame) == src
                assert zstd.frames(frame, len(src)) == src, (name, checksum,
                                                             size)


def test_frame_features():
    """Raw and RLE blocks, Huffman literals in one and four streams with
    treeless reuse, every sequence table mode, several frames and
    skippable frames in one buffer, a dictionary id, a reserved bit, a
    bad checksum and a legacy magic, against zstandard."""
    rng = np.random.default_rng(18102)
    noise = rng.integers(0, 256, 300000, np.uint8).tobytes()
    frames = [fm.zstd_coder(3, True)(noise),          # raw blocks
              fm.zstd_coder(3, True)(bytes(300000)),  # RLE blocks
              fm.zstd_coder(19, True, True)(_sources()["text"] * 4)]
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    both = frames[0] + skip + frames[1] + frames[2]
    want = zstandard.ZstdDecompressor().decompressobj().decompress(both)
    assert want == noise
    assert zstd.frames(both, 10 ** 7) == noise + bytes(300000) + \
        _sources()["text"] * 4
    # the blocks these frames hold
    kinds = set()
    for f in frames:
        single, fcs = f[4] >> 5 & 1, f[4] >> 6
        at = 5 + (not single) + (1 << fcs if fcs else single)
        while True:
            head = int.from_bytes(f[at:at + 3], "little")
            kinds.add(head >> 1 & 3)
            at += 3 + (1 if head >> 1 & 3 == 1 else head >> 3)
            if head & 1:
                break
    assert kinds == {0, 1, 2}
    # a one-byte dictionary id in a frame of no content size
    plain = fm.zstd_coder(3)(b"hello world " * 10)
    dict_frame = plain[:4] + b"\x01" + plain[5:6] + b"\x07" + plain[6:]
    for bad in (dict_frame,
                frames[2][:4] + bytes([frames[2][4] | 8]) + frames[2][5:],
                frames[2][:-1] + bytes([frames[2][-1] ^ 1])):
        with pytest.raises(zstandard.ZstdError):
            zstandard.ZstdDecompressor().decompressobj().decompress(bad)
        with pytest.raises(ValueError):
            zstd.frames(bad, 10 ** 7)
    legacy = b"\x27\xb5\x2f\xfd" + frames[2][4:]
    with pytest.raises(NotImplementedError, match="legacy"):
        zstd.frames(legacy, 10 ** 7)


# ---------------------------------------------------------------------------
# ZSTD TIFF
# ---------------------------------------------------------------------------

def _zstd_tiff(px: np.ndarray, compress, **kw) -> bytes:
    kw.setdefault("rows_per_strip", 10)
    return tiff_bytes(px.astype(np.int64), 8, 2, compression=50000,
                      compress=compress, **kw)


def test_zstd_tiff_pil_writes():
    """What PIL writes under compression="zstd" (in its helper process:
    libtiff's predictor crashes on some modes): every mode it writes,
    with and without predictor 2, LAB included."""
    px = _odd(18200)
    seen = []
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA", "CMYK", "I;16", "I",
                 "F", "LAB", "YCbCr"):
        for info in ({}, {317: 2}):
            res = _ask("TIFF", px, mode=mode, compression="zstd",
                       tiffinfo=info)
            if res is None or res[0] != "ok":
                continue                  # PIL does not write this
            seen.append(held_to_pil(res[1]))
    assert set(seen) == {"equal"} and len(seen) >= 16


@pytest.mark.parametrize("level", [-7, -1, 1, 3, 9, 19, 22])
def test_zstd_tiff_sweep(level):
    """Strips and tiles, predictors 1 and 2 at 8 and 16 bits and 3 on
    floats, both byte orders, with and without checksums and content
    sizes: equal to PIL."""
    px = _odd(18300 + level)
    rng = np.random.default_rng(18300 + level)
    for i, (ck, size) in enumerate(((False, False), (True, False),
                                    (False, True), (True, True))):
        code = fm.zstd_coder(level, ck, size, ldm=level >= 19)
        order = "MM" if i % 2 else "II"
        assert held_to_pil(_zstd_tiff(px, code, order=order,
                                      predictor=1 + i % 2)) == "equal"
        assert held_to_pil(_zstd_tiff(px, code, tile=(16, 32),
                                      predictor=2, order=order)) == "equal"
        grey16 = rng.integers(0, 65536, (37, 53, 1))
        assert held_to_pil(tiff_bytes(
            grey16, 16, 1, order=order, compression=50000, predictor=2,
            rows_per_strip=7, compress=code)) == "equal"
        hgt = rng.normal(100, 30, (37, 53)).astype(np.float32)
        assert held_to_pil(fm.float_tiff(
            hgt, compression=50000, predictor=3, order=order,
            tile=(16, 16), compress=code)) == "equal"


def _raw_frame(_, size: int, blocks) -> bytes:
    """A single-segment frame of content size `size` and the given
    (type, size a header claims, bytes) blocks, none marked last."""
    out = b"\x28\xb5\x2f\xfd\xa0" + struct.pack("<I", size)
    for typ, n, body in blocks:
        out += (n << 3 | typ << 1).to_bytes(3, "little") + body
    return out


def test_zstd_tiff_frame_layouts():
    """How libtiff's codec reads a strip: the first frame only (a second
    frame whose bytes the rows need, or a first frame that is skippable,
    fails; a frame longer than the rows decodes its first rows), a
    checksum checked only where the frame ends before the rows are full,
    RLE and raw blocks, and data after the frame ignored."""
    px = _odd(18400)
    code = fm.zstd_coder(3, True)
    rows = 10 * 53 * 3

    def strip(fn):
        return _zstd_tiff(px, lambda d: fn(d))

    cases = {
        "two_frames": (strip(lambda d: code(d[:100]) + code(d[100:])),
                       "raise"),
        "skippable_first": (strip(lambda d: struct.pack(
            "<II", 0x184D2A50, 3) + b"abc" + code(d)), "raise"),
        "longer_frame": (strip(lambda d: code(d + bytes(500))), "equal"),
        "longer_with_size": (strip(lambda d: fm.zstd_coder(3, True, True)(
            d + b"tail" * 40)), "equal"),
        "trailing_bytes": (strip(lambda d: code(d) + b"junk" * 9), "equal"),
        "rle_blocks": (_zstd_tiff(np.full((37, 53, 3), 9, np.uint8), code),
                       "equal"),
        "raw_blocks": (_zstd_tiff(np.random.default_rng(1).integers(
            0, 256, (37, 53, 3), np.uint8), fm.zstd_coder(1, True)),
            "equal"),
        "bad_checksum_at_end": (strip(lambda d: code(d)[:-1] + bytes(
            [code(d)[-1] ^ 1])), "raise"),
        "bad_checksum_past_rows": (strip(lambda d: (lambda f: f[:-1] + bytes(
            [f[-1] ^ 1]))(code(d + bytes(rows)))), "equal"),
        # a raw block that claims more than the frame's content size has
        # room for, cut short: libzstd copies what the input holds
        "raw_block_cut": (strip(lambda d: _raw_frame(d, rows + 1000, (
            (0, rows - 100, d[:rows - 100]), (0, 1200, d[rows - 100:]
                                             + bytes(100))))), "equal"),
        "raw_block_past_size": (strip(lambda d: _raw_frame(d, rows + 1000, (
            (0, rows - 100, d[:rows - 100]), (0, 1200, d[-100:] * 12)))),
            "raise"),
    }
    for name, (data, want) in cases.items():
        assert held_to_pil(data) == want, name


def _literals(tif: bytes) -> tuple:
    """(start, end) in a one-strip ZSTD TIFF of its first block's
    compressed literals (the Huffman tree, then the jump table and the
    four streams), and whether the block's literals come in four."""
    at = 8                                       # the strip's frame
    d = tif[at:]
    head = 5 + (not d[4] >> 5 & 1) + ((1 << (d[4] >> 6)) if d[4] >> 6
                                       else d[4] >> 5 & 1)
    b0 = head + 3
    assert int.from_bytes(d[head:head + 3], "little") >> 1 & 3 == 2
    assert d[b0] & 3 == 2                        # Huffman literals
    fmt = d[b0] >> 2 & 3
    hc = int.from_bytes(d[b0:b0 + 4], "little")
    lh, csize = {0: (3, hc >> 14 & 0x3FF), 1: (3, hc >> 14 & 0x3FF),
                 2: (4, hc >> 18),
                 3: (5, (hc >> 22) + (d[b0 + 4] << 10))}[fmt]
    return at + b0 + lh, at + b0 + lh + csize, fmt > 0


def test_zstd_huffman_literals():
    """One to three bytes of the Huffman literals of a large block (four
    streams of 16 KB, which libzstd decodes with its double-symbol table
    and its fast loop: a stream read on past its start, only a window
    more than 8 bytes below it failing) and of small blocks (the
    single-symbol table): the port's outcome is PIL's on each."""
    rng = np.random.default_rng(19300)
    big = rng.integers(0, 16, (200, 300, 3)).astype(np.uint8) * 3
    small = rng.integers(0, 12, (37, 53, 3)).astype(np.uint8) * 5
    files = [_zstd_tiff(big, fm.zstd_coder(3), rows_per_strip=200),
             _zstd_tiff(small, fm.zstd_coder(3), rows_per_strip=37)]
    seen = []
    for tif in files:
        lo, hi, four = _literals(tif)
        assert four
        for _ in range(60):
            data = bytearray(tif)
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(lo, hi))
                data[i] = (int(rng.integers(0, 256)) if rng.random() < 0.5
                           else data[i] ^ (1 << int(rng.integers(0, 8))))
            seen.append(held_to_pil(bytes(data)))
    assert seen.count("equal") >= 40


# ---------------------------------------------------------------------------
# LAB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quarter", range(4))
def test_lab_all_inputs(quarter):
    """A quarter of all 2^24 8-bit LAB triples (Pillow's storage: a* and
    b* offset by 128), as one 2048x2048 image: `lab.to_rgb` is byte-equal
    to Pillow's convert("RGB") through LittleCMS on every one."""
    a = np.arange(quarter << 22, (quarter + 1) << 22, dtype=np.uint32)
    stored = np.stack([a >> 16, a >> 8 & 255, a & 255], -1).astype(np.uint8)
    # PIL's "LAB" raw mode flips the sign bit of a* and b* as it reads
    raw = stored ^ np.array([0, 128, 128], np.uint8)
    img = Image.frombytes("LAB", (2048, 2048), raw.tobytes())
    assert img.getpixel((1, 0)) == tuple(stored[1])
    want = np.asarray(img.convert("RGB")).reshape(-1, 3)
    del img, raw
    got = lab.to_rgb(stored)
    assert (got != want).sum() == 0


def test_lab_table_nodes():
    """The 33^3 CLUT: the nodes of L* 100 and 0 nearest a* = b* = 0 are
    near white and black; lcms2's word saturation clamps and rounds."""
    t = lab.table()
    assert t.shape == (33, 33, 33, 3)
    assert (t[32, 16, 16] >= 65000).all() and (t[0, 16, 16] <= 400).all()
    assert lab.saturate_word(np.array([-1.0, 0.4999, 65534.6, 1e9])).tolist(
    ) == [0, 0, 65535, 65535]


def test_lab_tiff_every_compression():
    """LAB TIFF as PIL writes it under raw, LZW, PackBits, Adobe Deflate,
    JPEG, LZMA and ZSTD, and by hand in tiles, big-endian, with a
    predictor: equal to PIL. ICCLab (9) and ITULab (10), which PIL does
    not open, raise in both."""
    px = _odd(18500)
    img = Image.frombytes("LAB", px.shape[1::-1], px.tobytes())
    for comp in ("raw", "tiff_lzw", "packbits", "tiff_adobe_deflate",
                 "jpeg", "lzma", "zstd"):
        buf = io.BytesIO()
        img.save(buf, "TIFF", compression=comp)
        assert Image.open(io.BytesIO(buf.getvalue())).mode == "LAB"
        assert held_to_pil(buf.getvalue()) == "equal", comp
    samples = px.astype(np.int64)          # TIFF's signed a* and b*
    for kw in ({"tile": (16, 16), "compression": 8},
               {"order": "MM", "compression": 5, "predictor": 2},
               {"order": "MM", "tile": (32, 16), "compression": 50000,
                "compress": fm.zstd_coder(5, True)},
               {"rows_per_strip": 5}):
        assert held_to_pil(tiff_bytes(samples, 8, 8, **kw)) == "equal", kw
    for photo in (9, 10):
        assert held_to_pil(tiff_bytes(samples, 8, photo)) == "raise"


def test_lab_psd():
    """LAB PSD raw and RLE, with layers, resources, odd sizes and more
    channels than three: equal to PIL."""
    rng = np.random.default_rng(18600)
    for h, w, c in ((37, 53, 3), (1, 1, 3), (5, 200, 4), (64, 3, 3)):
        ch = rng.integers(0, 256, (c, h, w))
        for rle in (False, True):
            for layers in (False, True):
                assert held_to_pil(fm.psd_bytes(
                    ch, 9, rle=rle, layers=layers)) == "equal"


# ---------------------------------------------------------------------------
# the nine plugins
# ---------------------------------------------------------------------------

def test_sun_raster_sweep():
    """Every depth PIL opens, raw (rows padded to 16 bits) and run-length
    coded (runs across rows, 0x80 literals), RGB and BGR order, colour
    maps of fewer and more than 256 colours and on depths that ignore or
    refuse them, odd widths: equal to PIL, or raising where it raises."""
    rng = np.random.default_rng(18700)
    seen = []
    for w, h in ((53, 37), (1, 1), (3, 5), (17, 2)):
        px = _odd(18701 + w, h, w)
        grey = px[..., 0]
        for ftype in (0, 1, 2, 3, 4, 5):
            for depth, values in ((1, grey > 100), (4, grey >> 4),
                                  (8, grey), (24, px), (32, px)):
                seen.append(held_to_pil(fm.sun_bytes(values, depth, ftype)))
                if depth in (4, 8) or (depth == 24 and ftype == 1):
                    pal = rng.integers(0, 256, (int(rng.integers(1, 300)),
                                                3))
                    seen.append(held_to_pil(fm.sun_bytes(values, depth, ftype,
                                                         pal)))
    runs = fm.sun_bytes(np.array([[0x80, 0x80, 7, 7, 7, 0x80]] * 3,
                                 np.uint8), 8, 2)
    seen.append(held_to_pil(runs))
    bad = bytearray(fm.sun_bytes(_odd(1)[..., 0], 8, 1))
    for at, v in ((12, 16), (20, 7), (24, 2), (28, 2000)):
        b = bytearray(bad)
        struct.pack_into(">I", b, at, v)
        seen.append(held_to_pil(bytes(b)))
    assert seen.count("equal") >= 150 and "refused" not in seen


def test_xpm_sweep():
    """PIL's header line among comments, one- and two-character keys,
    "None" used or not, symbolic names, a key given twice, more than 256
    colours (an RGB image), a colour line PIL cannot read, short pixel
    data, a "/* pixels */" line: equal to PIL or raising where it
    raises."""
    rng = np.random.default_rng(18800)
    seen = []
    for n, bpp in ((2, 1), (16, 1), (80, 1), (257, 2), (300, 2), (5, 3)):
        idx = rng.integers(0, n, (9, 13))
        cols = [tuple(int(v) for v in c) for c in rng.integers(0, 256,
                                                               (n, 3))]
        for none in (None, n - 1):
            if none is not None:
                idx[idx == none] = 0
            for sym in (False, True):
                seen.append(held_to_pil(fm.xpm_bytes(idx, cols, bpp, none,
                                                     sym)))
        data = fm.xpm_bytes(idx, cols, bpp, 0)        # "None" used
        seen.append(held_to_pil(data))
        seen.append(held_to_pil(data.replace(b"/* pixels */\n", b"")))
        seen.append(held_to_pil(data.replace(b" c #", b" c ", 1)))
        seen.append(held_to_pil(data.replace(b" c #", b" m #", 1)))
        lines = data.split(b"\n")
        seen.append(held_to_pil(b"\n".join(lines[:-4] + lines[-2:])))
        # the first colour line twice, counted: its key keeps its place
        twice = lines[:4] + [lines[4]] + lines[4:]
        twice[3] = f'"13 9 {n + 1} {bpp} ",'.encode()
        seen.append(held_to_pil(b"\n".join(twice)))
    assert seen.count("equal") >= 20 and seen.count("raise") >= 10
    assert "refused" not in seen


def test_dcx_ftex_gbr_sweep():
    """DCX of PCX pages of each kind PIL writes, a page table that runs
    on, no pages; FTEX of DXT1 (with 1-bit alpha) and raw RGB at odd
    sizes, negative and short mip-map sizes, another format count; GIMP
    brushes of both versions, grey and RGBA, short headers and comments
    that eat the pixels: equal to PIL or raising where it raises."""
    rng = np.random.default_rng(18900)
    seen = []
    for w, h in ((53, 37), (1, 1), (5, 3), (64, 8)):
        px = _odd(18901 + w, h, w)
        rgba = np.dstack([px, (rng.integers(0, 2, (h, w)) * 255).astype(
            np.uint8)])
        for mode in ("RGB", "L", "P", "1"):
            page = fm.pcx_bytes(px, mode)
            seen.append(held_to_pil(fm.dcx_bytes([page, fm.pcx_bytes(px)])))
        for blocks in (fm.dxt1_blocks(px), fm.dxt1_blocks(rgba)):
            seen.append(held_to_pil(fm.ftex_bytes(w, h, 0, blocks)))
            seen.append(held_to_pil(fm.ftex_bytes(w, h, 0, blocks[:-8])))
        seen.append(held_to_pil(fm.ftex_bytes(w, h, 1, px.tobytes())))
        for version in (1, 2):
            seen.append(held_to_pil(fm.gbr_bytes(px[..., 0], version)))
            seen.append(held_to_pil(fm.gbr_bytes(rgba, version, b"")))
    for data in (struct.pack("<II", 987654321, 0) + bytes(300),
                 struct.pack("<I", 987654321) + b"\x01\x00",
                 fm.ftex_bytes(4, 4, 2, bytes(8)),
                 fm.ftex_bytes(4, 4, 1, bytes(48))[:24],
                 fm.ftex_bytes(4, 4, 1, bytes(48)).replace(
                     struct.pack("<i", 48), struct.pack("<i", -1)),
                 b"FTEX" + struct.pack("<7i", 1, 4, 4, 1, 2, 1, 32),
                 struct.pack(">5I", 24, 2, 2, 2, 1) + b"GIMP" + bytes(9),
                 struct.pack(">5I", 20, 1, 0, 2, 1) + bytes(4),
                 struct.pack(">5I", 20, 1, 2, 2, 3) + bytes(12)):
        seen.append(held_to_pil(data))
    assert seen.count("equal") >= 40 and seen.count("raise") >= 5
    assert "refused" not in seen


def test_pixar_imt_mcidas_xv_sweep():
    """PIXAR of the one layout PIL opens and others it passes on; IMT with
    comments, other keys and no data; McIdas areas of 1, 2 and 4 bytes
    with line prefixes, bands and offsets, strides too short and
    negative offsets; XV thumbnails with and without comments: equal to
    PIL or raising where it raises."""
    seen = []
    for w, h in ((53, 37), (1, 1), (7, 2)):
        px = _odd(19001 + w, h, w)
        grey = px[..., 0].astype(np.int64)
        seen.append(held_to_pil(fm.pixar_bytes(px)))
        seen.append(held_to_pil(fm.imt_bytes(px[..., 0])))
        seen.append(held_to_pil(fm.imt_bytes(px[..., 0], comment=False)))
        for size, vals in ((1, grey), (2, grey * 300 - 900),
                           (4, grey * 70000 - 5000000)):
            for prefix, bands, at in ((0, 1, 256), (3, 2, 300), (0, 0, 256)):
                seen.append(held_to_pil(fm.mcidas_bytes(vals, size, prefix,
                                                        bands, at)))
        seen.append(held_to_pil(fm.xvthumb_bytes(px)))
    odd = _odd(19000)
    pix = bytearray(fm.pixar_bytes(odd))
    struct.pack_into("<2H", pix, 424, 14, 3)
    seen.append(held_to_pil(bytes(pix)))
    for head in (b"width 4\nheight 2\npixel n8\n",
                 b"width 4\nheight 2\npixel n16\n\x0c" + bytes(8),
                 b"width -4\nheight 2\npixel n8\n\x0c" + bytes(8),
                 b"width x4\nheight 2\npixel n8\n\x0c" + bytes(8),
                 b"*comment\nwidth 4\nheight 2\npixel n8\nother v\n\x0c"
                 + bytes(range(8)),
                 b"P7 332\n#only comments\n",
                 b"P7 332\n\n4 2 255\n" + bytes(8),
                 b"P7 332\n4\n" + bytes(8)):
        seen.append(held_to_pil(head))
    mc = bytearray(fm.mcidas_bytes(odd[..., 0], 1))
    struct.pack_into(">i", mc, 4 * 14, 5)           # prefix 5, bands 1
    struct.pack_into(">i", mc, 4 * 13, 0)           # bands 0: stride 5
    seen.append(held_to_pil(bytes(mc)))
    struct.pack_into(">i", mc, 4 * 33, -400)
    seen.append(held_to_pil(bytes(mc)))
    assert seen.count("equal") >= 30 and seen.count("raise") >= 5
    assert "refused" not in seen


# ---------------------------------------------------------------------------
# PIL's plugin order (fault 9), MPEG and the bomb limit
# ---------------------------------------------------------------------------

def _iptc(compression: int = 1) -> bytes:
    """An IPTC/NAA file PIL opens: an 8x4 grey image's fields, then the
    image data's field."""
    def field(rec, num, value):
        return bytes([0x1C, rec, num]) + struct.pack(">H", len(value)) + \
            value
    return (field(3, 60, b"\x01\x00") + field(3, 20, b"\x00\x08")
            + field(3, 30, b"\x00\x04")
            + field(3, 120, bytes([compression])) + field(8, 10, bytes(32)))


def test_plugin_order_fault_nine():
    """PIL tries IMT and IPTC right after IM: a file with a newline in its
    first 100 bytes and an IMT header opens as IMT (the port named it an
    unknown format until fault 9 was closed); an IPTC file is named and
    decodes equal to PIL (refused by name until IPTC was ported); MPEG,
    which PIL opens and cannot load, raises ValueError; a
    header either plugin passes on goes to the next."""
    imt = b"width 64\nheight 32\npixel n8\n\x0c" + bytes(range(256)) * 8
    assert Image.open(io.BytesIO(imt)).format == "IMT"
    assert ttex.image_format(imt) == "IMT"
    assert held_to_pil(imt) == "equal"
    iptc = _iptc()
    assert Image.open(io.BytesIO(iptc)).format == "IPTC"
    assert ttex.image_format(iptc) == "IPTC"
    assert held_to_pil(iptc) == "equal"
    assert isinstance(pil_outcome(_iptc(7)), str)
    with pytest.raises(ValueError, match="IPTC"):
        ttex.decode_image(_iptc(7))
    mpeg = b"\x00\x00\x01\xb3\x14\x00\xf0" + bytes(40)
    assert Image.open(io.BytesIO(mpeg)).format == "MPEG"
    assert ttex.image_format(mpeg) == "MPEG"
    assert isinstance(pil_outcome(mpeg), str)
    with pytest.raises(ValueError, match="MPEG"):
        ttex.decode_image(mpeg)
    for data in (b"\x00\x00\x01\xb3\x00\x00\x00" + bytes(9),
                 b"hello\nworld" + bytes(200),
                 b"width 4\nheight 2\n\x0c" + bytes(8),
                 b"\x1c\x03\x3c\x00\x02\x01\x00" + bytes(20)):
        assert held_to_pil(data) == "raise"


def _bombs() -> dict:
    s = fm.BOMB_SIDE
    mc = [0] * 65
    mc[2], mc[9], mc[10], mc[11], mc[14], mc[34] = 4, s, s, 1, 1, 256
    pixar = bytearray(1024)
    pixar[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<4H", pixar, 416, s, s, 0, 0)
    struct.pack_into("<2H", pixar, 424, 14, 2)
    pcx = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, s - 1, s - 1, 72,
                      72) + bytes(48) + struct.pack("<BBHH", 0, 1, s, 1)
    return {
        "SUN": struct.pack(">8I", 0x59A66A95, s, s, 8, 0, 1, 0, 0),
        "XPM": f'/* XPM */\n"{s} {s} 1 1",\n"a c #000000",\n"a"\n'.encode(),
        "DCX": fm.dcx_bytes([pcx.ljust(128, b"\0") + bytes(16)]),
        "FTEX": fm.ftex_bytes(s, s, 1, bytes(16)),
        "GBR": fm.gbr_bytes(np.zeros((1, 1), np.uint8)).replace(
            struct.pack(">II", 1, 1), struct.pack(">II", s, s), 1),
        "PIXAR": bytes(pixar),
        "IMT": f"width {s}\nheight {s}\npixel n8\n\x0c".encode() + bytes(8),
        "MCIDAS": struct.pack(">64i", *mc[1:]) + bytes(8),
        "XVThumb": f"P7 332\n{s} {s} 255\n".encode() + bytes(8),
    }


@pytest.mark.parametrize("fmt", sorted(_bombs()))
def test_header_past_the_limit(fmt):
    """A header-only file of each new decoder, past PIL's decompression
    bomb limit: PIL raises DecompressionBombError, the port ValueError
    naming the limit."""
    data = _bombs()[fmt]
    assert ttex.image_format(data) == fmt
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError, match="decompression bomb limit"):
        ttex.decode_image(data)


# ---------------------------------------------------------------------------
# cut and mutated streams
# ---------------------------------------------------------------------------

CUT = [f"{FOLDER}/{n}" for n in (
    "odd_zstd_grey16_size.tif", "odd_zstd_mm_float_pred3.tif",
    "odd_lab_lzw_mm.tif", "odd_lab_raw.psd", "odd_bgr32_rle.ras",
    "odd_grey8_pal_rle.ras", "odd_many_2chars.xpm", "odd_pages.dcx",
    "odd_rgb.ftex", "odd_v2_rgba.gbr", "odd.pixar", "odd.imt",
    "odd_16bit.mcidas", "odd.xvthumb")]


@pytest.mark.parametrize("path", CUT)
def test_cut_streams(path):
    """A file of each new format cut by 1 to 40 bytes: the port's outcome
    is PIL's on each."""
    data = _read(path)
    for k in range(1, 41):
        cut = data[:-k]
        assert _allowed(held_to_pil(cut), cut)


def _zstd_fuzz_files() -> list:
    px = _odd(19100)
    return [_zstd_tiff(px, fm.zstd_coder(19, True)),
            _zstd_tiff(px, fm.zstd_coder(-3, False, True), tile=(16, 16),
                       predictor=2),
            _zstd_tiff(np.random.default_rng(2).integers(
                0, 256, (37, 53, 3), np.uint8), fm.zstd_coder(1, True)),
            _read(f"{FOLDER}/odd_zstd_grey16_size.tif")]


def _zstd_block_files() -> list:
    """Strips of several blocks: frames whose later blocks hold bytes past
    the rows, four-stream Huffman literals of 8 bytes and more a stream
    (libzstd's fast loop), raw blocks."""
    rng = np.random.default_rng(19101)
    px = _odd(19102, 200, 300)
    noise = rng.integers(0, 256, (200, 300, 3), np.uint8)
    tail = rng.integers(0, 256, 150000, np.uint8).tobytes()
    return [_zstd_tiff(px, fm.zstd_coder(3, True), rows_per_strip=200),
            _zstd_tiff(px, lambda d: fm.zstd_coder(1, True)(d + tail),
                       rows_per_strip=200),
            _zstd_tiff(noise, fm.zstd_coder(-5), rows_per_strip=200),
            _zstd_tiff(px, fm.zstd_coder(19, True, True),
                       rows_per_strip=200)]


FUZZ = {
    "zstd_tiff": _zstd_fuzz_files,
    "zstd_tiff_blocks": _zstd_block_files,
    "lab": ["odd_lab_lzw_mm.tif", "odd_lab_packbits_tiles.tif",
            "odd_lab_raw.psd", "logo_lab_rle.psd"],
    "sun": ["odd_bgr32_rle.ras", "odd_grey8_pal_rle.ras", "odd_grey4.ras",
            "odd_bilevel.ras", "odd_rgb32_rgb_order.ras"],
    "xpm": ["odd_many_2chars.xpm"],
    "dcx": ["odd_pages.dcx"],
    "ftex": ["odd_rgb.ftex"],
    "gbr": ["odd_v1_grey.gbr", "odd_v2_rgba.gbr"],
    "pixar": ["odd.pixar"],
    "imt": ["odd.imt"],
    "mcidas": ["odd_8bit.mcidas", "odd_16bit.mcidas", "odd_32bit.mcidas"],
    "xvthumb": ["odd.xvthumb"],
}


@pytest.mark.parametrize("kind", sorted(FUZZ))
def test_mutation_fuzz(kind):
    """200 mutations of each kind's files, of 1-3 bytes (a random value,
    or one bit flipped), half of them in the first 300 bytes (the
    headers, and a ZSTD TIFF's frames are mutated anywhere; strips of
    several blocks reach libzstd's fast Huffman loop, which reads a
    stream's bits on into the stream before it and does not check where
    it stopped): the port is
    byte-equal wherever PIL decodes, raises wherever PIL raises, and
    names only the features of REFUSALS."""
    files = FUZZ[kind]() if callable(FUZZ[kind]) else [
        _read(f"{FOLDER}/{n}") for n in FUZZ[kind]]
    rng = np.random.default_rng(19200 + sorted(FUZZ).index(kind))
    seen = []
    for _ in range(200):
        data = bytearray(files[int(rng.integers(0, len(files)))])
        for _ in range(int(rng.integers(1, 4))):
            hi = len(data) if rng.random() < 0.5 else min(len(data), 300)
            i = int(rng.integers(0, hi))
            data[i] = (int(rng.integers(0, 256)) if rng.random() < 0.7
                       else data[i] ^ (1 << int(rng.integers(0, 8))))
        outcome = held_to_pil(bytes(data))
        assert _allowed(outcome, bytes(data))
        seen.append(outcome)
    assert seen.count("equal") >= 20


def test_port_uses_no_reference_library():
    """No module of the port, and not chip_smoke.py, imports zstandard or
    PIL, or opens one of Pillow's bundled libraries (pillow.libs): the
    card's machine has neither, and the port's decoders are its own."""
    import ast

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = os.path.join(root, "rlshaders_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(port) for f in fs
             if f.endswith((".py", ".cpp", ".h", ".cu"))]
    files.append(os.path.join(root, "chip_smoke.py"))
    assert any(f.endswith("zstd.cpp") for f in files)
    for path in files:
        with open(path) as f:
            text = f.read()
        assert "pillow.libs" not in text, path
        if not path.endswith(".py"):
            continue
        for node in ast.walk(ast.parse(text)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in ("zstandard", "PIL"), (
                    path, name)
