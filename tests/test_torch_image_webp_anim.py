"""Animated WebP in the port (scene/webp.py's demuxer over vp8.py and
vp8l.py) against PIL 12.1's libwebp 1.6, whose animation decoder PIL
opens every WebP with: byte-equal to `convert("RGB")`, no tolerance.

libwebp's demuxer checks every ANMF chunk of the file (its sub-chunks,
its frame's bitstream header, its place on the canvas) before the first
frame is drawn; the first frame is a key frame, drawn with no blending
into its rectangle at twice the ANMF offset of a zero (transparent
black) canvas of VP8X's size, whose RGB `convert("RGB")` keeps. The
files are written by PIL (seeded frames, lossy, lossless and mixed, RGB
and RGBA) or built here around PIL's still chunks with
tools/make_image_formats.py's `anmf` and `animated_webp`: frames at
offsets inside larger canvases, an ALPH chunk without the alpha flag,
frames past the canvas, broken later frames, ANMF before ANIM, chunks
left in an ANMF. The committed files of scenes/data/formats_d, and cut
and mutated streams of every file here, are held to PIL as in
tests/test_torch_image_jpeg2000.py.
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

from test_torch_image_jpeg2000 import FILES, held_to_pil
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from rlshaders_tpu_torch.scene import texture as ttex

ANIMATED = [f for f in FILES if f.endswith(".webp")]


def _frame(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """A seeded frame: gradients, noise, and an alpha of holes for c = 4."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([(x * 9 + seed * 30) % 256, (y * 7) % 256, (x * y) % 256,
                   np.where((x + y) % 5 == 0, 0, 200 + seed)][:c], -1)
    return np.clip(px + rng.integers(0, 30, px.shape), 0, 255).astype(
        np.uint8)


def _anim(frames: list, **kw) -> bytes:
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   **kw)
    return buf.getvalue()


def _still(px: np.ndarray, mode: str, keep: tuple, **kw) -> list:
    """The chunks of kinds `keep` of PIL's still WebP of px."""
    buf = io.BytesIO()
    Image.fromarray(px, mode).save(buf, "WEBP", **kw)
    return [c for c in fm.webp_chunks(buf.getvalue()) if c[0] in keep]


@pytest.mark.parametrize("path", ANIMATED, ids=os.path.basename)
def test_committed_file(tmp_path, path):
    """The committed animations: a lossy one with ALPH whose first frame
    sits at (20, 14) of a 190x130 canvas, and PIL's lossless one."""
    with open(path, "rb") as f:
        data = f.read()
    assert Image.open(io.BytesIO(data)).n_frames > 1
    same_as_reference(tmp_path, data, os.path.basename(path))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("kw", [{"quality": 70}, {"lossless": True},
                                {"allow_mixed": True, "quality": 50},
                                {"minimize_size": True, "quality": 30}],
                         ids=["lossy", "lossless", "mixed", "minimized"])
def test_pil_animations(mode, kw):
    """Three seeded frames (seeds 0-2) of 37x45 as PIL writes them."""
    frames = [Image.fromarray(_frame(37, 45, len(mode), s), mode)
              for s in range(3)]
    assert held_to_pil(_anim(frames, **kw)) == "equal"


def _built() -> dict:
    """Animations built around PIL's still chunks (seeds 7 and 8)."""
    lossy = _still(_frame(21, 17, 4, 7), "RGBA", (b"ALPH", b"VP8 "),
                   quality=60)
    lossless = _still(_frame(13, 9, 4, 8), "RGBA", (b"VP8L",),
                      lossless=True)
    anim = fm.animated_webp
    broken = [(b"VP8L", b"\x2f\x00\x00\x00")]
    return {
        "offset lossy with alpha": anim(60, 40, 0x10, [
            fm.anmf(10, 6, 17, 21, lossy), fm.anmf(0, 0, 9, 13, lossless)]),
        "alpha without its flag": anim(60, 40, 0, [
            fm.anmf(10, 6, 17, 21, lossy)]),
        "offset lossless": anim(30, 30, 0x10, [fm.anmf(4, 2, 9, 13,
                                                       lossless)]),
        "odd offset": anim(30, 30, 0x10, [fm.anmf(5, 3, 9, 13, lossless)]),
        "ANMF size not the bitstream's": anim(30, 30, 0x10, [
            fm.anmf(4, 2, 20, 20, lossless)]),
        "unknown chunk in an ANMF": anim(60, 40, 0x10, [fm.anmf(
            10, 6, 17, 21, lossy + [(b"XYZW", b"abcd")])]),
        "dispose and no blend bits": anim(30, 30, 0x10, [
            fm.anmf(4, 2, 9, 13, lossless, bits=3),
            fm.anmf(0, 0, 9, 13, lossless, bits=1)]),
        # refused by libwebp's demuxer, however many frames are drawn
        "later frame past the canvas": anim(30, 30, 0x10, [
            fm.anmf(4, 2, 9, 13, lossless), fm.anmf(24, 0, 9, 13,
                                                    lossless)]),
        "broken later frame": anim(30, 30, 0x10, [
            fm.anmf(4, 2, 9, 13, lossless), fm.anmf(0, 0, 9, 13, broken)]),
        "broken alpha without its flag": anim(60, 40, 0, [fm.anmf(
            10, 6, 17, 21, [(b"ALPH", b"\x01\x00\x00"), lossy[1]])]),
        "ANMF without the animation flag": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(30, 30, 0x10)),
            (b"ANIM", b"\x00" * 6), (b"ANMF", fm.anmf(4, 2, 9, 13,
                                                      lossless))]),
        "ANMF before ANIM": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(30, 30, 0x12)),
            (b"ANMF", fm.anmf(4, 2, 9, 13, lossless)),
            (b"ANIM", b"\x00" * 6)]),
        "no frames": fm.riff_webp([(b"VP8X", fm.vp8x_chunk(30, 30, 0x12)),
                                   (b"ANIM", b"\x00" * 6)]),
        "still image in an animation": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(17, 21, 0x12)),
            (b"ANIM", b"\x00" * 6)] + lossy),
        "short ANIM": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(30, 30, 0x12)), (b"ANIM", b"\x00" * 4),
            (b"ANMF", fm.anmf(4, 2, 9, 13, lossless))]),
        "VP8L after ALPH in a frame": anim(30, 30, 0x10, [fm.anmf(
            4, 2, 9, 13, [lossy[0]] + lossless)]),
        # ANIM in a still file: after the image it is read and the image
        # decodes; before it, the image is refused
        "ANIM after a still image": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(9, 13, 0x10))] + lossless + [
            (b"ANIM", b"\x00" * 6)]),
        "ANIM before a still image": fm.riff_webp([
            (b"VP8X", fm.vp8x_chunk(9, 13, 0x10)),
            (b"ANIM", b"\x00" * 6)] + lossless),
    }


BUILT = sorted(_built())
REFUSED = {"later frame past the canvas", "broken later frame",
           "broken alpha without its flag", "ANMF without the animation flag",
           "ANMF before ANIM", "no frames", "still image in an animation",
           "short ANIM", "VP8L after ALPH in a frame",
           "ANIM before a still image"}


@pytest.mark.parametrize("name", BUILT)
def test_built_animations(name):
    assert held_to_pil(_built()[name]) == (
        "raise" if name in REFUSED else "equal")


def _fuzz_files() -> list:
    out = []
    for path in ANIMATED:
        with open(path, "rb") as f:
            out.append(f.read())
    built = _built()
    return out + [built[n] for n in BUILT if n not in REFUSED]


def test_cut_streams():
    """Every file that decodes here cut by 1 to 40 bytes: libwebp's
    demuxer refuses each, and so does the port."""
    for data in _fuzz_files():
        assert {held_to_pil(data[:-k]) for k in range(1, 41)} == {"raise"}


@pytest.mark.parametrize("seed", range(4))
def test_mutation_fuzz(seed):
    """100 mutations a seed (400 in all) of the files that decode, each of
    1-3 bytes (a random value, or one bit flipped), held to PIL."""
    files = _fuzz_files()
    rng = np.random.default_rng(2000 + seed)
    seen = []
    for _ in range(100):
        data = bytearray(files[int(rng.integers(0, len(files)))])
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(data)))
            data[i] = (int(rng.integers(0, 256)) if rng.random() < 0.7
                       else data[i] ^ (1 << int(rng.integers(0, 8))))
        seen.append(held_to_pil(bytes(data)))
    assert seen.count("equal") >= 20


def test_frames_after_the_first_are_not_drawn():
    """A second frame covering the canvas changes nothing: PIL's RGB is
    the first frame's over the zero canvas (seed 9)."""
    a = _frame(20, 24, 3, 9)
    first = _still(a, "RGB", (b"VP8L",), lossless=True)
    cover = _still(np.full((20, 24, 3), 77, np.uint8), "RGB", (b"VP8L",),
                   lossless=True)
    data = fm.animated_webp(30, 26, 0, [fm.anmf(4, 2, 24, 20, first),
                                        fm.anmf(0, 0, 24, 20, cover)])
    want = np.zeros((26, 30, 3), np.uint8)
    want[2:22, 4:28] = a
    assert np.array_equal(ttex.decode_image(data), want)
    assert held_to_pil(data) == "equal"
