"""The port's JPEG decoder (scene/jpeg.py) against PIL, and a JPEG-textured
frame against the JAX package, which decodes with PIL.

`decode_jpeg` is held byte for byte to `np.asarray(Image.open(p).convert(
"RGB"))` (PIL 12.1.0 over libjpeg-turbo, `features.version("jpg")` 6.2) on
files PIL writes here: qualities 50, 75 and 95; 4:4:4, 4:2:2 and 4:2:0;
4:4:0 (PIL cannot write it: a 4:2:2 file whose frame header is rewritten
to 1x2 luma sampling, so its scan decodes as a valid 4:4:0 image of
another size); grey; optimised Huffman tables; restart markers every 3
MCUs; 16-bit quantisation tables (an extended sequential SOF1 frame); and
sizes 37x23, 1x1, 17x300 and 256x256. Measured: equal on every file, no
difference to state. The committed scenes/data/grid.jpg and logo.jpg
(tools/make_jpeg_textures.py) decode to the SHA-256 digests pinned in
tests/test_torch_gpu.py (which runs on the card without jax), as PIL's
decode does; chip_smoke.py holds the card's decode to the same digests.
The modes that still raise (arithmetic-coded, lossless, hierarchical and
12-bit files, made by rewriting a PIL file's frame header) raise
NotImplementedError naming the mode; the progressive, CMYK, YCCK and
RGB-coded files that decode are in tests/test_torch_image_jpeg.py.

The frame: tests/test_torch_textured_render.py's reduced copy of
scenes/textured_disk.ass (16x16, AA 1, one diffuse and one glossy sample)
with its images named .jpg, every plane of the port's CPU frame within
that file's PIX_ATOL of the JAX frame. Measured: within 2.5e-7, but the
four pixels around (7, 13), where the JAX package's jitted frame rounds
one glossy lane the other way, as with the PNGs; there the port is held
to the JAX package's op-by-op values of the JPEG frame (OPBYOP, printed
by `tools/textured_opbyop.py --jpeg`) within OPBYOP_ATOL (measured
2.3e-8). The same frame with the progressive copies of the JPEGs
(scenes/data/modes) equals it bit for bit.
"""
import hashlib
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from test_torch_gpu import JPEG_DIGESTS as DIGESTS
from test_torch_textured_render import PLANES, REDUCED, textured_copy
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene import texture as ttex
from rlshaders_tpu_torch.scene.jpeg import decode_jpeg

cpu_math.settle()

SIZES = [(37, 23), (1, 1), (17, 300), (256, 256)]  # (width, height)
RES = 16
KW = dict(seed=0, aa_samples=1, xres=RES, yres=RES)
PIX_ATOL = 1e-5
OPBYOP_ATOL = 1e-6


def _image(w: int, h: int, seed: int = 0) -> np.ndarray:
    """Gradients with noise: every coefficient band busy."""
    rs = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                   (x + y) * 127.0 / max(w + h - 2, 1)], -1)
    px += rs.normal(0, 30, px.shape)
    return np.clip(px, 0, 255).astype(np.uint8)


def _jpeg(px: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _as_440(data: bytes) -> bytes:
    """A 4:2:2 file (luma 2x1, MCU 16x8) with its frame header rewritten to
    luma 1x2 (MCU 8x16) over the same grid of MCUs: the scan is unchanged,
    and decodes as a 4:4:0 image 8 * MCU columns - 3 wide and 16 * MCU
    rows - 5 high."""
    sof = data.index(b"\xff\xc0")
    h = data[sof + 5] << 8 | data[sof + 6]
    w = data[sof + 7] << 8 | data[sof + 8]
    assert data[sof + 11] == 0x21
    w2 = 8 * -(-w // 16) - 3
    h2 = 16 * -(-h // 8) - 5
    head = bytes([h2 >> 8, h2 & 255, w2 >> 8, w2 & 255])
    return (data[:sof + 5] + head + data[sof + 9:sof + 11] + b"\x12"
            + data[sof + 12:])


def _check(data: bytes) -> None:
    want = _pil(data)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", SIZES)
def test_sampling_and_size(size, sampling):
    _check(_jpeg(_image(*size), quality=75, subsampling=sampling))


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_quality(quality):
    _check(_jpeg(_image(37, 23, quality), quality=quality,
                 subsampling="4:2:0"))


@pytest.mark.parametrize("size", SIZES)
def test_440(size):
    data = _as_440(_jpeg(_image(*size), quality=75, subsampling="4:2:2"))
    assert _pil(data).shape[:2] == (16 * -(-size[1] // 8) - 5,
                                    8 * -(-size[0] // 16) - 3)
    _check(data)


@pytest.mark.parametrize("size", SIZES)
def test_grey(size):
    _check(_jpeg(_image(*size), mode="L", quality=75))


@pytest.mark.parametrize("size", [(37, 23), (256, 256)])
def test_optimized_tables_and_restarts(size):
    _check(_jpeg(_image(*size), quality=75, optimize=True))
    data = _jpeg(_image(*size), quality=75, restart_marker_blocks=3)
    assert b"\xff\xdd" in data
    _check(data)


def test_sixteen_bit_tables():
    qt = [list(range(200, 264))] * 2
    data = _jpeg(_image(37, 23), qtables=qt, subsampling="4:2:0")
    assert b"\xff\xc1" in data   # extended sequential
    _check(data)


@pytest.mark.parametrize("path", sorted(DIGESTS))
def test_committed_textures(path):
    with open(path, "rb") as f:
        data = f.read()
    want = _pil(data)
    assert hashlib.sha256(want.tobytes()).hexdigest() == DIGESTS[path]
    got = decode_jpeg(data)
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[path]
    img = ttex.load_image(path)
    assert img.dtype == np.float32
    assert np.array_equal(img, got.astype(np.float32) / 255.0)


def _frame_marker(data: bytes, sof: int = None, bits: int = None) -> bytes:
    """The file with its frame header's marker set to `sof` or its sample
    precision to `bits`: the header of a mode PIL's encoder does not write."""
    i = next(i for i in range(len(data) - 1) if data[i] == 0xFF
             and data[i + 1] in (0xC0, 0xC1, 0xC2))
    out = bytearray(data)
    if sof is not None:
        out[i + 1] = sof
    if bits is not None:
        out[i + 4] = bits
    return bytes(out)


# the modes that still raise (progressive and 4-component files, which
# these cases pinned before, now decode: tests/test_torch_image_jpeg.py):
# each made from a PIL file by rewriting its frame header
@pytest.mark.parametrize("mode,kw,rewrite,what", [
    pytest.param("RGB", {"progressive": True}, {"sof": 0xCA},
                 "arithmetic-coded progressive", id="RGB-kw0-progressive"),
    pytest.param("CMYK", {}, {"sof": 0xC3}, "lossless",
                 id="CMYK-kw1-4-component"),
    pytest.param("RGB", {}, {"sof": 0xC9}, "arithmetic-coded sequential",
                 id="arithmetic"),
    pytest.param("L", {}, {"sof": 0xC3}, "lossless", id="lossless"),
    pytest.param("RGB", {}, {"bits": 12}, "12-bit", id="12-bit"),
    pytest.param("RGB", {}, {"sof": 0xC5}, "hierarchical",
                 id="hierarchical"),
])
def test_unsupported_modes_raise(tmp_path, mode, kw, rewrite, what):
    path = tmp_path / "x.jpg"
    path.write_bytes(_frame_marker(_jpeg(_image(9, 7), mode=mode,
                                         quality=75, **kw), **rewrite))
    with pytest.raises(NotImplementedError, match=what):
        ttex.load_image(str(path))


# ---------------------------------------------------------------------------
# the JPEG-textured frame
# ---------------------------------------------------------------------------

# the JAX package's op-by-op values of the JPEG frame where its jitted
# frame differs (tools/textured_opbyop.py --jpeg)
OPBYOP = {
    "indirect_specular": {
        (6, 13): (0.0007212318014353514, 0.0008919805404730141,
                  0.0011644605547189713),
        (6, 14): (0.0028995999600738287, 0.003576115006580949,
                  0.004333207383751869),
        (7, 13): (0.0022528122644871473, 0.0027861567214131355,
                  0.003637265181168914),
        (7, 14): (0.003076389664784074, 0.0037973953876644373,
                  0.0047109113074839115),
    },
    "RGBA": {
        (6, 13): (0.009077328257262707, 0.010625209659337997,
                  0.016559801995754242),
        (6, 14): (0.08259551227092743, 0.09173955023288727,
                  0.12578345835208893),
        (7, 13): (0.04026424512267113, 0.041399888694286346,
                  0.05321028456091881),
        (7, 14): (0.06631892919540405, 0.0769149661064148,
                  0.11810167878866196),
    },
}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpeg_textured")
    (d / "data").symlink_to(os.path.abspath("scenes/data"))
    path = textured_copy(d / "t.ass", **REDUCED)
    with open(path) as f:
        src = f.read()
    assert src.count(".png") == 3
    with open(path, "w") as f:
        f.write(src.replace(".png", ".jpg"))
    js = jbuild.build(path)
    jout = jwave.render(js, jtrace.build(js.geometry), **KW)
    ts = tbuild.build(path, device="cpu")
    own = twave.render(ts, ttrace.build(ts.geometry), **KW)
    return jout, own, ts


@pytest.mark.parametrize("name", PLANES)
def test_jpeg_textured_frame_matches_jax(frames, name):
    jout, own, _ = frames
    a = own[name].numpy()
    b = np.array(jout[name])
    assert a.shape == b.shape == (RES, RES, 3)
    assert np.isfinite(a).all()
    for px, v in OPBYOP.get(name, {}).items():
        b[px] = v
    err = np.abs(a - b).max(-1)
    assert err.max() <= PIX_ATOL, (name, err.max())
    for px in OPBYOP.get(name, {}):
        assert err[px] <= OPBYOP_ATOL, (name, px, err[px])


def test_jpeg_textures_were_read(frames):
    """The stack holds the JPEGs' texels (level 0 of each), not the PNGs'."""
    _, _, scene = frames
    tex = scene.textures
    for i, path in enumerate(("scenes/data/grid.jpg",
                              "scenes/data/logo.jpg")):
        img = ttex.load_image(path)
        h, w = img.shape[:2]
        off = int(tex.offset[i, 0])
        assert tuple(tex.sizes[i, 0].tolist()) == (h, w)
        assert np.array_equal(tex.data[off:off + h * w].numpy(),
                              img.reshape(-1, 3))


def test_progressive_frame_equals_baseline_frame(tmp_path, frames):
    """The frame with the progressive copies of the JPEGs (the same
    quantised coefficients in another order, tools/make_image_modes.py)
    equals the baseline-JPEG frame bit for bit; the JAX package's
    textures of the two sets are equal too, so the frame is held to the
    JAX frame above."""
    from rlshaders_tpu.scene import texture as jtex

    _, baseline, _ = frames
    for name in ("grid", "logo"):
        assert np.array_equal(
            jtex.load_image(f"scenes/data/modes/{name}_progressive.jpg",
                            1.0),
            jtex.load_image(f"scenes/data/{name}.jpg", 1.0))
    (tmp_path / "data").symlink_to(os.path.abspath("scenes/data"))
    path = textured_copy(tmp_path / "t.ass", **REDUCED)
    with open(path) as f:
        src = f.read().replace("data/grid.png",
                               "data/modes/grid_progressive.jpg")
    with open(path, "w") as f:
        f.write(src.replace("data/logo.png",
                            "data/modes/logo_progressive.jpg"))
    ts = tbuild.build(path, device="cpu")
    own = twave.render(ts, ttrace.build(ts.geometry), **KW)
    for name in PLANES:
        assert torch.equal(own[name], baseline[name]), name
    assert own["__stats__"] == baseline["__stats__"]
