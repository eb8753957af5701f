"""The port's BC4, BC6H and BC7 decoders (scene/dds.py) against PIL 12.1's
BcnDecode.c, the decoder behind the JAX package's
`Image.open(path).convert("RGB")`: byte-equal on every block, no
tolerance; and every committed file of scenes/data/formats_b against PIL
and the JAX package's `load_image(path, 1.0)`.

The blocks are seeded random bytes (numpy default_rng, seeds stated in
each test), each test over one format or one mode so that a failure names
it: random 16-byte blocks cover every mode's bit fields, the reserved
modes (BC7's first byte 0, BC6H's four reserved 5-bit values) included.
The BC7 partition and anchor tables are recovered from PIL itself with
probe blocks (one per partition) and held to the port's typed tables.
tools/make_image_formats.py's block writers make the files of odd sizes
and the mipmapped file.
"""
import hashlib
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from test_torch_gpu import FORMAT_B_DIGESTS
from test_torch_image_modes import same_as_reference
from tools import make_image_formats as fm
from tools import make_image_modes as modes
from rlshaders_tpu_torch.scene import dds
from rlshaders_tpu_torch.scene import texture as ttex

BIG = "scenes/data/formats_b/texture_2048_bc7.dds"
FILES = sorted(FORMAT_B_DIGESTS)
BLOCK_BYTES = {80: 8, 95: 16, 96: 16, 98: 16}


def _dds(dxgi: int, blocks: np.ndarray, w: int = 0, h: int = 0) -> bytes:
    """A DDS of DXGI format `dxgi` holding `blocks` as one row of blocks
    (or a w x h image)."""
    blocks = np.asarray(blocks, np.uint8)
    return fm.dds_bytes(w or 4 * len(blocks), h or 4, blocks.tobytes(), 0x4,
                        b"DX10", dxgi=dxgi)


def _both(data: bytes) -> tuple:
    """(PIL's convert("RGB"), the port's decode) of a file's bytes."""
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return want, ttex.decode_image(data)


def _blocks_equal(dxgi: int, blocks: np.ndarray) -> None:
    """Every block decodes as PIL decodes it; a failure names the first
    block that differs and its first byte."""
    want, got = _both(_dds(dxgi, blocks))
    assert got.shape == want.shape
    bad = (want != got).reshape(4, len(blocks), 4, 3).any((0, 2, 3))
    if bad.any():
        i = int(np.argmax(bad))
        pytest.fail(f"block {i} (first byte {blocks[i, 0]:#04x}) of "
                    f"{int(bad.sum())} decodes otherwise than PIL")


# ---------------------------------------------------------------------------
# seeded random blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dxgi,seed", [(80, 1), (95, 2), (96, 3), (98, 4)],
                         ids=["bc4", "bc6h-uf16", "bc6h-sf16", "bc7"])
def test_fuzz_blocks(dxgi, seed):
    """4,096 random blocks (seeds 1-4), the reserved modes among them:
    BC7's first byte 0 in 64 blocks, each of BC6H's 32 five-bit mode
    values in 128."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (4096, BLOCK_BYTES[dxgi]), dtype=np.uint8)
    if dxgi == 98:
        blocks[:64, 0] = 0
    elif dxgi in (95, 96):
        blocks[:, 0] = (blocks[:, 0] & 0xE0) | (np.arange(4096) % 32)
    _blocks_equal(dxgi, blocks)


def test_bc7_reserved_mode_is_black():
    """A first byte of 0 is a reserved mode: PIL decodes opaque black
    (the D3D specification says transparent black; the RGB conversion
    drops the alpha either way)."""
    block = np.zeros((1, 16), np.uint8)
    block[0, 1:] = 0xA5
    rgba = np.asarray(Image.open(io.BytesIO(_dds(98, block))))
    assert (rgba == (0, 0, 0, 255)).all()
    assert (ttex.decode_image(_dds(98, block)) == 0).all()


def _mode_blocks(rng, n: int, first: int, low_bits: int) -> np.ndarray:
    """n random blocks whose first byte's low `low_bits` bits are
    `first`."""
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    keep = 0xFF ^ ((1 << low_bits) - 1)
    blocks[:, 0] = (blocks[:, 0] & keep) | first
    return blocks


@pytest.mark.parametrize("mode", range(8))
def test_bc7_mode(mode):
    """1,024 random blocks of one BC7 mode (seed 10 + mode): its partitions,
    p-bits, rotations and index selectors."""
    rng = np.random.default_rng(10 + mode)
    _blocks_equal(98, _mode_blocks(rng, 1024, 1 << mode, mode + 1))


# BcnDecode.c's 14 modes: the low bits of the first byte (2 or 5 bits)
BC6_MODE_BITS = [(0, 2), (1, 2)] + [((m << 2) | 2, 5) for m in range(8)] + [
    ((m << 2) | 3, 5) for m in range(4)]


@pytest.mark.parametrize("signed", [False, True], ids=["uf16", "sf16"])
@pytest.mark.parametrize("mode", range(14))
def test_bc6h_mode(mode, signed):
    """1,024 random blocks of one BC6H mode (seed 30 + mode), unsigned and
    signed: its end point layout, delta end points and partitions."""
    rng = np.random.default_rng(30 + mode)
    first, bits = BC6_MODE_BITS[mode]
    blocks = _mode_blocks(rng, 1024, first, bits)
    assert (dds._bc6_modes(blocks[:, 0].astype(np.int64)) == mode).all()
    _blocks_equal(96 if signed else 95, blocks)


@pytest.mark.parametrize("signed", [False, True], ids=["uf16", "sf16"])
def test_bc6h_reserved_modes(signed):
    """The four reserved 5-bit values decode black, as in PIL."""
    rng = np.random.default_rng(50)
    blocks = np.concatenate([_mode_blocks(rng, 64, v, 5)
                             for v in (0x13, 0x17, 0x1B, 0x1F)])
    assert (dds._bc6_modes(blocks[:, 0].astype(np.int64)) == 14).all()
    want, got = _both(_dds(96 if signed else 95, blocks))
    assert (want == 0).all() and (got == 0).all()


def test_bc6h_to_8_bits_truncates():
    """The half float becomes 8 bits as (UINT8)(f * 255.0f) after a clamp
    to [0, 1]: truncated, not rounded. A mode-11 block (one region, 10-bit
    end points) with both end points at one value v: every pixel is the
    same, trunc(half(v * 31 / 64) * 255)."""
    vals = []
    for v in range(0, 1024, 37):
        bits = np.zeros((1, 128), np.uint8)
        pos = fm._put(bits, 0, [3], 5)
        for _ in range(2):
            for _ in range(3):
                pos = fm._put(bits, pos, [v], 10)
        vals.append(fm._pack(bits)[0])
    want, got = _both(_dds(95, np.array(vals)))
    assert np.array_equal(want, got)
    u = [0 if v == 0 else 0xFFFF if v == 1023 else ((v << 16) + 0x8000) >> 10
         for v in range(0, 1024, 37)]
    half = (np.array(u) * 31 // 64).astype(np.uint16).view(np.float16)
    f = np.clip(half.astype(np.float32), 0, 1) * np.float32(255)
    assert np.array_equal(want[0, ::4, 0], np.trunc(f).astype(np.uint8))
    assert not np.array_equal(want[0, ::4, 0], np.round(f).astype(np.uint8))


# ---------------------------------------------------------------------------
# the partition and anchor tables, recovered from PIL
# ---------------------------------------------------------------------------

def _probe(mode: int, part: int, ends: list, ones: bool) -> np.ndarray:
    """A BC7 block of mode 1 (two subsets, 6-bit end points) or mode 2
    (three subsets, 5-bit): partition `part`, end point values `ends` for
    every channel, p-bits 0, every index bit 0 or 1."""
    bits = np.zeros((1, 128), np.uint8)
    pos = fm._put(bits, 0, [1 << mode], mode + 1)
    pos = fm._put(bits, pos, [part], 6)
    width = 6 if mode == 1 else 5
    for _ in range(3):
        for e in ends:
            pos = fm._put(bits, pos, [e], width)
    pos += 2 if mode == 1 else 0
    bits[0, pos:] = ones
    return fm._pack(bits)[0]


def test_partition_and_anchor_tables_match_pil():
    """One probe block per partition, all indices 0: a pixel's value is
    its subset's first end point, so PIL's decode shows the subset of
    every pixel. Then all index bits 1: an anchor pixel, whose index has
    one bit fewer, takes a lower weight than the others of its subset,
    so PIL's decode shows the anchors, each in its subset."""
    for mode, ns in ((1, 2), (2, 3)):
        top = 63 if mode == 1 else 31
        firsts = [0, top // 2, top][:ns] if ns == 3 else [0, top]
        subset_ends = [v for f in firsts for v in (f, top)]
        blocks = np.array([_probe(mode, p, subset_ends, False)
                           for p in range(64)])
        red = _both(_dds(98, blocks))[0].reshape(4, 64, 4, 3).transpose(
            1, 0, 2, 3).reshape(64, 16, 3)[..., 0]
        levels = np.unique(red)
        assert len(levels) == ns
        subsets = np.searchsorted(levels, red)
        assert np.array_equal(subsets, dds.subset_map(ns))
        ramps = [v for _ in range(ns) for v in (0, top)]
        blocks = np.array([_probe(mode, p, ramps, True) for p in range(64)])
        red = _both(_dds(98, blocks))[0].reshape(4, 64, 4, 3).transpose(
            1, 0, 2, 3).reshape(64, 16, 3)[..., 0]
        anchors = red < red.max(1, keepdims=True)
        assert np.array_equal(anchors, dds.anchor_map(ns))
        for p in range(64):
            found = [int(np.flatnonzero(anchors[p] & (subsets[p] == s))[0])
                     for s in range(1, ns)]
            table = ([dds.BC7_ANCHORS2[p]] if ns == 2
                     else list(dds.BC7_ANCHORS3[p]))
            assert found == table, (ns, p)


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def test_digests_cover_the_files():
    """Every file of scenes/data/formats_b is pinned, in both copies of the
    digests, and the tool's entry point writes the committed bytes."""
    names = sorted(f"scenes/data/formats_b/{n}"
                   for n in os.listdir("scenes/data/formats_b"))
    assert names == FILES
    assert chip_smoke.FORMAT_B_DIGESTS == FORMAT_B_DIGESTS
    made = fm.files_b()
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
    assert hashlib.sha256(want.tobytes()).hexdigest() == FORMAT_B_DIGESTS[
        path]


def test_big_bc7():
    """The 2048x2048 BC7 texture, decoded once: PIL's decode and its
    digest, 262,144 blocks in 4,194,452 bytes, every mode, every partition
    of each mode and every rotation and selector of modes 4 and 5, and
    close to the seeded texture it encodes."""
    with open(BIG, "rb") as f:
        data = f.read()
    assert len(data) == 4194452 == 148 + 262144 * 16
    assert struct.unpack_from("<II", data, 12) == (2048, 2048)
    want, got = _both(data)
    assert np.array_equal(got, want)
    assert hashlib.sha256(got.tobytes()).hexdigest() == FORMAT_B_DIGESTS[BIG]
    blocks = np.frombuffer(data[148:], np.uint8).reshape(-1, 16)
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    mode = dds._LOWEST_BIT[blocks[:, 0]]
    for m, info in enumerate(dds.BC7_MODES):
        sel = bits[mode == m]
        assert len(sel), m
        pos = m + 1
        for n in (info.partition_bits, info.rotation_bits,
                  info.selector_bits):
            field = dds._field(sel, pos, n)
            assert len(np.unique(field)) == 1 << n, (m, pos, n)
            pos += n
    err = np.abs(got.astype(np.int64) - modes.big_texture())
    assert err.mean() < 3.0


# ---------------------------------------------------------------------------
# odd sizes, mipmaps, refusals
# ---------------------------------------------------------------------------

def _image(w: int, h: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.mgrid[0:h, 0:w].sum(0)[..., None] * 7 + rng.integers(0, 60, 4)
    return np.clip(base + rng.integers(-25, 25, (h, w, 4)), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("size", [(1, 1), (5, 3), (13, 9), (37, 23)],
                         ids=str)
@pytest.mark.parametrize("kind", ["bc4", "bc6h", "bc6hs", "bc7"])
def test_odd_sizes(tmp_path, kind, size):
    """Images whose sides are not multiples of 4 (seeded, seed = width):
    the last row and column of blocks are cut to the image."""
    w, h = size
    px = _image(w, h, w)
    n = -(-w // 4) * -(-h // 4)
    i = np.arange(n)
    if kind == "bc4":
        body, dxgi = fm.bc4_blocks(px[..., 0]), 80
    elif kind == "bc7":
        body, dxgi = fm.bc7_blocks(px, i % 8, i, i, i // 4), 98
    else:
        body = fm.bc6h_blocks(px[..., :3], i % 14, i, kind == "bc6hs")
        dxgi = 96 if kind == "bc6hs" else 95
    data = fm.dds_bytes(w, h, body, 0x4, b"DX10", dxgi=dxgi)
    assert same_as_reference(tmp_path, data).shape == (h, w, 3)


@pytest.mark.parametrize("kind", ["bc4", "bc7"])
def test_mipmapped(tmp_path, kind):
    """A file with its mip chain (the mipmap count set, the smaller levels
    after the first): PIL and the port decode the first level."""
    px = _image(32, 16, 5)
    levels, w, h = [], 32, 16
    while True:
        lv = px[::32 // w, ::16 // h][:h, :w]
        n = -(-w // 4) * -(-h // 4)
        levels.append(fm.bc4_blocks(lv[..., 0]) if kind == "bc4"
                      else fm.bc7_blocks(lv, np.arange(n) % 8,
                                         np.arange(n), np.arange(n),
                                         np.arange(n)))
        if w == 1 and h == 1:
            break
        w, h = max(w // 2, 1), max(h // 2, 1)
    data = bytearray(fm.dds_bytes(32, 16, b"".join(levels), 0x4, b"DX10",
                                  dxgi=80 if kind == "bc4" else 98))
    struct.pack_into("<I", data, 8, 0x1007 | 0x20000)   # DDSD_MIPMAPCOUNT
    struct.pack_into("<I", data, 28, len(levels))
    got = same_as_reference(tmp_path, bytes(data))
    alone = fm.dds_bytes(32, 16, levels[0], 0x4, b"DX10",
                         dxgi=80 if kind == "bc4" else 98)
    assert np.array_equal(got, ttex.decode_image(alone))


@pytest.mark.parametrize("data,what", [
    (fm.dds_bytes(8, 8, bytes(32), 0x4, b"DX10", dxgi=81), "81 .BC4 SNORM"),
    (fm.dds_bytes(8, 8, bytes(32), 0x4, b"BC4S"), "BC4S.*BC4 SNORM"),
    (fm.dds_bytes(8, 8, bytes(64), 0x4, b"DX10", dxgi=94),
     "94 .BC6H TYPELESS"),
], ids=["bc4-snorm", "bc4s", "bc6h-typeless"])
def test_formats_pil_refuses_raise(data, what):
    """BC4 SNORM (DXGI 81, FourCC BC4S) and BC6H TYPELESS, which PIL does
    not decode either, raise NotImplementedError naming them."""
    with pytest.raises(NotImplementedError):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(NotImplementedError, match=what):
        ttex.decode_image(data)
