"""The port's JPEG decoder (scene/jpeg.py) on the modes this slice adds,
against PIL and the JAX package's `load_image(path, 1.0)`: array-equal on
every file.

Progressive Huffman files (SOF2) as PIL writes them: every chroma sampling
at four sizes, grey, optimised tables (a DHT before every scan, so tables
are redefined between scans), restart markers every 1, 2 or 3 MCUs (end
of band runs cut at each marker); four-component files: Adobe CMYK as PIL
writes it (transform 0, the samples inverted), the same file without its
Adobe marker, YCCK (PIL's CMYK file with the APP14 transform byte set to
2, which libjpeg decodes through its YCC to CMYK conversion), each also
progressive; RGB-coded three-component files (PIL's keep_rgb: Adobe
transform 0, component ids 'R', 'G', 'B'), with and without the Adobe
marker. A progressive file whose last refinement scans are cut away
before EOI is decoded by PIL with libjpeg's block smoothing, and by the
port equal to it.
"""
import io

import numpy as np
import pytest
from PIL import Image

from test_torch_image_modes import same_as_reference
from test_torch_jpeg import _image, _jpeg
from rlshaders_tpu_torch.scene.jpeg import decode_jpeg

SIZES = [(37, 23), (1, 1), (17, 300), (256, 256)]   # (width, height)


def _segments(data: bytes, marker: int) -> list:
    """Positions of every `marker` segment (0xFF, marker) outside the
    entropy-coded data."""
    out, pos = [], 2
    while pos < len(data) and data[pos] == 0xFF:
        m = data[pos + 1]
        if m == 0xD9:
            break
        if m == marker:
            out.append(pos)
        length = data[pos + 2] << 8 | data[pos + 3]
        pos += 2 + length
        if m == 0xDA:                      # skip the scan's data
            while not (data[pos] == 0xFF and data[pos + 1] not in (
                    0x00, *range(0xD0, 0xD8))):
                pos += 1
    return out


def _without(data: bytes, marker: int) -> bytes:
    """The file without its `marker` segments."""
    for pos in reversed(_segments(data, marker)):
        length = data[pos + 2] << 8 | data[pos + 3]
        data = data[:pos] + data[pos + 2 + length:]
    return data


def _adobe_transform(data: bytes, transform: int) -> bytes:
    pos = _segments(data, 0xEE)[0]
    assert data[pos + 4:pos + 9] == b"Adobe"
    return data[:pos + 15] + bytes([transform]) + data[pos + 16:]


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", SIZES)
def test_progressive(tmp_path, size, sampling):
    data = _jpeg(_image(*size), quality=75, subsampling=sampling,
                 progressive=True)
    assert b"\xff\xc2" in data
    same_as_reference(tmp_path, data)


@pytest.mark.parametrize("size", SIZES)
def test_progressive_grey(tmp_path, size):
    same_as_reference(tmp_path, _jpeg(_image(*size), mode="L", quality=75,
                                      progressive=True))


@pytest.mark.parametrize("quality", [50, 90, 100])
def test_progressive_tables_redefined_between_scans(tmp_path, quality):
    data = _jpeg(_image(64, 48, quality), quality=quality, optimize=True,
                 progressive=True)
    dht, sos = _segments(data, 0xC4), _segments(data, 0xDA)
    assert len(sos) >= 6 and any(sos[0] < d for d in dht)
    same_as_reference(tmp_path, data)


@pytest.mark.parametrize("blocks", [1, 2, 3])
@pytest.mark.parametrize("size", [(37, 23), (256, 256)])
def test_progressive_restarts(tmp_path, size, blocks):
    data = _jpeg(_image(*size), quality=75, progressive=True,
                 restart_marker_blocks=blocks)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    same_as_reference(tmp_path, data)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", [(37, 23), (64, 64), (1, 1)])
def test_cmyk(tmp_path, size, progressive):
    data = _jpeg(_image(*size), mode="CMYK", quality=85,
                 progressive=progressive)
    same_as_reference(tmp_path, data, "adobe.jpg")
    plain = _without(data, 0xEE)
    assert b"Adobe" not in plain
    same_as_reference(tmp_path, plain, "plain.jpg")


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", [(37, 23), (64, 64)])
def test_ycck(tmp_path, size, progressive):
    data = _adobe_transform(_jpeg(_image(*size), mode="CMYK", quality=85,
                                  progressive=progressive), 2)
    assert Image.open(io.BytesIO(data)).info["adobe_transform"] == 2
    same_as_reference(tmp_path, data)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", [(37, 23), (1, 1), (16, 9)])
def test_rgb_coded(tmp_path, size, progressive):
    data = _jpeg(_image(*size), quality=85, keep_rgb=True,
                 progressive=progressive)
    assert b"JFIF" not in data
    same_as_reference(tmp_path, data, "adobe.jpg")
    # without the Adobe marker the component ids 'R', 'G', 'B' decide
    same_as_reference(tmp_path, _without(data, 0xEE), "ids.jpg")


def test_cut_progressive_file_raises_block_smoothing():
    """PIL decodes a progressive file cut after any of its scans (EOI in
    place of the rest); libjpeg then smooths the blocks whose low AC
    coefficients are not fully refined, and the port decodes each cut
    file equal to PIL (it refused them, naming block smoothing, until
    fault 10 was closed)."""
    data = _jpeg(_image(64, 48), quality=80, progressive=True)
    sos = _segments(data, 0xDA)
    for k in range(1, len(sos)):
        cut = max([p for p in _segments(data, 0xC4) if sos[k - 1] < p
                   < sos[k]] or [sos[k]])
        part = data[:cut] + b"\xff\xd9"
        want = np.asarray(Image.open(io.BytesIO(part)).convert("RGB"))
        assert want.shape == (48, 64, 3)
        assert np.array_equal(decode_jpeg(part), want)
