"""The port's EXR codec: a verbatim copy of the JAX package's, held equal
to it; its float and half round trips; files written by either package
read bit-equal by the other. Exact throughout: float channels round-trip
exactly, half channels to the float16 rounding of their input."""
import os

import numpy as np
import pytest

from rlshaders_tpu.io import exr as jexr
from rlshaders_tpu_torch.io import exr as texr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_copy_is_verbatim():
    with open(os.path.join(REPO, "rlshaders_tpu", "io", "exr.py")) as f:
        orig = f.read()
    with open(os.path.join(REPO, "rlshaders_tpu_torch", "io", "exr.py")) as f:
        copy = f.read()
    note = ("\n\nCopied verbatim from rlshaders_tpu/io/exr.py: importing any\n"
            "module of rlshaders_tpu imports jax, which the torch port must "
            "not need.")
    assert note in copy
    assert copy.replace(note, "") == orig


def _image(h=37, w=53, seed=0):
    rs = np.random.default_rng(seed)
    img = rs.uniform(-2.0, 60000.0, (h, w, 3)).astype(np.float32)
    img[0, :5, 0] = [0.0, -0.0, 1e-8, 6e-5, 65504.0]
    return img


@pytest.mark.parametrize("half", [False, True])
def test_round_trip(tmp_path, half):
    img = _image()
    p = str(tmp_path / "a.exr")
    texr.write_rgb(p, img, half=half)
    back = texr.read_rgb(p)
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(back, want)
    assert back.dtype == np.float32


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_read_bit_equal(tmp_path, half, writer):
    img = _image(seed=1)
    w, r = (jexr, texr) if writer == "jax" else (texr, jexr)
    p = str(tmp_path / "b.exr")
    w.write_rgb(p, img, half=half)
    other = str(tmp_path / "c.exr")
    r.write_rgb(other, img, half=half)
    with open(p, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    ch_r, hdr_r = r.read(p)
    ch_w, hdr_w = w.read(p)
    assert hdr_r == hdr_w
    for k in ("R", "G", "B"):
        assert ch_r[k].tobytes() == ch_w[k].tobytes()
    assert texr.rmse(img, texr.read_rgb(p)) == jexr.rmse(img, jexr.read_rgb(p))
