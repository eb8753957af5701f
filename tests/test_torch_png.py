"""io/png.py, the port's PNG writer and resample, against PIL.

`write_png`'s files decode equal to the image by PIL and by the port's own
decoder (scene/texture.py). `resize` is Pillow's default bicubic
`Image.resize` of an 8-bit RGB image: measured equal to Pillow 12.1.0's,
every byte, at every size below (up, down, mixed, one axis only and the
identity), so the tolerance is 0.
"""
import numpy as np
import pytest
from PIL import Image

from rlshaders_tpu_torch.io import png
from rlshaders_tpu_torch.scene import texture


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("h,w", [(1, 1), (16, 48), (37, 53)])
def test_write_png_decodes_equal(tmp_path, h, w):
    img = _img(h, w, h + w)
    p = tmp_path / "a.png"
    png.write_png(str(p), img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    with open(p, "rb") as f:
        np.testing.assert_array_equal(texture.decode_png(f.read()), img)


def test_write_png_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8),
                np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError):
            png.write_png(str(tmp_path / "b.png"), bad)


@pytest.mark.parametrize("hw,size", [
    ((16, 16), (32, 32)), ((64, 64), (256, 256)), ((256, 256), (64, 64)),
    ((256, 256), (100, 300)), ((37, 53), (100, 20)), ((20, 30), (30, 20)),
    ((9, 300), (7, 900)), ((12, 12), (12, 30)), ((12, 12), (12, 12))])
def test_resize_equals_pil(hw, size):
    img = _img(*hw, seed=sum(size))
    mine = png.resize(img, size)
    want = np.asarray(Image.fromarray(img).resize(size))
    assert mine.shape == want.shape == (size[1], size[0], 3)
    assert mine.dtype == np.uint8
    np.testing.assert_array_equal(mine, want)


def test_resize_of_a_render_equals_pil():
    """A smooth image with saturated areas, as `cli test` resizes one."""
    y, x = np.mgrid[0:48, 0:48] / 47.0
    f = np.stack([x, y, 1.3 * x * y], -1)
    img = (np.clip(f, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        png.resize(img, (256, 256)),
        np.asarray(Image.fromarray(img).resize((256, 256))))
