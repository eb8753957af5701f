"""Ask Pillow's bundled LittleCMS how it converts 8-bit LAB to RGB, and hold
`rlshaders_tpu_torch/scene/lab.py` to each answer.

Pillow's `convert("RGB")` of a LAB image is lcms2's transform from
`cmsCreateLab2Profile(NULL)` to `cmsCreate_sRGBProfile()`, perceptual, no
flags, over 8-bit pixels. lcms2's source is not here, so each choice of
its optimiser is settled by calling `pillow.libs/liblcms2-*.so*` through
ctypes over all 2^24 inputs (one 4096x4096 image) and counting the
pixels that differ from PIL:

* the LabV2 and Lab 8-bit input formats (both give PIL's bytes);
* cmsFLAGS_GRIDPOINTS(17, 33, 49, 65) against the default (33 equals it);
* cmsFLAGS_NOWHITEONWHITEFIXUP and CLUT pre- and post-linearisation;
* cmsFLAGS_NOOPTIMIZE (the float pipeline at every input, not equal);
* the unoptimised 16-bit pipeline at the 33^3 nodes against
  `lab.table()` (every node equal);
* `lab.to_rgb` (tetrahedral) and a trilinear evaluation of the same table
  against PIL.

    PYTHONPATH=. python tools/probe_lcms.py

Each line prints a count of differing pixels (or nodes); `lab.py` is
right where its lines print 0. About a minute on a CPU.
"""
from __future__ import annotations

import ctypes
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from rlshaders_tpu_torch.scene import lab  # noqa: E402

PT_RGB, PT_LAB, PT_LABV2 = 4, 10, 30
NOOPTIMIZE, NOWHITEONWHITEFIXUP = 0x0100, 0x0004
PRELIN, POSTLIN = 0x0010, 0x0001


def fmt(space: int, channels: int, size: int, extra: int = 0) -> int:
    """lcms2's pixel format word (COLORSPACE_SH | EXTRA_SH | CHANNELS_SH
    | BYTES_SH)."""
    return space << 16 | extra << 7 | channels << 3 | size


def grid(n: int) -> int:
    return (n & 0xFF) << 16


def library():
    import PIL
    import PIL._imaging  # noqa: F401  (loads the bundled libraries)

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    lcms = ctypes.CDLL(glob.glob(os.path.join(libs, "liblcms2-*.so*"))[0])
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    for name in ("cmsCreateLab2Profile", "cmsCreate_sRGBProfile",
                 "cmsCreateTransform"):
        getattr(lcms, name).restype = vp
    lcms.cmsCreateLab2Profile.argtypes = [vp]
    lcms.cmsCreateTransform.argtypes = [vp, u32, vp, u32, u32, u32]
    lcms.cmsDoTransform.argtypes = [vp, vp, vp, u32]
    return lcms


def main() -> None:
    from PIL import Image

    lcms = library()
    lab_profile = lcms.cmsCreateLab2Profile(None)
    srgb = lcms.cmsCreate_sRGBProfile()

    def run(fin, fout, flags, pixels, out_dtype, out_channels):
        x = lcms.cmsCreateTransform(lab_profile, fin, srgb, fout, 0, flags)
        pixels = np.ascontiguousarray(pixels)
        out = np.zeros((len(pixels), out_channels), out_dtype)
        lcms.cmsDoTransform(x, pixels.ctypes.data, out.ctypes.data,
                            len(pixels))
        return out

    a = np.arange(1 << 24, dtype=np.uint32)
    stored = np.stack([a >> 16, a >> 8 & 255, a & 255], -1).astype(np.uint8)
    raw = stored ^ np.array([0, 128, 128], np.uint8)   # PIL's "LAB" raw mode
    pil = np.asarray(Image.frombytes("LAB", (4096, 4096), raw.tobytes())
                     .convert("RGB")).reshape(-1, 3)
    del raw
    px = np.concatenate([stored, np.zeros((len(a), 1), np.uint8)], 1)
    rgba = fmt(PT_RGB, 3, 1, 1)
    for name, fin, flags in (
            ("LabV2 8-bit, flags 0", fmt(PT_LABV2, 3, 1, 1), 0),
            ("Lab 8-bit, flags 0", fmt(PT_LAB, 3, 1, 1), 0),
            ("GRIDPOINTS(17)", fmt(PT_LAB, 3, 1, 1), grid(17)),
            ("GRIDPOINTS(33)", fmt(PT_LAB, 3, 1, 1), grid(33)),
            ("GRIDPOINTS(49)", fmt(PT_LAB, 3, 1, 1), grid(49)),
            ("GRIDPOINTS(65)", fmt(PT_LAB, 3, 1, 1), grid(65)),
            ("NOWHITEONWHITEFIXUP", fmt(PT_LAB, 3, 1, 1),
             NOWHITEONWHITEFIXUP),
            ("CLUT_PRE_LINEARIZATION", fmt(PT_LAB, 3, 1, 1), PRELIN),
            ("CLUT_POST_LINEARIZATION", fmt(PT_LAB, 3, 1, 1), POSTLIN),
            ("NOOPTIMIZE", fmt(PT_LAB, 3, 1, 1), NOOPTIMIZE)):
        out = run(fin, rgba, flags, px, np.uint8, 4)[:, :3]
        print(f"lcms2 {name}: {(out != pil).any(1).sum()} pixels differ "
              f"from PIL")
    q = lab.saturate_word(np.arange(lab.GRID) * 65535.0 / (lab.GRID - 1))
    nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
    words = run(fmt(PT_LAB, 3, 2), fmt(PT_RGB, 3, 2), NOOPTIMIZE,
                nodes.astype(np.uint16), np.uint16, 3)
    table = lab.table().reshape(-1, 3)
    print(f"lab.table(): {(words != table).any(1).sum()} of {len(table)} "
          f"nodes differ from lcms2's unoptimised 16-bit pipeline")
    got = np.concatenate([lab.to_rgb(stored[i:i + (1 << 22)])
                          for i in range(0, 1 << 24, 1 << 22)])
    print(f"lab.to_rgb (tetrahedral): {(got != pil).any(1).sum()} pixels "
          f"differ from PIL")
    t = lab.table()
    tri = np.concatenate([_trilinear(t, stored[i:i + (1 << 22)])
                          for i in range(0, 1 << 24, 1 << 22)])
    print(f"the same table, trilinear: {(tri != pil).any(1).sum()} pixels "
          f"differ from PIL")


def _trilinear(t: np.ndarray, px: np.ndarray) -> np.ndarray:
    """lcms2's TrilinearInterp16 over the table, for the comparison."""
    w = px.astype(np.int64) * 257
    flat = t.reshape(-1, 3)
    f = lab._fixed(w)
    i0, r = f >> 16, (f & 0xFFFF)[..., None]
    stride = np.array([lab.GRID * lab.GRID, lab.GRID, 1])
    step = np.where(w == 0xFFFF, 0, stride)
    base = (i0 * stride).sum(1)

    def at(i, j, k):
        return flat[base + i * step[:, 0] + j * step[:, 1] + k * step[:, 2]]

    def lerp(a, lo, hi):
        return (lo + (((hi - lo) * a + 0x8000) >> 16)) & 0xFFFF

    x00 = lerp(r[:, 0], at(0, 0, 0), at(1, 0, 0))
    x01 = lerp(r[:, 0], at(0, 0, 1), at(1, 0, 1))
    x10 = lerp(r[:, 0], at(0, 1, 0), at(1, 1, 0))
    x11 = lerp(r[:, 0], at(0, 1, 1), at(1, 1, 1))
    out = lerp(r[:, 2], lerp(r[:, 1], x00, x10), lerp(r[:, 1], x01, x11))
    return ((out * 65281 + 8388608) >> 24).astype(np.uint8)


if __name__ == "__main__":
    main()
