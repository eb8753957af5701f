"""The JAX package's frame of the reduced textured scene (the copy that
tests/test_torch_textured_render.py renders: 16x16, AA 1, one diffuse and
one glossy sample a hit), jitted and op by op (jax.disable_jit), and the
pixels where the two differ by more than 1e-5, with the op-by-op values.
With --jpeg, the scene names its images .jpg (tests/test_torch_jpeg.py's
copy); with --images G,L,I, its three MayaFile slots (the grid, the logo,
the inverted logo) name those files of scenes/data instead
(tests/test_torch_format_render.py's frames, chip_smoke.FORMAT_FRAMES).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/textured_opbyop.py \
        [--jpeg | --images G,L,I]

The tests hold the port to the op-by-op values at those pixels. The
op-by-op render takes about a minute and a half on a CPU.
"""
from __future__ import annotations

import os
import re
import sys
import tempfile

import jax
import numpy as np

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(seed=0, aa_samples=1, xres=16, yres=16)


def main() -> None:
    with open(os.path.join(REPO, "scenes", "textured_disk.ass")) as f:
        src = f.read()
    for k in ("GI_diffuse_samples", "GI_glossy_samples"):
        src = re.sub(rf"^ {k} \d+$", f" {k} 1", src, flags=re.M)
    args = sys.argv[1:]
    if "--jpeg" in args:
        src = src.replace(".png", ".jpg")
    if "--images" in args:
        images = args[args.index("--images") + 1].split(",")
        for old, new in zip(("data/grid.png", "data/logo.png",
                             "data/logo.png"), images):
            assert f'"{old}"' in src, old
            src = src.replace(f'"{old}"', f'"data/{new}"', 1)
    with tempfile.TemporaryDirectory() as d:
        os.symlink(os.path.join(REPO, "scenes", "data"),
                   os.path.join(d, "data"))
        path = os.path.join(d, "t.ass")
        with open(path, "w") as f:
            f.write(src)
        js = jbuild.build(path)
    ja = jtrace.build(js.geometry)
    jit = jwave.render(js, ja, **KW)
    with jax.disable_jit():
        eager = jwave.render(js, ja, **KW)
    for name in jit:
        if name.startswith("__"):
            continue
        a, b = np.asarray(jit[name]), np.asarray(eager[name])
        err = np.abs(a - b).max(-1)
        print(f"{name}: max |jit - op by op| {float(err.max())!r}")
        for r, c in np.argwhere(err > 1e-5).tolist():
            print(f"    ({r}, {c}): {tuple(float(x) for x in b[r, c])!r}")


if __name__ == "__main__":
    main()
