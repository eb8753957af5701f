"""Write JPEG copies of the textured scene's images: scenes/data/grid.jpg
and scenes/data/logo.jpg, from the PNGs beside them (alpha dropped), with
PIL at quality 90 and 4:2:0 chroma sampling, the shape of the testsuite's
own JPEG textures (grey_grid.jpg, SA_logo.jpg).

scenes/textured_disk.ass keeps naming the PNGs; the tests and chip_smoke.py
render it with the names changed to .jpg at run time. The SHA-256 of PIL's
decode of each file is pinned in tests/test_torch_jpeg.py.

    python tools/make_jpeg_textures.py
"""
from __future__ import annotations

import os

from PIL import Image

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "scenes", "data")


def main() -> None:
    for name in ("grid", "logo"):
        img = Image.open(os.path.join(DATA, f"{name}.png")).convert("RGB")
        img.save(os.path.join(DATA, f"{name}.jpg"), "JPEG", quality=90,
                 subsampling="4:2:0")


if __name__ == "__main__":
    main()
