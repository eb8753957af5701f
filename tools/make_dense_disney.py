"""The dense Disney scene: scenes/disney_spheres.ass with each of its six
rlDisney balls tessellated at `around` x `around // 2` quads.

Each `ball_*` polymesh (20 x 10 quads in the file) is replaced by the same
sphere, its centre and radius read from the file's vertices, with the same
shader, visibility and opacity: `around // 2 + 1` rings of `around`
vertices from pole to pole, analytic normals, quads laid out as the file
lays them out (the pole rings are collapsed, so each pole quad gives one
degenerate triangle, as in the file). Everything else stays: the floor,
the options (256x256, AA 3, 2x2 GI samples), camera, lights and shaders.

At the default 512 x 256 quads a ball has 262,144 triangles and the scene
1,572,866, whose BVH tables do not fit in the card's L2. The scene is a
node list for `scene.build.build(nodes, ...)`, kept in memory: as text it
would be some 50 MB of floats, and parsing is not what it measures.

    python tools/make_dense_disney.py [around]

prints the scene's polymeshes and triangle count.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from rlshaders_tpu_torch.scene.ass_parser import Node, parse

DISNEY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "scenes", "disney_spheres.ass")
AROUND = 512


def sphere(centre: np.ndarray, radius: float, around: int) -> dict:
    """vlist, nlist, nsides, vidxs and nidxs of a UV sphere of `around`
    quads round and `around // 2` from pole to pole."""
    rings = around // 2
    theta = np.pi * np.arange(rings + 1) / rings
    phi = 2.0 * np.pi * np.arange(around) / around
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    n = np.stack([st * np.cos(phi), ct * np.ones_like(phi),
                  st * np.sin(phi)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(rings), np.arange(around), indexing="ij")
    j1 = (j + 1) % around
    quads = np.stack([i * around + j, i * around + j1,
                      (i + 1) * around + j1, (i + 1) * around + j], -1)
    idxs = quads.reshape(-1).astype(np.int32)
    return {"nsides": np.full(rings * around, 4, np.int32), "vidxs": idxs,
            "vlist": (centre + radius * n).astype(np.float32),
            "nlist": n.astype(np.float32), "nidxs": idxs.copy()}


def dense_nodes(around: int = AROUND, path: str = DISNEY) -> list[Node]:
    """The scene's node list with every `ball_*` polymesh re-tessellated
    at `around` x `around // 2` quads."""
    out = []
    for node in parse(path):
        if node.type == "polymesh" and node.name.startswith("ball_"):
            v = np.asarray(node.get("vlist"), np.float64).reshape(-1, 3)
            lo, hi = v.min(0), v.max(0)
            node = Node(node.type, {**node.params, **sphere(
                (lo + hi) / 2, float(hi[1] - lo[1]) / 2, around)})
        out.append(node)
    return out


def triangles(nodes: list[Node]) -> int:
    return sum(int((np.asarray(n.get("nsides")) - 2).sum())
               for n in nodes if n.type == "polymesh")


if __name__ == "__main__":
    nodes = dense_nodes(int(sys.argv[1]) if len(sys.argv) > 1 else AROUND)
    for n in nodes:
        if n.type == "polymesh":
            print(n.name, len(n.get("vlist")), "vertices",
                  len(n.get("nsides")), "quads")
    print(triangles(nodes), "triangles")
