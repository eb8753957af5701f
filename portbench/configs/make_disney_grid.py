"""Writes disney_grid.ass: the rlDisney material-test grid.

    python3 portbench/configs/make_disney_grid.py > portbench/configs/disney_grid.ass

Seven columns of roughness (0.05 to 0.95) by four rows of metallic (0, 1/3,
2/3, 1), one rlDisney sphere each, every other parameter at the shader's
defaults but the base colour; a grey `standard` floor, one quad key light
and a sky dome; 1920x1080, AA 3, GI diffuse and glossy samples 2, depths
1/1/4. Each sphere is a UV sphere of 20 x 10 quads (the pole rings
collapsed), as the balls of scenes/disney_spheres.ass are laid out, with
analytic normals: 400 triangles, 11,202 in the scene.
"""
from __future__ import annotations

import math
import sys

ROUGHNESS = [0.05 + 0.15 * i for i in range(7)]
METALLIC = [0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0]
RADIUS = 0.42
AROUND, RINGS = 20, 10
PITCH = math.atan2(1.0, 9.0)   # the camera at (0, 3, 9) looks at (0, 2, 0)


def fmt(x: float) -> str:
    return f"{x:.6g}"


def rows(values, per_line: int) -> str:
    return "\n".join(" ".join(values[i:i + per_line])
                     for i in range(0, len(values), per_line))


def sphere(name: str, shader: str, cx: float, cy: float) -> str:
    normals, quads = [], []
    for i in range(RINGS + 1):
        t = math.pi * i / RINGS
        for j in range(AROUND):
            p = 2.0 * math.pi * j / AROUND
            normals.append((math.sin(t) * math.cos(p), math.cos(t),
                            math.sin(t) * math.sin(p)))
    for i in range(RINGS):
        for j in range(AROUND):
            j1 = (j + 1) % AROUND
            quads += [i * AROUND + j, i * AROUND + j1,
                      (i + 1) * AROUND + j1, (i + 1) * AROUND + j]
    verts = [fmt(c) for n in normals
             for c in (cx + RADIUS * n[0], cy + RADIUS * n[1],
                       RADIUS * n[2])]
    norms = [fmt(c) for n in normals for c in n]
    idx = [str(q) for q in quads]
    n_quads = RINGS * AROUND
    return (f"polymesh\n{{\n name {name}\n nsides {n_quads} 1 UINT\n"
            f"{rows(['4'] * n_quads, 24)}\n"
            f" vidxs {len(idx)} 1 UINT\n{rows(idx, 24)}\n"
            f" vlist {len(normals)} 1 POINT\n{rows(verts, 12)}\n"
            f" nlist {len(normals)} 1 VECTOR\n{rows(norms, 12)}\n"
            f" nidxs {len(idx)} 1 UINT\n{rows(idx, 24)}\n"
            f" shader \"{shader}\"\n visibility 255\n opaque on\n}}\n")


def scene() -> str:
    c, s = math.cos(PITCH), math.sin(PITCH)
    out = [
        "# The rlDisney material-test grid: roughness 0.05-0.95 across seven\n"
        "# columns, metallic 0, 1/3, 2/3, 1 up four rows; written by\n"
        "# make_disney_grid.py\n",
        "options\n{\n AA_samples 3\n xres 1920\n yres 1080\n"
        " GI_diffuse_depth 1\n GI_glossy_depth 1\n GI_total_depth 4\n"
        " GI_diffuse_samples 2\n GI_glossy_samples 2\n camera \"cam\"\n}\n",
        f"persp_camera\n{{\n name cam\n fov 50\n matrix\n 1 0 0 0\n"
        f" 0 {fmt(c)} {fmt(-s)} 0\n 0 {fmt(s)} {fmt(c)} 0\n 0 3 9 1\n}}\n",
        "quad_light\n{\n name key\n vertices 4 1 POINT\n"
        "-1.5 0 -1.5 1.5 0 -1.5 1.5 0 1.5 -1.5 0 1.5\n matrix\n"
        " 1 0 0 0\n 0 1 0 0\n 0 0 1 0\n 0 5 3.5 1\n color 1 1 1\n"
        " intensity 20\n exposure 2\n samples 2\n normalize on\n"
        " affect_diffuse on\n affect_specular on\n diffuse 1\n"
        " specular 1\n}\n",
        "skydome_light\n{\n name sky\n color 0.4 0.5 0.7\n intensity 0.4\n"
        " samples 1\n matrix\n 1 0 0 0\n 0 1 0 0\n 0 0 1 0\n 0 0 0 1\n}\n",
        "polymesh\n{\n name floor\n nsides 4\n vidxs 4 1 UINT\n0 1 3 2\n"
        " vlist 4 1 POINT\n-20 0 20 20 0 20 -20 0 -20 20 0 -20\n"
        " nlist 4 1 VECTOR\n0 1 0 0 1 0 0 1 0 0 1 0\n nidxs 4 1 UINT\n"
        "0 1 2 3\n shader \"floor_mat\"\n visibility 255\n opaque on\n}\n",
        "standard\n{\n name floor_mat\n Kd 0.8\n Kd_color 0.6 0.6 0.6\n"
        " Ks 0\n}\n",
    ]
    for r, metallic in enumerate(METALLIC):
        for k, rough in enumerate(ROUGHNESS):
            out.append(f"rlDisney\n{{\n name dsy_m{r}_r{k}\n"
                       f" base_color 0.8 0.4 0.2\n metallic {fmt(metallic)}\n"
                       f" roughness {fmt(rough)}\n}}\n")
    for r in range(len(METALLIC)):
        for k in range(len(ROUGHNESS)):
            out.append(sphere(f"ball_m{r}_r{k}", f"dsy_m{r}_r{k}",
                              k - 3.0, 0.5 + r))
    return "".join(out)


if __name__ == "__main__":
    sys.stdout.write(scene())
