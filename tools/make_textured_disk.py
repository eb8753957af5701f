"""Write scenes/textured_disk.ass and its images under scenes/data/.

A scene shaped like the testsuite's shared test_geo.ass (whose images are
not in the repository): its options (256x256, AA 3, GI depths 1/1/6/6,
total 12, GI samples 3/3, texture, light and shader gamma 2.2, a gaussian
filter of width 2) and its shading network on about 2,000 triangles:

* a `standard` backdrop and floor with a MayaFile grid on Kd_color (with
  colorGain and colorOffset);
* a panel with a MayaFile under `invert on`;
* a panel under a planar MayaProjection with `wrap off` (its defaultColor
  outside the square) and a ball under one with `wrap on`, whose
  `standard` also links Ks to the file's alpha (`.a`);
* a bump3d over a `standard` ball, its height from a planar projection;
* an rlGgx ball with a KdColor texture and an rlDisney ball with a
  base_color texture;
* two disk lights (one with a scaled matrix and its radius mirrored, one
  with a unit matrix and a radius, the latter with affect_specular off)
  and a dome.

The images: data/grid.png (256x256 RGB: a grey grid with coloured cells)
and data/logo.png (300x200 RGBA: odd sizes down the mip chain). Both are
encoded here with zlib, each row with filter type row % 5, so that a
decoder meets all five PNG row filters.

    python tools/make_textured_disk.py
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "scenes")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(px: np.ndarray) -> bytes:
    """An 8-bit RGB or RGBA PNG of px (H, W, 3 or 4) uint8, row y filtered
    with filter type y % 5."""
    h, w, ch = px.shape
    bpp = ch
    rows = px.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        cur = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        ftype = y % 5
        pred = (0, a, prev, (a + prev) >> 1, _paeth(a, prev, c))[ftype]
        out.append(ftype)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    color = {3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out), 9))
            + chunk(b"IEND", b""))


def grid_image() -> np.ndarray:
    """256x256 RGB: light grey, dark lines every 32 texels, every third
    cell tinted."""
    n = 256
    y, x = np.mgrid[0:n, 0:n]
    img = np.full((n, n, 3), 190, np.int64)
    cell = (y // 32) * 8 + (x // 32)
    tints = np.array([[190, 190, 190], [200, 120, 90], [90, 150, 200]])
    img[:] = tints[np.where(cell % 3 == 0, 1 + (cell // 3) % 2, 0)]
    line = (x % 32 < 2) | (y % 32 < 2)
    img[line] = 40
    return img.astype(np.uint8)


def logo_image() -> np.ndarray:
    """300x200 RGBA: a disc with a ring and bars on a pale ground; alpha
    1 inside the disc, 0.5 outside."""
    h, w = 200, 300
    y, x = np.mgrid[0:h, 0:w]
    cx, cy = (w - 1) / 2, (h - 1) / 2
    r = np.hypot(x - cx, y - cy)
    img = np.zeros((h, w, 4), np.float64)
    img[..., :3] = [235, 225, 200]
    disc = r < 90
    img[disc, :3] = [30, 60, 150]
    ring = (r > 60) & (r < 72)
    img[ring, :3] = [240, 200, 40]
    bars = disc & (r < 55) & ((x // 12) % 2 == 0) & (np.abs(y - cy) < 35)
    img[bars, :3] = [250, 250, 250]
    img[..., 3] = np.where(disc, 255, 128)
    return np.round(img).astype(np.uint8)


def _g(v) -> str:
    return " ".join("%g" % x for x in np.ravel(v))


def _lines(vals, per_line) -> str:
    vals = list(vals)
    return "\n".join(_g(vals[i:i + per_line])
                     for i in range(0, len(vals), per_line))


def grid_mesh(name, shader, corner, du, dv, nu, nv, uv_scale, normal):
    """A tessellated parallelogram corner + [0,1] du + [0,1] dv with nu x
    nv quads, uv = (s, t) * uv_scale, one normal."""
    verts = [np.asarray(corner) + (i / nu) * np.asarray(du)
             + (j / nv) * np.asarray(dv)
             for j in range(nv + 1) for i in range(nu + 1)]
    uvs = [(i / nu * uv_scale[0], j / nv * uv_scale[1])
           for j in range(nv + 1) for i in range(nu + 1)]
    idx = []
    for j in range(nv):
        for i in range(nu):
            a = j * (nu + 1) + i
            idx += [a, a + 1, a + nu + 2, a + nu + 1]
    return _mesh(name, shader, np.round(verts, 6), idx, [normal] * len(verts),
                 idx, np.round(uvs, 6), idx)


def sphere_mesh(name, shader, centre, radius):
    """A 20 x 10 quad sphere with smooth normals and a seam-split uv."""
    nu, nv = 20, 10
    verts, normals, uvs = [], [], []
    for j in range(nv + 1):
        t = np.pi * j / nv
        for i in range(nu):
            p = 2 * np.pi * i / nu
            n = np.round([np.sin(t) * np.cos(p), np.cos(t),
                          np.sin(t) * np.sin(p)], 6)
            normals.append(n)
            verts.append(np.round(radius * n + np.asarray(centre), 6))
    for j in range(nv + 1):
        for i in range(nu + 1):
            uvs.append((i / nu, 1.0 - j / nv))
    idx, uidx = [], []
    for j in range(nv):
        for i in range(nu):
            a, b = j * nu + i, j * nu + (i + 1) % nu
            idx += [a, b, b + nu, a + nu]
            ua = j * (nu + 1) + i
            uidx += [ua, ua + 1, ua + nu + 2, ua + nu + 1]
    return _mesh(name, shader, verts, idx, normals, idx, np.round(uvs, 6),
                 uidx)


def _mesh(name, shader, verts, vidx, normals, nidx, uvs, uvidx) -> str:
    nq = len(vidx) // 4
    return f"""polymesh
{{
 name {name}
 nsides {nq} 1 UINT
{_lines([4] * nq, 24)}
 vidxs {len(vidx)} 1 UINT
{_lines(vidx, 24)}
 vlist {len(verts)} 1 POINT
{_lines(np.ravel(verts), 12)}
 nidxs {len(nidx)} 1 UINT
{_lines(nidx, 24)}
 nlist {len(normals)} 1 VECTOR
{_lines(np.ravel(normals), 12)}
 uvidxs {len(uvidx)} 1 UINT
{_lines(uvidx, 24)}
 uvlist {len(uvs)} 1 POINT2
{_lines(np.ravel(uvs), 12)}
 shader "{shader}"
 visibility 255
 opaque on
}}
"""


HEADER = """# A test_geo-shaped scene: MayaFile textures (gain, offset, invert),
# planar projections with wrap off and on, a linked Ks, a bump3d, texture
# links on rlGgx and rlDisney, two disk lights and a dome.
# Written by tools/make_textured_disk.py.
options
{
 AA_samples 3
 xres 256
 yres 256
 GI_diffuse_depth 1
 GI_glossy_depth 1
 GI_reflection_depth 6
 GI_refraction_depth 6
 GI_total_depth 12
 GI_diffuse_samples 3
 GI_glossy_samples 3
 texture_gamma 2.2
 light_gamma 2.2
 shader_gamma 2.2
 camera "cam"
 outputs "RGBA RGBA gauss"
}
gaussian_filter
{
 name gauss
 width 2
}
persp_camera
{
 name cam
 fov 50
 matrix
 1 0 0 0
 0 0.9659 -0.2588 0
 0 0.2588 0.9659 0
 0 2.2 7 1
}
disk_light
{
 name disk_key
 radius 1.5
 matrix
 1.5 0 0 0
 0 0 -1.5 0
 0 1.5 0 0
 -2 5 2 1
 color 1 0.95 0.9
 intensity 40
 exposure 0
 samples 2
 normalize on
 affect_diffuse on
 affect_specular on
}
disk_light
{
 name disk_fill
 radius 0.8
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 3 2.5 6 1
 color 0.8 0.9 1
 intensity 8
 exposure 0
 samples 2
 normalize on
 affect_diffuse on
 affect_specular off
}
skydome_light
{
 name sky
 color 0.5 0.55 0.6
 intensity 0.3
 samples 1
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 0 1
}
MayaFile
{
 name grid_file
 filename "data/grid.png"
 colorGain 0.8 0.8 0.8
 colorOffset 0.05 0.05 0.05
}
MayaFile
{
 name logo_file
 filename "data/logo.png"
}
MayaFile
{
 name logo_inv
 filename "data/logo.png"
 invert on
}
MayaProjection
{
 name poster_proj
 image "logo_file"
 wrap off
 defaultColor 0.8 0.25 0.2
 colorGain 0.9 0.9 0.9
 placementMatrix 0.8 0 0 0 0 0.8 0 0 0 0 1 0 2.4 -1.6 0 1
}
MayaProjection
{
 name ball_proj
 image "logo_file"
 wrap on
 placementMatrix 2.5 0 0 0 0 2.5 0 0 0 0 1 0 7.5 -1.75 0 1
}
MayaProjection
{
 name bump_proj
 image "grid_file"
 wrap on
 placementMatrix 1.2 0 0 0 0 1.2 0 0 0 0 1 0 1.2 -0.84 0 1
}
standard
{
 name grid_mat
 Kd 0.8
 Kd_color "grid_file"
 Ks 0
}
standard
{
 name poster_mat
 Kd 0.8
 Kd_color "poster_proj"
 Ks 0
}
standard
{
 name inv_mat
 Kd 0.7
 Kd_color "logo_inv"
 Ks 0
}
standard
{
 name logo_mat
 Kd 0.7
 Kd_color "ball_proj"
 Ks "logo_file.a"
 Ks_color 1 1 1
 specular_roughness 0.3
}
standard
{
 name bump_surf
 Kd 0.6
 Kd_color 0.7 0.7 0.7
 Ks 0.3
 specular_roughness 0.25
 specular_Fresnel on
 Ksn 0.05
}
bump3d
{
 name bump_node
 shader "bump_surf"
 bump_map "bump_proj.a"
 bump_height 0.04
}
rlGgx
{
 name ggx_tex
 Kd 0.6
 KdColor "grid_file"
 Ks 0.4
 KsColor 1 1 1
 specularRoughness 0.3
 ior 1.5
}
rlDisney
{
 name dsy_tex
 base_color "logo_file"
 roughness 0.4
 specular 0.5
 clearcoat 0.5
 clearcoat_gloss 0.7
}
"""


def scene_text() -> str:
    parts = [HEADER]
    parts.append(grid_mesh("backdrop", "grid_mat", (-6, 0, -3), (12, 0, 0),
                           (0, 7, 0), 12, 7, (3, 1.75), (0, 0, 1)))
    parts.append(grid_mesh("floor", "grid_mat", (-6, 0, 5), (12, 0, 0),
                           (0, 0, -8), 12, 8, (3, 2), (0, 1, 0)))
    parts.append(grid_mesh("poster", "poster_mat", (-5, 0.4, -2.5),
                           (4, 0, 0), (0, 3, 0), 4, 3, (1, 1), (0, 0, 1)))
    parts.append(grid_mesh("inv_panel", "inv_mat", (1, 0.4, -2.5),
                           (4, 0, 0), (0, 3, 0), 4, 3, (1, 1), (0, 0, 1)))
    for name, shader, x in (("logo_ball", "logo_mat", -3.0),
                            ("bump_ball", "bump_node", -1.0),
                            ("ggx_ball", "ggx_tex", 1.0),
                            ("dsy_ball", "dsy_tex", 3.0)):
        parts.append(sphere_mesh(name, shader, (x, 0.7, 0.5), 0.7))
    return "".join(parts)


def main() -> None:
    os.makedirs(os.path.join(ROOT, "data"), exist_ok=True)
    for name, img in (("grid.png", grid_image()), ("logo.png", logo_image())):
        with open(os.path.join(ROOT, "data", name), "wb") as f:
            f.write(encode_png(img))
    with open(os.path.join(ROOT, "textured_disk.ass"), "w") as f:
        f.write(scene_text())


if __name__ == "__main__":
    main()
