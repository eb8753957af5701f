"""The built-in demo scene: a GGX cube, an rlSkin blob and a floor under a
quad light and a dome; needs no file from outside the repository.

Counterpart of `demo_scene` in rlshaders_tpu/parallel/mesh.py. The scene
text is a copy of that module's DEMO_SCENE_ASS (importing the JAX package
would import jax); a test holds the two equal.
"""
from __future__ import annotations

from ..accel import trace as tracemod
from . import build as buildmod

DEMO_SCENE_ASS = """
options
{
 AA_samples 2
 xres 32
 yres 32
 GI_diffuse_depth 1
 GI_glossy_depth 1
 GI_diffuse_samples 1
 GI_glossy_samples 1
 GI_sss_samples 2
 GI_total_depth 4
 camera "cam"
}
persp_camera
{
 name cam
 fov 45
 matrix
 1 0 0 0
 0 0.7071 -0.7071 0
 0 0.7071 0.7071 0
 0 2.5 2.5 1
}
quad_light
{
 name keylight
 color 1 0.95 0.9
 intensity 40
 decay_type quadratic
 normalize on
 samples 2
 vertices 4 1 POINT
-1 3 1 1 3 1 1 3 -1 -1 3 -1
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 0 1
}
skydome_light
{
 name sky
 color 0.4 0.5 0.7
 intensity 0.4
 samples 1
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 0 1
}
rlGgx
{
 name mat_ggx
 Kd 0.4
 Kd_color 0.7 0.3 0.2
 Ks 0.6
 Ks_color 1 1 1
 roughness 0.3
 ior 1.5
}
standard
{
 name mat_floor
 Kd 0.8
 Kd_color 0.6 0.6 0.6
}
rlSkin
{
 name mat_skin
 sss_color 0.9 0.6 0.5
 sss_weight 1.0
 sss_scatter_dist 0.3 0.2 0.15
 specular_weight 0.4
 specular_roughness 0.4
 sheen_weight 0.2
 sheen_roughness 0.35
}
polymesh
{
 name cube
 nsides 6 1 UINT
4 4 4 4 4 4
 vidxs 24 1 UINT
0 1 3 2 4 6 7 5 0 4 5 1 2 3 7 6 0 2 6 4 1 5 7 3
 vlist 8 1 POINT
-0.5 0 -0.5 0.5 0 -0.5 -0.5 1 -0.5 0.5 1 -0.5 -0.5 0 0.5 0.5 0 0.5 -0.5 1 0.5 0.5 1 0.5
 shader "mat_ggx"
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 0 1
}
polymesh
{
 name blob
 nsides 6 1 UINT
4 4 4 4 4 4
 vidxs 24 1 UINT
0 1 3 2 4 6 7 5 0 4 5 1 2 3 7 6 0 2 6 4 1 5 7 3
 vlist 8 1 POINT
0.9 0 -0.3 1.5 0 -0.3 0.9 0.6 -0.3 1.5 0.6 -0.3 0.9 0 0.3 1.5 0 0.3 0.9 0.6 0.3 1.5 0.6 0.3
 shader "mat_skin"
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 0 1
}
polymesh
{
 name floor
 nsides 4
 vidxs 4 1 UINT
0 1 3 2
 vlist 4 1 POINT
-8 0 8 8 0 8 -8 0 -8 8 0 -8
 nlist 4 1 VECTOR
0 1 0 0 1 0 0 1 0 0 1 0
 nidxs 4 1 UINT
0 1 2 3
 shader "mat_floor"
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 0 1
}
"""


def demo_scene(skin: bool = True, device="cuda"):
    """Build the demo scene on `device`; returns (scene, accel).

    skin=True keeps the blob's rlSkin material (its camera hits run the SSS
    probe stage); skin=False gives the blob the floor's material, as the
    JAX version does."""
    src = DEMO_SCENE_ASS
    if not skin:
        src = src.replace('shader "mat_skin"', 'shader "mat_floor"')
    scene = buildmod.build_text(src, device)
    return scene, tracemod.build(scene.geometry)
