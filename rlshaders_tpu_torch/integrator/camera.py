"""Perspective camera ray generation (persp_camera).

Counterpart of rlshaders_tpu/integrator/camera.py with its defaults: aa x aa
stratified subpixel positions jittered by threefry, horizontal fov across
the [-1, 1] screen window, row-vector camera-to-world matrix, and thin-lens
depth of field when the aperture is open.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import rng, tracer
from ..core.vecmath import normalize
from ..scene.build import Camera


class CameraRays(NamedTuple):
    origin: torch.Tensor     # (N, 3)
    direction: torch.Tensor  # (N, 3)
    pixel: torch.Tensor      # (N,) flat pixel index y*xres+x, int32
    sub_xy: torch.Tensor     # (N, 2) subpixel position in [0,1)^2


@tracer.traced("camera")
def generate(cam: Camera, key: torch.Tensor, aa_samples: int,
             xres: int | None = None, yres: int | None = None) -> CameraRays:
    """All camera rays of the frame, aa_samples^2 per pixel, pixel-major,
    on the camera matrix's device."""
    dev = cam.c2w.device
    xres = int(xres or cam.xres)
    yres = int(yres or cam.yres)
    n_sub = aa_samples * aa_samples
    n_pix = xres * yres

    px = torch.arange(n_pix, dtype=torch.int32, device=dev)
    ix = (px % xres).to(torch.float32)
    iy = (px // xres).to(torch.float32)

    sub = torch.arange(n_sub, dtype=torch.float32, device=dev)
    sx = torch.remainder(sub, aa_samples)
    sy = torch.floor(sub / aa_samples)
    jitter = rng.uniform(key, (n_pix, n_sub, 2), dev)
    ox = (sx[None, :] + jitter[..., 0]) / aa_samples
    oy = (sy[None, :] + jitter[..., 1]) / aa_samples

    x = (ix[:, None] + ox) / xres * 2.0 - 1.0
    y = 1.0 - (iy[:, None] + oy) / yres * 2.0
    aspect = yres / xres

    fov = torch.tensor(cam.fov_deg, dtype=torch.float32)
    tanf = float(torch.tan(fov * (math.pi / 180.0) * 0.5))
    dir_cam = torch.stack([x * tanf, y * tanf * aspect, -torch.ones_like(x)],
                          dim=-1)

    m = cam.c2w
    right, up, back = m[0, :3], m[1, :3], m[2, :3]
    d_world = normalize(dir_cam[..., 0:1] * right + dir_cam[..., 1:2] * up
                        + dir_cam[..., 2:3] * back)
    o = m[3, :3].expand(d_world.shape)
    if cam.aperture_size > 0.0:
        k1 = rng.split(rng.fold_in(key, 7))[0]
        u = rng.uniform(k1, (n_pix, n_sub, 2), dev)
        r = torch.sqrt(u[..., 0]) * cam.aperture_size
        phi = u[..., 1] * 2.0 * math.pi
        lens = ((r * torch.cos(phi))[..., None] * right
                + (r * torch.sin(phi))[..., None] * up)
        # focal point along the original ray
        cos_axis = -torch.sum(d_world * back, dim=-1, keepdim=True)
        tf = cam.focus_distance / torch.clamp_min(cos_axis, 1e-6)
        focal = o + d_world * tf
        o = o + lens
        d_world = normalize(focal - o)

    n = n_pix * n_sub
    return CameraRays(
        origin=o.reshape(n, 3).contiguous(),
        direction=d_world.reshape(n, 3).contiguous(),
        pixel=px.repeat_interleave(n_sub),
        sub_xy=torch.stack([ox, oy], dim=-1).reshape(n, 2),
    )
