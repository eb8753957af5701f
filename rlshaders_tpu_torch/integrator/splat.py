"""Gaussian pixel-filter splatting into the framebuffer.

Counterpart of rlshaders_tpu/integrator/splat.py: each sample is weighted
into its 3x3 pixel neighbourhood with w = exp(-ALPHA d^2) - floor,
truncated at the filter radius. Accumulation is `index_add_`; on a CUDA
tensor that is float32 atomics, so the order of each pixel's sum, and with
it the last bits of the frame, changes from run to run there.
"""
from __future__ import annotations

import math

import torch

from ..core import tracer

# Gaussian falloff exponent, calibrated against the Arnold goldens.
ALPHA = 1.0


def splat(vals: torch.Tensor, pixel: torch.Tensor, sub_xy: torch.Tensor,
          xres: int, yres: int, filter_width: float):
    """Splat per-sample values (N, C) at flat pixels (N,) (-1 = padding)
    and subpixel positions (N, 2): one tile's partial framebuffer. Returns
    (image (n_pix, C) weighted sums, wsum (n_pix,)); divide by wsum to
    normalize."""
    n_pix = xres * yres
    radius = filter_width * 0.5
    gauss_floor = math.exp(-ALPHA * radius * radius)

    live = pixel >= 0
    pc = torch.clamp_min(pixel, 0)
    px = pc % xres
    py = pc // xres
    sx = px.to(torch.float32) + sub_xy[:, 0]
    sy = py.to(torch.float32) + sub_xy[:, 1]

    # one spare row takes the dropped taps (out of frame or padding)
    image = torch.zeros((n_pix + 1, vals.shape[1]), dtype=vals.dtype,
                        device=vals.device)
    wsum = torch.zeros((n_pix + 1,), dtype=vals.dtype, device=vals.device)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            nx = px + ox
            ny = py + oy
            valid = live & (nx >= 0) & (nx < xres) & (ny >= 0) & (ny < yres)
            dx = sx - (nx.to(torch.float32) + 0.5)
            dy = sy - (ny.to(torch.float32) + 0.5)
            d2 = dx * dx + dy * dy
            w = torch.exp(-ALPHA * d2) - gauss_floor
            w = torch.where((d2 <= radius * radius) & valid, w, 0.0)
            tgt = torch.where(valid, ny * xres + nx, n_pix)
            image.index_add_(0, tgt, vals * w[:, None])
            wsum.index_add_(0, tgt, w)
    return image[:n_pix], wsum[:n_pix]


@tracer.traced("splat")
def splat_accum(vals, pixel, sub_xy, image, wsum, xres: int, yres: int,
                filter_width: float) -> None:
    """Splat one tile's samples and add them into the running framebuffer
    (in place)."""
    img_t, ws_t = splat(vals, pixel, sub_xy, xres, yres, filter_width)
    image += img_t
    wsum += ws_t


@tracer.traced("splat")
def pack_aovs(rgb: torch.Tensor, aovs: dict):
    """Stack RGB + AOVs (sorted by name) into one (N, C) payload; returns
    (vals, names)."""
    names = sorted(aovs.keys())
    return torch.cat([rgb] + [aovs[k] for k in names], dim=1), names


def unpack_aovs(image: torch.Tensor, names) -> dict:
    """Split a packed (n_pix, C) framebuffer back into RGB + AOV planes."""
    out = {"RGBA": image[:, 0:3]}
    for i, name in enumerate(names):
        out[name] = image[:, 3 * (i + 1):3 * (i + 2)]
    return out
