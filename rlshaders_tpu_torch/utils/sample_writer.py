"""Sampling-pattern diagnostics: the reference's SampleWriter, batched.

Counterpart of rlshaders_tpu/utils/sample_writer.py: (a) BRDF radiance over
a (theta, phi) hemisphere grid and (b) a green/red scatter of
importance-sampled directions, red marking below-horizon samples, with the
miss count (src/rlUtil.h:44-171, harness at rlGgx.cpp:202-224). Directions
are `V3` triples on `wo`'s device; the draws are the JAX package's
(`jax.random.uniform(stream(seed), (count, 2))`, bit for bit).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng
from ..core.vec3 import V3
from ..io import exr


def _expand(wo: V3, n: int) -> V3:
    return V3(*(c.expand(n) for c in wo))


def radiance_map(eval_fn, wo: V3, width: int = 512,
                 height: int = 256) -> np.ndarray:
    """f(wo, wi)*cos over the upper hemisphere: rows are theta in
    [0, pi/2), columns phi in [0, 2pi). eval_fn(wo, wi) -> V3."""
    dev = wo.x.device
    theta = (torch.arange(height, device=dev) + 0.5) / height * (math.pi / 2)
    phi = (torch.arange(width, device=dev) + 0.5) / width * (2 * math.pi)
    t, p = torch.meshgrid(theta, phi, indexing="ij")
    wi = V3((torch.sin(t) * torch.cos(p)).reshape(-1),
            (torch.sin(t) * torch.sin(p)).reshape(-1),
            torch.cos(t).reshape(-1))
    f = eval_fn(_expand(wo, height * width), wi)
    return f.aos().cpu().numpy().reshape(height, width, 3)


def sample_scatter(sample_fn, wo: V3, count: int = 2500, width: int = 512,
                   height: int = 256, seed: int = 0):
    """Importance-sample `count` directions and scatter them on the
    (theta, phi) grid: green above the horizon, red below (the reference's
    'missing' samples). sample_fn(wo, rx, ry) -> V3. Returns (image,
    miss_count)."""
    u = rng.uniform(rng.stream(seed), (count, 2), wo.x.device)
    wi = sample_fn(_expand(wo, count), u[:, 0], u[:, 1])
    wi = wi.aos().cpu().numpy()
    ok = np.linalg.norm(wi, axis=-1) > 0.5
    theta = np.arccos(np.clip(wi[:, 2], -1, 1))
    phi = np.mod(np.arctan2(wi[:, 1], wi[:, 0]), 2 * np.pi)
    x = np.clip((phi / (2 * np.pi) * width).astype(int), 0, width - 1)
    y = np.clip((theta / (np.pi / 2) * height).astype(int), 0, height - 1)
    below = theta > np.pi / 2

    img = np.zeros((height, width, 3), np.float32)
    img[y[ok & ~below], x[ok & ~below], 1] = 1.0
    img[y[ok & below], x[ok & below], 0] = 1.0
    return img, int((ok & below).sum())


def write_pattern(path: str, eval_fn, sample_fn, wo: V3, **kw):
    """Radiance map and sample scatter stacked in one EXR (the file the
    reference drops beside the beauty pass as rls_sampling_pattern.exr);
    returns the miss count."""
    rad = radiance_map(eval_fn, wo, **{k: v for k, v in kw.items()
                                       if k in ("width", "height")})
    scat, missing = sample_scatter(sample_fn, wo, **kw)
    exr.write_rgb(path, np.concatenate([rad, scat], axis=0))
    return missing
