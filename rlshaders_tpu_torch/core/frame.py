"""Orthonormal shading frames on channel-split vectors.

Counterpart of the V3 half of rlshaders_tpu/core/frame.py. A frame is
(U, V, N); BSDF code works in the local frame where N = +z, U = +x.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import vec3
from .vec3 import V3


class Frame(NamedTuple):
    u: V3
    v: V3
    n: V3


def build_frame_polar_v(n: V3) -> Frame:
    """Polar-style frame (AiBuildLocalFramePolar orientation): U along the
    azimuth (d n / d phi), V = N x U, with a fixed fallback at the poles."""
    x, y, z = n.x, n.y, n.z
    sin_theta = torch.sqrt(torch.clamp_min(x * x + y * y, 0.0))
    degenerate = sin_theta < 1e-6
    inv = torch.where(
        degenerate, 0.0, 1.0 / torch.clamp_min(sin_theta, 1e-12))
    cos_phi = torch.where(degenerate, 1.0, x * inv)
    sin_phi = torch.where(degenerate, 0.0, y * inv)
    u = vec3.normalize(V3(-sin_phi, cos_phi, torch.zeros_like(z)))
    v = vec3.normalize(vec3.cross(n, u))
    return Frame(u=u, v=v, n=n)


def to_local_v(frame: Frame, w: V3) -> V3:
    """World -> local (x=U, y=V, z=N)."""
    return V3(vec3.dot(w, frame.u), vec3.dot(w, frame.v),
              vec3.dot(w, frame.n))


def to_world_v(frame: Frame, w: V3) -> V3:
    """Local -> world."""
    return frame.u * w.x + frame.v * w.y + frame.n * w.z


def tile_frame(frame: Frame, k: int) -> Frame:
    return Frame(u=vec3.tile(frame.u, k), v=vec3.tile(frame.v, k),
                 n=vec3.tile(frame.n, k))
