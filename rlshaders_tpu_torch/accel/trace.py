"""Ray-query interface: the BVH walk for CPU tensors, CUDA kernels for GPU
tensors.

Counterpart of rlshaders_tpu/accel/trace.py. The path is chosen by the
device of the rays, per call: a CPU tensor takes the plain walk of
`accel.bvh`, a CUDA tensor launches the kernel of `ops.intersect`, and any
other device raises. There is no process-wide backend switch and no
fallback from one to the other.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bvh as bvhmod
from . import native
from ..ops import intersect as kernels


class Accel(NamedTuple):
    tree: bvhmod.BVH          # structure-of-arrays tables: the plain walk's
    tris: bvhmod.Tris
    packed: kernels.Packed    # the same tables as the kernels' records


def from_arrays(geometry, bbox_min, bbox_max, first, count, miss,
                tri_order) -> Accel:
    """Accel from BVH arrays over `geometry` (its tensors' device); packs
    and checks the kernels' tables once, here."""
    dev = geometry.v0.device

    def t(a, dtype):
        return torch.as_tensor(np.array(a), device=dev).to(dtype)

    tree = bvhmod.BVH(
        bbox_min=t(bbox_min, torch.float32),
        bbox_max=t(bbox_max, torch.float32),
        first=t(first, torch.int32), count=t(count, torch.int32),
        miss=t(miss, torch.int32), tri_order=t(tri_order, torch.int32),
    )
    slot = tree.tri_order.long()
    tris = bvhmod.Tris(
        v0=geometry.v0[slot].contiguous(), e1=geometry.e1[slot].contiguous(),
        e2=geometry.e2[slot].contiguous(),
        vis=geometry.visibility[slot].contiguous(),
        opaque=geometry.opaque[slot].contiguous(),
    )
    return Accel(tree=tree, tris=tris, packed=kernels.pack(tree, tris))


def build(geometry, member: np.ndarray | None = None) -> Accel:
    """Build the BVH on the host with the native builder (`accel.native`;
    a failed compile raises) over the scene's triangles, or over the
    subset `member` (a bool per triangle) of them. Hits report original
    triangle ids either way: the builder's subset-local order is mapped
    back, and the tables gather the geometry by it.

    The JAX build strips its tables' power-of-two padding rows first; the
    port's tables have none, so every row is a triangle. As in the JAX
    package, a subset with no member is built over triangle 0; here that
    is a real triangle, which the subset's queries can hit."""
    idx = np.arange(geometry.v0.shape[0])
    if member is not None:
        idx = idx[np.asarray(member, bool)]
        if idx.size == 0:
            idx = np.zeros(1, np.int64)
    arrays = native.build_arrays(geometry.v0.cpu().numpy()[idx],
                                 geometry.e1.cpu().numpy()[idx],
                                 geometry.e2.cpu().numpy()[idx])
    return from_arrays(geometry, *arrays[:-1], idx[arrays[-1]])


def build_trace_set(geometry, set_bit: int, inclusive: bool) -> Accel:
    """Accel over one trace set (Arnold's AiShaderGlobalsSet/UnsetTraceSet):
    `inclusive` keeps the set's members, else everything but them. Set
    `set_bit` is the set's index in `Scene.trace_set_names`; membership is
    visibility bit 8 + set_bit. Its queries behave as the full scene's do
    (original ids, the same visibility gating)."""
    vis = geometry.visibility.cpu().numpy()
    mem = (vis & (1 << (8 + set_bit))) != 0
    return build(geometry, member=mem if inclusive else ~mem)


def _no_path(o: torch.Tensor):
    return ValueError(f"no ray-query path for device {o.device}")


def nearest(accel: Accel, o, d, vis_mask: int, exclude_tri=None,
            t_eps: float = 1e-4, t_max=None) -> bvhmod.Hit:
    """Closest hit; t_max (per ray, optional) bounds the segment, and
    lanes with t_max <= 0 are dead."""
    r = o.shape[0]
    if t_max is None:
        t_max = torch.full((r,), 1e30, dtype=torch.float32, device=o.device)
    if exclude_tri is None:
        exclude_tri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    rays = (o.contiguous(), d.contiguous(), t_max.contiguous(),
            exclude_tri.to(torch.int32).contiguous(), vis_mask, t_eps)
    if o.device.type == "cpu":
        return bvhmod.intersect(accel.tree, accel.tris, *rays)
    if o.device.type == "cuda":
        return kernels.nearest(accel.packed, *rays)
    raise _no_path(o)


def occluded(accel: Accel, o, d, t_max, vis_mask: int, exclude_tri=None,
             t_eps: float = 1e-4) -> torch.Tensor:
    """Any-hit shadow test over the segments [t_eps, t_max]."""
    r = o.shape[0]
    if exclude_tri is None:
        exclude_tri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    rays = (o.contiguous(), d.contiguous(), t_max.contiguous(),
            exclude_tri.to(torch.int32).contiguous(), vis_mask, t_eps)
    if o.device.type == "cpu":
        return bvhmod.occluded(accel.tree, accel.tris, *rays)
    if o.device.type == "cuda":
        return kernels.occluded(accel.packed, *rays)
    raise _no_path(o)
