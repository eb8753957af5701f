"""Ray queries of the reference: the plain BVH walk of `accel.bvh` on any
device, over a tree that the NumPy builder of `accel.bvh` builds."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bvh as bvhmod


class Accel(NamedTuple):
    tree: bvhmod.BVH
    tris: bvhmod.Tris


def build(geometry) -> Accel:
    """The binned-SAH tree over every triangle of `geometry`, on the
    geometry's device; triangles gathered into slot order."""
    dev = geometry.v0.device
    arrays = bvhmod.build_arrays(geometry.v0.cpu().numpy(),
                                 geometry.e1.cpu().numpy(),
                                 geometry.e2.cpu().numpy())

    def t(a, dtype):
        return torch.as_tensor(np.array(a), device=dev).to(dtype)

    bbox_min, bbox_max, first, count, miss, order = arrays
    tree = bvhmod.BVH(
        bbox_min=t(bbox_min, torch.float32),
        bbox_max=t(bbox_max, torch.float32),
        first=t(first, torch.int32), count=t(count, torch.int32),
        miss=t(miss, torch.int32), tri_order=t(order, torch.int32))
    slot = tree.tri_order.long()
    tris = bvhmod.Tris(
        v0=geometry.v0[slot].contiguous(), e1=geometry.e1[slot].contiguous(),
        e2=geometry.e2[slot].contiguous(),
        vis=geometry.visibility[slot].contiguous(),
        opaque=geometry.opaque[slot].contiguous())
    return Accel(tree=tree, tris=tris)


def nearest(accel: Accel, o, d, vis_mask: int, exclude_tri=None,
            t_eps: float = 1e-4, t_max=None) -> bvhmod.Hit:
    """Closest hit; lanes with t_max <= 0 are dead and miss."""
    r = o.shape[0]
    if t_max is None:
        t_max = torch.full((r,), 1e30, dtype=torch.float32, device=o.device)
    if exclude_tri is None:
        exclude_tri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    return bvhmod.intersect(accel.tree, accel.tris, o.contiguous(),
                            d.contiguous(), t_max.contiguous(),
                            exclude_tri.to(torch.int32).contiguous(),
                            vis_mask, t_eps)


def occluded(accel: Accel, o, d, t_max, vis_mask: int, exclude_tri=None,
             t_eps: float = 1e-4) -> torch.Tensor:
    """Any-hit shadow test over the segments [t_eps, t_max]."""
    r = o.shape[0]
    if exclude_tri is None:
        exclude_tri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    return bvhmod.occluded(accel.tree, accel.tris, o.contiguous(),
                           d.contiguous(), t_max.contiguous(),
                           exclude_tri.to(torch.int32).contiguous(),
                           vis_mask, t_eps)
