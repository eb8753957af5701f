"""Skip-link BVH: host build and the plain PyTorch traversal.

Counterpart of rlshaders_tpu/accel/bvh.py. The tree is stored in DFS order;
an AABB hit on an inner node advances to node i+1, a miss or a finished
leaf jumps to the node's `miss` link. The walk therefore needs one int of
state per ray and no stack: the layout the CUDA kernels in
`ops/csrc/intersect.cu` walk one thread per ray.

`intersect` / `occluded` here are the plain versions of those kernels: a
wavefront of rays walks the tree in lockstep over a tensor of node ids,
with the same slab test, the same Moller-Trumbore and the same hit rules,
operation for operation. They serve CPU tensors and the kernels' tests.

Tie rule: a triangle replaces the current best only at a strictly smaller
t, so among equal-t hits the first one met in the walk wins (the JAX BVH's
rule; the TPU kernel instead keeps the largest triangle id).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LEAF_SIZE = 4
N_BINS = 16


class BVH(NamedTuple):
    """Flattened threaded BVH (tensors on the scene's device)."""

    bbox_min: torch.Tensor   # (N, 3) f32
    bbox_max: torch.Tensor   # (N, 3) f32
    first: torch.Tensor      # (N,) i32 leaf: first triangle slot; inner: -1
    count: torch.Tensor      # (N,) i32 leaf: triangle count; inner: 0
    miss: torch.Tensor       # (N,) i32 skip link (node index, or N = done)
    tri_order: torch.Tensor  # (T,) i32 slot -> original triangle id


class Tris(NamedTuple):
    """Triangle tables in BVH slot order (slot s holds tri_order[s]), so a
    leaf's triangles are contiguous."""

    v0: torch.Tensor       # (T, 3) f32
    e1: torch.Tensor       # (T, 3) f32
    e2: torch.Tensor       # (T, 3) f32
    vis: torch.Tensor      # (T,) i32 ray-visibility bits
    opaque: torch.Tensor   # (T,) bool


class Hit(NamedTuple):
    """Per-ray nearest-hit record; tri = -1 means miss."""

    t: torch.Tensor
    tri: torch.Tensor     # original triangle id
    u: torch.Tensor       # barycentric of corner 1
    v: torch.Tensor       # barycentric of corner 2


def build_arrays(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Binned-SAH build over triangles (v0, v0+e1, v0+e2); returns the
    numpy arrays (bbox_min, bbox_max, first, count, miss, order). A port
    of the NumPy builder of rlshaders_tpu/accel/bvh.py."""
    v0 = np.asarray(v0, np.float32)
    p1 = v0 + np.asarray(e1, np.float32)
    p2 = v0 + np.asarray(e2, np.float32)
    t = v0.shape[0]
    tmin = np.minimum(np.minimum(v0, p1), p2)
    tmax = np.maximum(np.maximum(v0, p1), p2)
    cent = (tmin + tmax) * 0.5

    order = np.arange(t)
    bbox_min_l, bbox_max_l, first_l, count_l = [], [], [], []
    is_inner = []
    stack = [(0, t)]
    while stack:
        lo, hi = stack.pop()
        idx = order[lo:hi]
        bbox_min_l.append(tmin[idx].min(0))
        bbox_max_l.append(tmax[idx].max(0))
        n = hi - lo
        if n <= LEAF_SIZE:
            first_l.append(lo)
            count_l.append(n)
            is_inner.append(False)
            continue
        # binned SAH on the widest centroid axis
        c = cent[idx]
        cmin, cmax = c.min(0), c.max(0)
        axis = int(np.argmax(cmax - cmin))
        extent = cmax[axis] - cmin[axis]
        mid = lo + n // 2
        if extent >= 1e-12:
            scale = N_BINS * (1.0 - 1e-6) / extent
            bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
            counts = np.bincount(bins, minlength=N_BINS)
            bin_min = np.full((N_BINS, 3), np.inf, np.float32)
            bin_max = np.full((N_BINS, 3), -np.inf, np.float32)
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    bin_min[b] = tmin[idx[sel]].min(0)
                    bin_max[b] = tmax[idx[sel]].max(0)
            lmin = np.minimum.accumulate(bin_min, 0)
            lmax = np.maximum.accumulate(bin_max, 0)
            rmin = np.minimum.accumulate(bin_min[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], 0)[::-1]
            lcnt = np.cumsum(counts)

            def area(mn, mx):
                d = np.maximum(mx - mn, 0)
                return (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                        + d[:, 2] * d[:, 0])

            la = area(lmin, lmax)
            ra = area(rmin, rmax)
            best_cost, best_split = np.inf, None
            for b in range(N_BINS - 1):
                nl = lcnt[b]
                nr = n - nl
                if nl == 0 or nr == 0:
                    continue
                cost = la[b] * nl + ra[b + 1] * nr
                if cost < best_cost:
                    best_cost, best_split = cost, b
            if best_split is not None:
                sel = bins <= best_split
                left_idx = idx[sel]
                right_idx = idx[~sel]
                order[lo:lo + left_idx.size] = left_idx
                order[lo + left_idx.size:hi] = right_idx
                mid = lo + left_idx.size
        first_l.append(-1)
        count_l.append(0)
        is_inner.append(True)
        # DFS order: left child is me+1; push right first so left pops first
        stack.append((mid, hi))
        stack.append((lo, mid))

    n_nodes = len(bbox_min_l)
    # subtree sizes bottom-up: an inner node's left child is i+1, its right
    # child i+1+subtree[i+1]; the miss link is the node after my subtree
    subtree = np.ones(n_nodes, np.int64)
    for i in range(n_nodes - 1, -1, -1):
        if is_inner[i]:
            left = i + 1
            subtree[i] = 1 + subtree[left] + subtree[left + subtree[left]]
    miss = np.arange(n_nodes, dtype=np.int64) + subtree
    return (np.stack(bbox_min_l).astype(np.float32),
            np.stack(bbox_max_l).astype(np.float32),
            np.asarray(first_l, np.int32), np.asarray(count_l, np.int32),
            miss.astype(np.int32), order.astype(np.int32))


# ---------------------------------------------------------------------------
# Plain traversal (the kernels' reference)
# ---------------------------------------------------------------------------


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    # near-zero components take a LARGE constant of either sign's slab: a
    # sign(d)*BIG form is 0 for tiny negative d and collapses the interval
    big = d.abs() > 1e-12
    return torch.where(big, 1.0 / torch.where(big, d, 1.0), 1e12)


def _box_hit(tree: BVH, node, o, inv_d, t_best):
    """Slab test of the rays against their current nodes' boxes."""
    bmin = tree.bbox_min[node]
    bmax = tree.bbox_max[node]
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=1)
    tf = torch.maximum(t0, t1).amin(dim=1)
    return (tf >= torch.clamp_min(tn, 0.0)) & (tn < t_best)


def tri_test(v0, e1, e2, o, d, t_eps, t_best):
    """Moller-Trumbore, component by component in the order the kernel
    uses; returns (hit_mask, t, u, v)."""
    px = d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1]
    py = d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2]
    pz = d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    ok_det = det.abs() > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = o[:, 0] - v0[:, 0]
    ty = o[:, 1] - v0[:, 1]
    tz = o[:, 2] - v0[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    v = (d[:, 0] * qx + d[:, 1] * qy + d[:, 2] * qz) * inv_det
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_eps) & (t < t_best))
    return ok, t, u, v


def intersect(tree: BVH, tris: Tris, o: torch.Tensor, d: torch.Tensor,
              t_max: torch.Tensor, exclude_tri: torch.Tensor, vis_mask: int,
              t_eps: float = 1e-4) -> Hit:
    """Nearest hit of rays (R, 3) over triangles whose visibility shares a
    bit with vis_mask and that are not the ray's exclude_tri. A miss
    reports t = min(t_max, 1e30) and tri = -1; lanes with t_max <= 0 are
    dead and miss without walking."""
    r = o.shape[0]
    n_nodes = tree.first.shape[0]
    n_slots = tris.v0.shape[0]
    t_out = torch.clamp_max(t_max, 1e30)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    u_out = torch.zeros(r, dtype=torch.float32, device=o.device)
    v_out = torch.zeros(r, dtype=torch.float32, device=o.device)

    ray = torch.nonzero(t_max > 0.0).squeeze(1)
    o, d, excl = o[ray], d[ray], exclude_tri[ray]
    inv_d = _inv_dir(d)
    t_best, tri, uu, vv = t_out[ray], tri_out[ray], u_out[ray], v_out[ray]
    node = torch.zeros(ray.shape[0], dtype=torch.int64, device=o.device)
    while ray.numel():
        box = _box_hit(tree, node, o, inv_d, t_best)
        first = tree.first[node].long()
        cnt = tree.count[node]
        is_leaf = first >= 0
        leaf = box & is_leaf
        for k in range(LEAF_SIZE):
            ti = torch.clamp(first + k, 0, n_slots - 1)
            ok, t, u, v = tri_test(tris.v0[ti], tris.e1[ti], tris.e2[ti],
                                   o, d, t_eps, t_best)
            orig = tree.tri_order[ti]
            ok = (ok & leaf & (k < cnt) & (orig != excl)
                  & ((tris.vis[ti] & vis_mask) != 0))
            t_best = torch.where(ok, t, t_best)
            tri = torch.where(ok, orig, tri)
            uu = torch.where(ok, u, uu)
            vv = torch.where(ok, v, vv)
        node = torch.where(box & ~is_leaf, node + 1,
                           tree.miss[node].long())
        done = node >= n_nodes
        if bool(done.any()):
            fin = ray[done]
            t_out[fin] = t_best[done]
            tri_out[fin] = tri[done]
            u_out[fin] = uu[done]
            v_out[fin] = vv[done]
            keep = ~done
            ray, o, d, excl, inv_d = ray[keep], o[keep], d[keep], \
                excl[keep], inv_d[keep]
            t_best, tri, uu, vv, node = t_best[keep], tri[keep], uu[keep], \
                vv[keep], node[keep]
    return Hit(t=t_out, tri=tri_out, u=u_out, v=v_out)


def occluded(tree: BVH, tris: Tris, o: torch.Tensor, d: torch.Tensor,
             t_max: torch.Tensor, exclude_tri: torch.Tensor, vis_mask: int,
             t_eps: float = 1e-4) -> torch.Tensor:
    """Any-hit shadow query: True where an opaque triangle whose visibility
    shares a bit with vis_mask, other than exclude_tri, lies at
    t_eps < t < t_max. A ray stops walking at its first blocker."""
    r = o.shape[0]
    n_nodes = tree.first.shape[0]
    n_slots = tris.v0.shape[0]
    out = torch.zeros(r, dtype=torch.bool, device=o.device)

    ray = torch.nonzero(t_max > 0.0).squeeze(1)
    o, d, excl, tmax = o[ray], d[ray], exclude_tri[ray], t_max[ray]
    inv_d = _inv_dir(d)
    node = torch.zeros(ray.shape[0], dtype=torch.int64, device=o.device)
    while ray.numel():
        box = _box_hit(tree, node, o, inv_d, tmax)
        first = tree.first[node].long()
        cnt = tree.count[node]
        is_leaf = first >= 0
        leaf = box & is_leaf
        blocked = torch.zeros_like(leaf)
        for k in range(LEAF_SIZE):
            ti = torch.clamp(first + k, 0, n_slots - 1)
            ok, _, _, _ = tri_test(tris.v0[ti], tris.e1[ti], tris.e2[ti],
                                   o, d, t_eps, tmax)
            blocked |= (ok & leaf & (k < cnt)
                        & (tree.tri_order[ti] != excl)
                        & ((tris.vis[ti] & vis_mask) != 0)
                        & tris.opaque[ti])
        node = torch.where(box & ~is_leaf, node + 1,
                           tree.miss[node].long())
        done = blocked | (node >= n_nodes)
        if bool(done.any()):
            out[ray[blocked]] = True
            keep = ~done
            ray, o, d, excl, tmax, inv_d, node = ray[keep], o[keep], \
                d[keep], excl[keep], tmax[keep], inv_d[keep], node[keep]
    return out
