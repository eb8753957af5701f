"""The ray-query kernels' bound: the least time the card could take for
a frame's queries.

The arithmetic is `chip_smoke.py::bound()`'s, copied. Bytes: each output
written once (nearest: t, tri, u, v, 16 B; occluded: 1 B); each live ray's
o, d, t_max and exclude (32 B) read once, and only the 4 B of t_max of a
dead lane (t_max <= 0); each tree node (24 + 12 B) and triangle slot
(36 + 4 + 4 + 1 B) that the walk tests, read once. Operations: the slab
and triangle tests the plain walk makes, times the float operations of
each in the kernels (every add, multiply, min, max, abs, compare and
reciprocal counted as one). The bound is the larger of the bytes over the
H100's HBM rate and the operations over its float32 rate outside the
tensor cores (NVIDIA's data sheet, SXM part, at 700 W).

The work is counted by the frozen plain walk (`rlsref.accel.bvh`, with its
`counts`) over the program's own tree, on a uniform subsample of one
frame's queries drawn from the run's seed, and scaled up by the rows a
kernel's queries held over the rows sampled. The records tested are
counted once over the sample, unscaled: the tables are small beside the
rays.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_RAY = 9       # inv_dir: abs, compare, reciprocal per axis
OPS_PER_BOX = 25      # box_hit: 6 sub, 6 mul, 11 min/max, 2 compares
OPS_PER_TRI = 53      # tri_test: Moller-Trumbore and its 6 hit compares
OUT_BYTES = {"rls_nearest": 16, "rls_occluded": 1}
# the device functions each entry point launches (ops/csrc/intersect.cu),
# as the profiler names them
DEVICE_NAMES = {"rls_nearest": "nearest_kernel",
                "rls_occluded": "occluded_kernel"}


def is_query(kernel: str) -> bool:
    """Whether a profiled kernel is one of the two ray queries."""
    return any(k in kernel for k in DEVICE_NAMES.values())


def bound_ms(name: str, q: dict) -> float:
    """The kernel's bound in ms for its counted work `q`."""
    table = q["nodes"] * (24 + 12) + q["slots"] * (36 + 4 + 4 + 1)
    live = q["live"]
    nbytes = (live * (32 + OUT_BYTES[name])
              + (q["rays"] - live) * (4 + OUT_BYTES[name]) + table)
    ops = OPS_PER_RAY * live + OPS_PER_BOX * q["boxes"] + OPS_PER_TRI * q["tris"]
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


# the counters of `TileRenderer.stats` that count each kernel's rays
STATS_RAYS = {"rls_nearest": "nearest_rays", "rls_occluded": "shadow_rays"}


class CaptureMissed(RuntimeError):
    """The capture saw other rays than the frame's own counters: the
    program no longer queries through `accel.trace`'s functions."""


def capture_and_count(ctx, spec: dict, frame_fn,
                      share: float = 1.0 / 1024) -> dict:
    """Render one frame with the program's queries sampled (a `share` of
    each call's rays), then count the plain walk's work on the sample:
    {kernel: {"rays", "live", "boxes", "tris", "nodes", "slots"}} for the
    whole frame. Raises CaptureMissed unless the rays captured of each
    kernel are the frame's `TileRenderer.stats` count."""
    import torch
    from rlsref.accel import bvh as walk

    from rlshaders_tpu_torch.accel import trace as tracemod

    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(spec["seed"]) % (1 << 63))
    groups = {}

    def keep(name, o, d, tm, ex, vis):
        n = o.shape[0]
        pick = torch.rand(n, generator=gen, device=o.device) < share
        g = groups.setdefault((name, vis), [0, []])
        g[0] += n
        g[1].append((o[pick], d[pick], tm[pick], ex.to(torch.int32)[pick]))

    real_nearest, real_occluded = tracemod.nearest, tracemod.occluded

    def nearest(acc, o, d, vis_mask, exclude_tri=None, t_eps=1e-4,
                t_max=None):
        r = o.shape[0]
        tm = (torch.full((r,), 1e30, device=o.device) if t_max is None
              else t_max)
        ex = (torch.full((r,), -1, dtype=torch.int32, device=o.device)
              if exclude_tri is None else exclude_tri)
        keep("rls_nearest", o, d, tm, ex, vis_mask)
        return real_nearest(acc, o, d, vis_mask, exclude_tri, t_eps, t_max)

    def occluded(acc, o, d, t_max, vis_mask, exclude_tri=None, t_eps=1e-4):
        r = o.shape[0]
        ex = (torch.full((r,), -1, dtype=torch.int32, device=o.device)
              if exclude_tri is None else exclude_tri)
        keep("rls_occluded", o, d, t_max, ex, vis_mask)
        return real_occluded(acc, o, d, t_max, vis_mask, exclude_tri, t_eps)

    tracemod.nearest, tracemod.occluded = nearest, occluded
    try:
        _, stats = frame_fn(ctx, spec["seed"])
    finally:
        tracemod.nearest, tracemod.occluded = real_nearest, real_occluded
    for name, key in STATS_RAYS.items():
        rows = sum(g[0] for (n, _), g in groups.items() if n == name)
        if rows != stats.get(key, 0):
            raise CaptureMissed(
                f"{name}: {rows} rays captured through accel.trace, the "
                f"frame's {key} is {stats.get(key, 0)}")
    out = {k: {"rays": 0, "live": 0.0, "boxes": 0.0, "tris": 0.0,
               "nodes": 0, "slots": 0} for k in OUT_BYTES}
    seen = {k: {} for k in OUT_BYTES}
    tree, tris = ctx.accel.tree, ctx.accel.tris
    for (name, vis), (rows, parts) in groups.items():
        o, d, tm, ex = (torch.cat(x) for x in zip(*parts))
        counts = seen[name]
        before = {k: counts.get(k, 0) for k in ("rays", "boxes", "tris")}
        if o.shape[0]:
            fn = walk.intersect if name == "rls_nearest" else walk.occluded
            fn(tree, tris, o, d, tm, ex, vis, counts=counts)
        scale = rows / max(o.shape[0], 1)
        q = out[name]
        q["rays"] += rows
        q["live"] += (counts.get("rays", 0) - before["rays"]) * scale
        q["boxes"] += (counts.get("boxes", 0) - before["boxes"]) * scale
        q["tris"] += (counts.get("tris", 0) - before["tris"]) * scale
    for name, counts in seen.items():
        for key, field in (("node_seen", "nodes"), ("slot_seen", "slots")):
            if key in counts:
                out[name][field] = int(counts[key].sum())
    return out
