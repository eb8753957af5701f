"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints progress and its time; any failure raises and exits
nonzero):

1. the card's name and power limit (nvidia-smi); refuses to run without a
   CUDA device;
2. builds the ray-query kernels (ops/csrc/intersect.cu) with nvcc;
3. holds each kernel against its plain PyTorch version (accel/bvh.py) on
   the card: on every query of a 256x256 demo frame (camera, GI and shadow
   rays), on random rays with dead lanes, exclude_tri and each visibility
   bit, and on random rays through a 12,000-triangle soup (too large for
   shared memory: the global path); prints mismatch counts, the launches
   of each table path, the times of both and the bound;
4. renders demo_scene(skin=False) at 256x256, AA 2, through the kernels,
   with the kernels' launch counts reset first and the plain walk barred
   from CUDA tensors; prints seconds per frame, the query counts and the
   rate;
5. renders the demo at 32x32 on the card and on the CPU (plain walk) and
   compares;
6. holds both kernels to the plain walk on every query of a 64x64, AA 3
   frame of scenes/glass_sphere.ass at its own depths with Russian
   roulette from refraction depth 2 (march steps with finite t_max and
   exclude = the previous hit, roulette-dead lanes with t_max 0); times the
   kernels (not the plain walk: one pass takes minutes; PERF.md has it),
   checks the kernels' device time against torch.profiler's sum of their
   launches, prints the dead lanes of those queries (launches with no live
   lane, 32-lane groups with a live lane) and the longest walk of each
   launch, and profiles a 128x128 frame, one full tile of the timed frame
   (the card's activity only: the device time by kernel, its busy share);
7. renders the glass scene at 256x256, AA 3, its own options, through the
   kernels (counts reset, plain walk barred); prints seconds per frame, the
   query counts, the rate and the refraction AOV;
8. the stage timing of the TPU tool tools/trace_decomp2.py (j_walk): each
   kernel alone, warm, on 262,144 coherent camera rays of the glass scene
   and 262,144 incoherent cosine-bounce rays from their hits, beside its
   byte and operation bounds;
9. renders the glass scene at 12x12 on the card and on the CPU and
   compares;
10. holds both kernels to the plain walk on every query of a 64x64, AA 2
   frame of scenes/skin_closeup.ass (the SSS probe stage: probes with an
   exclude and foreign-hit termination, the probe-hit light columns) and
   of a 64x64, AA 2 frame of demo_scene() with its rlSkin blob; prints the
   rays with an exclude and the dead lanes; times both kernels on the skin
   frame's queries (the `skin` shape) beside the plain walk and the bound;
11. renders scenes/skin_closeup.ass at its own options (512x512, AA 2)
   through the kernels (counts reset, plain walk barred); checks every
   plane and that the sss AOV is above 0; prints seconds per frame, the
   rays, the launches per kernel, and the device busy share of one
   profiled tile (128x128, AA 2);
12. renders the skin scene at 64x64, AA 2 on the card and on the CPU and
   compares;
13. holds both kernels to the plain walk on every query of a 64x64, AA 3
   frame of scenes/disney_spheres.ass (six rlDisney spheres: curved
   meshes, GTR1 and anisotropic glossy rays); prints the table path, the
   rays, the dead lanes and the launches by table path; times both kernels
   on those queries (the `disney` shape) beside the plain walk and the
   bound;
14. renders scenes/disney_spheres.ass at its own options (256x256, AA 3)
   through the kernels (counts reset, plain walk barred); checks every
   plane and that the indirect_specular AOV is above 0; prints seconds per
   frame, the rays, the launches per kernel and the rate, and profiles one
   128x128, AA 3 tile (the card's activity only);
15. renders the Disney scene at 32x32, AA 2 on the card and on the CPU and
   compares;
16. times the JAX package's Disney workload (bench.py `step`: a 1920x1080
   material grid, 8 samples a pixel, each a specular and a diffuse sample
   with eval and both MIS pdfs) through the port's bsdf/disney.py in eager
   torch, clearcoat 0.8 and 0.0, with CUDA events after a warm-up; prints
   Gsamples/s counted as bench.py counts them. A measurement, not a gate.
17. holds both kernels to the plain walk on every query of a 64x64, AA 3
   frame of scenes/textured_disk.ass at its own GI samples (3x3: textured
   backdrop, floor and panels, four balls, two disk lights and a dome);
   prints the table path, the rays, the dead lanes and the launches by
   table path; times both kernels on those queries (the `textured` shape)
   beside the plain walk and the bound;
18. renders scenes/textured_disk.ass at its own options (256x256, AA 3)
   through the kernels (counts reset, plain walk barred); checks every
   plane and that the direct_diffuse AOV is above 0; prints the texture
   table's bytes, seconds per frame, the rays, the launches per kernel
   and the rate, and profiles one 128x128, AA 3 tile (the card's activity
   only);
19. renders the textured scene at 32x32, AA 2 on the card and on the CPU
   and compares;
20. the command line on the card: `cli.main(["render",
   "scenes/textured_disk.ass", "-o", ..., "--passes", "2", "--aovs",
   "--profile"])` at the scene's own options, with the kernels' launch
   counts reset first; reads every EXR back (finite, the frame's shape),
   holds the beauty to the float64 mean of two direct renders at seeds 0
   and 7919 within half-float rounding, and times what the command adds
   around `render` (the float64 mean and host copy of the planes, the EXR
   writes); prints the passes' seconds, the stage lines, the stats line,
   the profile's top kernels and the launches;
21. trace sets: the textured scene with `trace_sets "setA"` on four of its
   eight polymeshes (the floor among them); both kernels held to the plain
   walk on every query of a 64x64, AA 3 frame rendered through each
   subset accel of `build_trace_set` (inclusive, exclusive), and timed on
   those queries (the `trace_sets_inclusive` and `trace_sets_exclusive`
   shapes) beside the plain walk and the bound;
22. `cli mkdir`, `list`, `test` and `display` on a suite written to a
   temporary directory: the Disney and textured scenes with the port's own
   card renders as goldens (both pass, rmse under 1e-3) and the textured
   scene with the Disney golden (fails); checks the listing, the report's
   rows and that every sheet decodes.

Each kernel is timed two ways at each shape (the demo frame's queries, the
glass frame's, the skin frame's, the Disney frame's, the textured frame's,
the two trace-set frames', the two j_walk sets):
`device_ms`, the shape's queries
captured in one CUDA graph whose replays are timed with CUDA events (what
the card spends; the wrappers' host time is paid once, at capture), and
`call_ms`, the same queries as eager wrapper calls timed with CUDA events
(what the main path pays per call). The share of the bound is taken from
`device_ms`. A kernel's top-level `ms` is the `call_ms` of the demo
frame's queries, the measure the key has always had; a comparison of
device times reads `shapes[...]["device_ms"]`.

The last three lines of the output are: a JSON object with one entry per
kernel (with, per shape, its launches, device_ms and call_ms); the card's
name and power limit as nvidia-smi prints them; and {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from functools import partial

import numpy as np
import torch

DEVICE = "cuda"
SIZE = 256          # frame width and height of the main-path render
AA = 2
SEED = 0
GLASS = "scenes/glass_sphere.ass"
GLASS_AA = 3
GLASS_CHECK = 64    # width and height of the glass frame held to the walk
GLASS_RR = 2        # roulette start of that frame (the JAX bench's)
PROFILE_SIZE = 128  # the profiled frames: one full tile at AA 2 or 3
GLASS_CPU = 12      # width and height of the glass CUDA vs CPU frames
SKIN = "scenes/skin_closeup.ass"
SKIN_CHECK = 64     # width and height of the skin frames held to the walk
SKIN_CPU = 64       # width and height of the skin CUDA vs CPU frames
DISNEY = "scenes/disney_spheres.ass"
DISNEY_AA = 3
DISNEY_CHECK = 64   # width and height of the Disney frame held to the walk
DISNEY_CPU = 32     # width and height of the Disney CUDA vs CPU frames
TEXTURED = "scenes/textured_disk.ass"
TEXTURED_AA = 3
TEXTURED_CHECK = 64  # width and height of the textured frame held to the walk
TEXTURED_CPU = 32   # width and height of the textured CUDA vs CPU frames
CLI_TILE = 8192     # `cli render`'s and `cli test`'s --tile default
CLI_AOVS = ["direct_diffuse", "direct_specular", "indirect_diffuse",
            "indirect_specular", "refraction", "sss"]
# the textured scene's polymeshes in trace set "setA" (phase 21)
TRACE_SET_MESHES = ("floor", "inv_panel", "bump_ball", "dsy_ball")
# bench.py's Disney BSDF step: a material grid of this size, SPP samples a
# pixel (each a specular and a diffuse BSDF sample)
STEP_W, STEP_H, STEP_SPP = 1920, 1080, 8
JWALK_RAYS = 262144
SOUP = 12000       # triangles: tables too large for shared memory
REPLACES = {
    "rls_nearest": "rlshaders_tpu/ops/intersect_pallas.py:342",
    "rls_occluded": "rlshaders_tpu/ops/intersect_pallas.py:455",
}
SOURCE = "rlshaders_tpu_torch/ops/csrc/intersect.cu"
# CUDA vs CPU frame (phase 5): float32 arithmetic differs between the
# devices (CUDA divides by a scalar through its reciprocal, transcendental
# functions differ in the last bits, the splat sums in atomic order), so a
# few samples take another branch at triangle edges and horizons. Nearly
# all pixels agree closely and the frame means agree.
PIX_TOL = 1e-3        # abs, per channel
PIX_FRAC = 0.98       # share of pixels within PIX_TOL
MEAN_RTOL = 2e-3      # frame mean, relative

# The bound of a kernel (the least time the card could take for the work):
# the larger of the bytes it must move over the H100's HBM rate and its
# float operations over the H100's float32 rate outside the tensor cores.
# Bytes: each output written once (nearest: t, tri, u, v, 16 B; occluded:
# 1 B); each live ray's o, d, t_max and exclude (32 B) read once, but only
# the 4 B of t_max of a dead lane (t_max <= 0), since the kernels read the
# rest inside `if (tm > 0)`; and the tree and triangle tables read once.
# The live count is the plain walk's (`counts["rays"]`). Operations: the
# slab tests and triangle
# tests the plain walk makes for these rays (accel/bvh.py `counts`), times
# the float operations of each in ops/csrc/intersect.cu, counting every
# add, multiply, min, max, abs, compare and reciprocal as one.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_RAY = 9       # inv_dir: abs, compare, reciprocal per axis
OPS_PER_BOX = 25      # box_hit: 6 sub, 6 mul, 11 min/max, 2 compares
OPS_PER_TRI = 53      # tri_test: Moller-Trumbore and its 6 hit compares
OUT_BYTES = {"rls_nearest": 16, "rls_occluded": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (after one warm call)."""
    fn()
    return events_ms(fn, reps)


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, CUDA events, no warm
    call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(run, reps: int) -> float:
    """Device milliseconds of one call of `run` (a pass of kernel
    launches): the pass captured in one CUDA graph, its replays timed with
    CUDA events, so the launches' host time is paid once, at capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


def profiled_ms(run, key: str) -> float:
    """torch.profiler's device milliseconds of the kernels whose name holds
    `key`, over one eager call of `run`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(r.self_device_time_total for r in prof.key_averages()
               if key in r.key) / 1e3


def capture_queries(scene, accel, wavefront, tracemod, **render_kw):
    """Render one frame on the card, recording the inputs of every ray
    query it makes."""
    calls = []
    real_nearest, real_occluded = tracemod.nearest, tracemod.occluded

    def nearest(acc, o, d, vis_mask, exclude_tri=None, t_eps=1e-4,
                t_max=None):
        r = o.shape[0]
        tm = (torch.full((r,), 1e30, device=o.device) if t_max is None
              else t_max)
        ex = (torch.full((r,), -1, dtype=torch.int32, device=o.device)
              if exclude_tri is None else exclude_tri.to(torch.int32))
        calls.append(("rls_nearest", o.clone(), d.clone(), tm.clone(),
                      ex.clone(), vis_mask))
        return real_nearest(acc, o, d, vis_mask, exclude_tri, t_eps, t_max)

    def occluded(acc, o, d, t_max, vis_mask, exclude_tri=None, t_eps=1e-4):
        r = o.shape[0]
        ex = (torch.full((r,), -1, dtype=torch.int32, device=o.device)
              if exclude_tri is None else exclude_tri.to(torch.int32))
        calls.append(("rls_occluded", o.clone(), d.clone(), t_max.clone(),
                      ex.clone(), vis_mask))
        return real_occluded(acc, o, d, t_max, vis_mask, exclude_tri, t_eps)

    tracemod.nearest, tracemod.occluded = nearest, occluded
    try:
        wavefront.render(scene, accel, seed=SEED, **render_kw)
    finally:
        tracemod.nearest, tracemod.occluded = real_nearest, real_occluded
    return calls


def random_queries(accel, n: int, seed: int):
    """Random rays through the scene's bounds: a tenth dead (t_max <= 0),
    a third excluding a random triangle, and each visibility bit."""
    rng = np.random.default_rng(seed)
    lo = accel.tree.bbox_min[0].cpu().numpy()
    hi = accel.tree.bbox_max[0].cpu().numpy()
    span = hi - lo
    o = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a few axis-aligned directions with signed zeros
    d[:64] = 0.0
    d[:64, 1] = -1.0
    d[:32, 0] = -0.0
    t_max = rng.uniform(0.5, 20.0, n)
    t_max[rng.random(n) < 0.1] = rng.choice([0.0, -1.0])
    t_max[rng.random(n) < 0.3] = 1e30
    n_tri = accel.tree.tri_order.shape[0]
    ex = np.where(rng.random(n) < 0.3, rng.integers(0, n_tri, n), -1)
    tens = (torch.tensor(o, dtype=torch.float32, device=DEVICE),
            torch.tensor(d, dtype=torch.float32, device=DEVICE),
            torch.tensor(t_max, dtype=torch.float32, device=DEVICE),
            torch.tensor(ex, dtype=torch.int32, device=DEVICE))
    out = []
    for bit in range(8):
        for name in ("rls_nearest", "rls_occluded"):
            out.append((name, *tens, 1 << bit))
    return out


def soup_accel(tracemod, t: int, seed: int = 8):
    """A random soup of t small triangles on the card, random visibility
    bits and opacity."""
    rs = np.random.default_rng(seed)
    geom = types.SimpleNamespace(
        v0=rs.uniform(-1, 1, (t, 3)), e1=rs.uniform(-0.05, 0.05, (t, 3)),
        e2=rs.uniform(-0.05, 0.05, (t, 3)),
        visibility=rs.integers(1, 256, t), opaque=rs.random(t) < 0.7)
    dtypes = {"visibility": torch.int32, "opaque": torch.bool}
    return tracemod.build(types.SimpleNamespace(**{
        k: torch.tensor(v, dtype=dtypes.get(k, torch.float32), device=DEVICE)
        for k, v in vars(geom).items()}))


def compare(accel, calls, bvh, kernels):
    """Run kernel and plain version on each captured query; returns per
    kernel [mismatching rays, rays, max abs error, the plain walk's work
    counts]. The walk counts its work here, so it is not timed here."""
    res = {k: [0, 0, 0.0, {}] for k in REPLACES}
    for name, o, d, tm, ex, vis in calls:
        counts = res[name][3]
        if name == "rls_nearest":
            hk = kernels.nearest(accel.packed, o, d, tm, ex, vis)
            hp = bvh.intersect(accel.tree, accel.tris, o, d, tm, ex, vis,
                               counts=counts)
            bad = ((hk.tri != hp.tri) | (hk.t != hp.t) | (hk.u != hp.u)
                   | (hk.v != hp.v))
            hit = hp.tri >= 0
            err = max(float((hk.t - hp.t)[hit].abs().max()) if hit.any()
                      else 0.0,
                      float((hk.u - hp.u).abs().max()),
                      float((hk.v - hp.v).abs().max()))
        else:
            bk = kernels.occluded(accel.packed, o, d, tm, ex, vis)
            bp = bvh.occluded(accel.tree, accel.tris, o, d, tm, ex, vis,
                              counts=counts)
            bad = bk != bp
            err = float(bad.any())
        r = res[name]
        r[0] += int(bad.sum())
        r[1] += o.shape[0]
        r[2] = max(r[2], err)
    return res


def table_bytes(accel) -> int:
    p = accel.packed
    return p.nodes.numel() * 4 + p.tris.numel() * 4


def bound(name: str, rays: int, counts: dict, accel) -> dict:
    """The kernel's bound for `rays` rays whose walk did `counts`."""
    n_nodes = accel.tree.first.shape[0]
    n_tris = accel.tree.tri_order.shape[0]
    table_bytes = n_nodes * (24 + 12) + n_tris * (36 + 4 + 4 + 1)
    live = counts["rays"]
    nbytes = (live * (32 + OUT_BYTES[name])
              + (rays - live) * (4 + OUT_BYTES[name]) + table_bytes)
    ops = (OPS_PER_RAY * live
           + OPS_PER_BOX * counts.get("boxes", 0)
           + OPS_PER_TRI * counts.get("tris", 0))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "byte_ms": byte_ms, "op_ms": op_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def pair(name: str, kernels, bvh, accel):
    """(kernel wrapper, plain version) of a kernel on accel's tables, each
    a function of (o, d, t_max, exclude, vis_mask)."""
    if name == "rls_nearest":
        return (partial(kernels.nearest, accel.packed),
                partial(bvh.intersect, accel.tree, accel.tris))
    return (partial(kernels.occluded, accel.packed),
            partial(bvh.occluded, accel.tree, accel.tris))


def run_all(fn, queries) -> None:
    for q in queries:
        fn(*q)


def kernel_ms(kern, queries, reps: int) -> tuple:
    """(device_ms, call_ms) of one pass of the kernel over queries."""
    run = partial(run_all, kern, queries)
    return device_ms(run, reps), cuda_ms(run, reps)


def time_kernels(accel, calls, bvh, kernels):
    """Per kernel: (device ms, call ms, plain ms, rays, launches) for all
    of the frame's queries of that kernel, run back to back."""
    out = {}
    for name in REPLACES:
        mine = [c[1:] for c in calls if c[0] == name]
        kern, walk = pair(name, kernels, bvh, accel)
        # plain, kernel, kernel, plain: clocks drift less across a pair
        p1 = cuda_ms(lambda: run_all(walk, mine), 2)
        d1, c1 = kernel_ms(kern, mine, 10)
        d2, c2 = kernel_ms(kern, mine, 10)
        p2 = cuda_ms(lambda: run_all(walk, mine), 2)
        out[name] = ((d1 + d2) / 2, (c1 + c2) / 2, (p1 + p2) / 2,
                     sum(c[0].shape[0] for c in mine), len(mine))
    return out


def query_mix(calls, name: str) -> str:
    """The rays of a kernel's queries: dead (t_max <= 0), with a finite
    t_max, with an exclude."""
    mine = [c for c in calls if c[0] == name]
    dead = sum(int((c[3] <= 0).sum()) for c in mine)
    finite = sum(int(((c[3] > 0) & (c[3] < 1e29)).sum()) for c in mine)
    excl = sum(int((c[4] >= 0).sum()) for c in mine)
    return (f"{len(mine)} queries ({dead} rays dead with t_max <= 0, "
            f"{finite} with a finite t_max, {excl} with an exclude)")


def dead_lanes(calls, name: str) -> dict:
    """The dead lanes (t_max <= 0) of a kernel's queries: launches with no
    live lane, and how the live lanes fall into 32-lane groups."""
    out = {"launches": 0, "no_live": 0, "rays": 0, "live": 0, "groups": 0,
           "live_groups": 0}
    for c in calls:
        if c[0] != name:
            continue
        live = c[3] > 0
        pad = torch.zeros((-live.numel()) % 32, dtype=torch.bool,
                          device=live.device)
        groups = torch.cat([live, pad]).view(-1, 32).any(1)
        n_live = int(live.sum())
        out["launches"] += 1
        out["no_live"] += int(n_live == 0)
        out["rays"] += live.numel()
        out["live"] += n_live
        out["groups"] += groups.numel()
        out["live_groups"] += int(groups.sum())
    return out


def reset(kernels) -> None:
    for counts in (kernels.LAUNCHES, kernels.PATH_LAUNCHES):
        for k in counts:
            counts[k] = 0


def path_launches(kernels) -> dict:
    return {k: n for k, n in kernels.PATH_LAUNCHES.items() if n}


def barred_render(wavefront, bvh, scene, accel, **kw):
    """One timed render with the plain walk barred: (output, seconds)."""
    def barred(*args, **kwargs):
        raise AssertionError("the plain BVH walk was called on the card")

    real = bvh.intersect, bvh.occluded
    bvh.intersect = bvh.occluded = barred
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wavefront.render(scene, accel, seed=SEED, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        bvh.intersect, bvh.occluded = real


def check_planes(out, size) -> None:
    for k, v in out.items():
        if k == "__stats__":
            continue
        if tuple(v.shape) != (size, size, 3):
            raise AssertionError(f"{k} has shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite values in {k}")
    if not float(out["RGBA"].mean()) > 0.0:
        raise AssertionError("black frame")


def cuda_vs_cpu(wavefront, tag, scenes, tol, **kw):
    """Render on the card and on the CPU and compare every plane."""
    pix_tol, pix_frac, mean_rtol = tol
    small = {}
    for dev, (sc, ac) in scenes.items():
        o = wavefront.render(sc, ac, seed=SEED, **kw)
        small[dev] = {k: v.cpu().numpy() for k, v in o.items()
                      if k != "__stats__"}
    for k in small["cpu"]:
        a, b = small["cuda"][k], small["cpu"][k]
        within = float((np.abs(a - b).max(-1) <= pix_tol).mean())
        mean_err = abs(float(a.mean()) - float(b.mean())) / max(
            abs(float(b.mean())), 1e-6)
        log(f"[{tag}] {k}: share of pixels within {pix_tol}: {within:.4f}, "
            f"mean cuda {a.mean():.6f} cpu {b.mean():.6f} (rel "
            f"{mean_err:.3g})")
        if within < pix_frac or mean_err > mean_rtol:
            raise AssertionError(f"{k}: CUDA and CPU frames disagree")


def profile_frame(wavefront, tag, scene, accel, **kw) -> None:
    """Device time of one frame by kernel (torch.profiler): prints the
    device busy share and the largest kernels. Only the card's activity is
    recorded: with the host's on too, a kernel's time is listed under its
    aten op as well as under its own name, and a sum over the rows counts
    it twice."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wavefront.render(scene, accel, seed=SEED, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev = [(r.self_device_time_total, r.count, r.key)
           for r in prof.key_averages() if r.self_device_time_total > 0]
    total = sum(t for t, _, _ in dev) / 1e3
    kernels = sum(n for _, n, key in dev if not key.startswith("Mem"))
    log(f"[{tag}] profile: wall {wall:.4f} s (profiled), device time "
        f"{total:.4f} ms, busy share {total / 1e3 / wall:.4f}, kernels "
        f"run {kernels}; reading the profile took "
        f"{time.perf_counter() - t1:.1f} s")
    for t, n, key in sorted(dev, reverse=True)[:8]:
        log(f"[{tag}]   {t / 1e3:10.4f} ms  {n:8d} x  {key[:110]}")


def jwalk_rays(scene, accel, tracemod, rng, cameramod):
    """tools/trace_decomp2.py's two ray sets on the scene: coherent camera
    rays (256x256, AA 2) and cosine-bounce rays about +z from their hits,
    offset 1e-3 along the new direction (misses bounce from t = 1e30)."""
    n = JWALK_RAYS
    key = rng.PRNGKey(0)
    rays = cameramod.generate(scene.camera, key, 2, 256, 256)
    o, d = rays.origin[:n].contiguous(), rays.direction[:n].contiguous()
    hit = tracemod.nearest(accel, o, d, vis_mask=1)
    po = o + d * hit.t[:, None]
    u = rng.uniform(key, (n, 2), o.device)
    r = torch.sqrt(u[:, 0])
    phi = 2 * np.pi * u[:, 1]
    d2 = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                      torch.sqrt(1.0 - u[:, 0])], -1)
    return {"coherent": (o, d), "incoherent": ((po + 1e-3 * d2), d2)}


def disney_step(disney, rng, V3, w: int, h: int, spp: int,
                clearcoat: float, device):
    """bench.py's `make_scene_batch` and `step` through the port's
    bsdf/disney.py: returns (step, draws), functions of a key. `step`
    draws (spp, w*h, 4) uniforms as bench.py does (rng.uniform is
    jax.random.uniform bit for bit) and returns the mean estimate V3;
    `draws` is its draw alone."""
    n = w * h
    i = torch.arange(n, device=device)
    x = (i % w).to(torch.float32) / w
    y = (i // w).to(torch.float32) / h

    def full(v):
        return torch.full((n,), v, device=device)

    params = disney.make_params(
        base_color=V3(0.7 * torch.ones_like(x), 0.3 + 0.4 * x, 0.2 + 0.6 * y),
        roughness=0.05 + 0.9 * x, metallic=y, specular=full(0.8),
        specular_tint=full(0.3), anisotropic=0.3 * x, sheen=0.5 * y,
        sheen_tint=full(0.5), clearcoat=full(clearcoat),
        clearcoat_gloss=full(0.7), subsurface=full(0.2))
    t = 0.3 + 0.5 * y
    wo = V3(torch.sqrt(1.0 - t * t), torch.zeros_like(t), t)
    cc = disney.has_clearcoat(params)

    def draws(key):
        return rng.uniform(key, (spp, n, 4), device)

    def step(key):
        u = draws(key)
        zero = torch.zeros(n, device=device)
        acc = V3(zero, zero, zero)
        for s in range(spp):
            us = u[s]
            wi_s = disney.sample_specular(params, wo, us[:, 0], us[:, 1], cc)
            f_s = disney.eval_specular_cos(params, wo, wi_s, cc)
            p_s = disney.pdf_specular(params, wo, wi_s, cc)
            p_sd = disney.pdf_diffuse(params, wo, wi_s)
            w_s = p_s / torch.clamp_min(p_s + p_sd, 1e-9)
            wi_d = disney.sample_diffuse(params, wo, us[:, 2], us[:, 3])
            f_d = disney.eval_diffuse_cos(params, wo, wi_d)
            p_d = disney.pdf_diffuse(params, wo, wi_d)
            p_ds = disney.pdf_specular(params, wo, wi_d, cc)
            w_d = p_d / torch.clamp_min(p_d + p_ds, 1e-9)
            acc = acc + (f_s * (w_s / torch.clamp_min(p_s, 1e-9))
                         + f_d * (w_d / torch.clamp_min(p_d, 1e-9)))
        return acc * (1.0 / spp)

    return step, draws


def check_shape(t_check: str, shape: str, scene, accel, aa: int,
                check: int):
    """Both kernels held to the plain walk on every query of a check x
    check, AA `aa` frame of `scene` rendered through `accel`, and timed on
    those queries (the `shape`): the compare results, the times and the
    bounds, per kernel. Raises on a mismatch."""
    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels

    t0 = time.perf_counter()
    calls = capture_queries(scene, accel, wavefront, tracemod,
                            aa_samples=aa, xres=check, yres=check)
    reset(kernels)
    res = compare(accel, calls, bvh, kernels)
    log(f"[{t_check}] captured and compared in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{accel.tree.tri_order.shape[0]} triangles, "
        f"{accel.tree.first.shape[0]} nodes, tables {table_bytes(accel)} B "
        f"({accel.packed.path} path): "
        f"launches by table path {path_launches(kernels)}")
    for k in REPLACES:
        dl = dead_lanes(calls, k)
        log(f"[{t_check}] {k}: {res[k][1]} rays in {query_mix(calls, k)}, "
            f"{res[k][0]} mismatches, max abs err {res[k][2]:.3g}; "
            f"{dl['no_live']} launches with no live lane, live share "
            f"{dl['live'] / dl['rays']:.4f}")
        if res[k][0]:
            raise AssertionError(f"{k} disagrees with its plain version on "
                                 f"the {shape} frame")
    times, bounds = {}, {}
    for k in REPLACES:
        mine = [c[1:] for c in calls if c[0] == k]
        kern, walk = pair(k, kernels, bvh, accel)
        p1 = events_ms(lambda: run_all(walk, mine), 1)
        dm, cm = kernel_ms(kern, mine, 5)
        p2 = events_ms(lambda: run_all(walk, mine), 1)
        r = sum(c[0].shape[0] for c in mine)
        times[k] = (dm, cm, (p1 + p2) / 2, r, len(mine))
        b = bounds[k] = bound(k, r, res[k][3], accel)
        walks = res[k][3]
        working = sum(1 for c in mine if bool((c[2] > 0).any()))
        log(f"[{t_check}] {k}: all {r} rays of the {shape} frame's "
            f"{len(mine)} queries: device {dm:.4f} ms, call {cm:.4f} ms "
            f"({dm / len(mine) * 1e3:.2f} / {cm / len(mine) * 1e3:.2f} us "
            f"per launch), plain {(p1 + p2) / 2:.4f} ms; walk {walks}, the "
            f"longest walk of a launch with a live lane "
            f"{walks['steps'] / max(working, 1):.2f} on average; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes "
            f"{b['byte_ms']:.4f} ms, operations {b['op_ms']:.4f} ms), share "
            f"of device time {b['bound_ms'] / dm:.4f}")
    del calls
    log(f"[{t_check}] phase {time.perf_counter() - t0:.1f} s")
    return res, times, bounds


def scene_phases(tags, path: str, aa: int, check: int, cpu_size: int,
                 shape: str, lit_plane: str) -> dict:
    """Three phases on one scene file (tags: their three numbers): both
    kernels held to the plain walk on every query of a check x check, AA
    `aa` frame, and timed there (the `shape`); the frame at the scene's
    own options through the kernels (counts reset, plain walk barred),
    every plane checked and `lit_plane` above 0, with one profiled tile;
    the frame on the card and on the CPU at cpu_size, AA 2. Returns what
    the JSON line reads: per kernel the compare results, the times and
    bound of the shape, and the frame's launches."""
    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build

    t_check, t_path, t_cpu = (str(t) for t in tags)
    # ---- every query of a check x check frame ----
    scene = build(path)
    accel = tracemod.build(scene.geometry)
    res, times, bounds = check_shape(t_check, shape, scene, accel, aa, check)

    # ---- the path: the scene at its own options ----
    t0 = time.perf_counter()
    reset(kernels)
    out, dt = barred_render(wavefront, bvh, scene, accel)
    launches = dict(kernels.LAUNCHES)
    o = scene.options
    check_planes(out, o.xres)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the {shape} "
                                 f"render")
    if not float(out[lit_plane].mean()) > 0.0:
        raise AssertionError(f"the {lit_plane} AOV is black")
    tex = scene.textures
    log(f"[{t_path}] texture table: {texture_bytes(tex)} B "
        f"({tex.data.shape[0]} texels, levels {tex.n_levels.tolist()}, "
        f"offsets and sizes included)")
    stats = out["__stats__"]
    rays = stats["nearest_rays"] + stats["shadow_rays"]
    means = {k: round(float(v.mean()), 6) for k, v in out.items()
             if k != "__stats__"}
    log(f"[{t_path}] {shape} {o.xres}x{o.yres} AA {o.aa_samples}: "
        f"{dt:.4f} s/frame, plane means {means}, all planes finite, "
        f"launches {launches}, by table path {path_launches(kernels)}, "
        f"nearest rays {stats['nearest_rays']}, shadow rays "
        f"{stats['shadow_rays']}, {rays / dt / 1e6:.3f} Mrays/s "
        f"(nearest+shadow)")
    del out
    profile_frame(wavefront, t_path, scene, accel, aa_samples=aa,
                  xres=PROFILE_SIZE, yres=PROFILE_SIZE)
    log(f"[{t_path}] phase {time.perf_counter() - t0:.1f} s")

    # ---- the frame on the card and on the CPU ----
    t0 = time.perf_counter()
    cscene = build(path, device="cpu")
    cuda_vs_cpu(wavefront, t_cpu, {
        "cuda": (scene, accel),
        "cpu": (cscene, tracemod.build(cscene.geometry))},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=cpu_size,
        yres=cpu_size)
    log(f"[{t_cpu}] phase {time.perf_counter() - t0:.1f} s")
    return {"compare": res, "times": times, "bounds": bounds,
            "launches": launches}


def disney_step_phase(card: str) -> dict:
    """Phase 16: bench.py's Disney step through the port's bsdf/disney.py,
    clearcoat 0.8 and 0; returns Gsamples/s by clearcoat."""
    from rlshaders_tpu_torch.bsdf import disney
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.core.vec3 import V3

    t0 = time.perf_counter()
    rates = {}
    for cc in (0.8, 0.0):
        step, draws = disney_step(disney, rng, V3, STEP_W, STEP_H, STEP_SPP,
                                  cc, DEVICE)
        key = rng.stream(0)
        est = step(key)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(est.aos()).all()):
            raise AssertionError("the Disney step is not finite")
        keys = iter(range(1, 100))
        ms = events_ms(lambda: step(rng.fold(key, next(keys))), 3)
        draw_ms = events_ms(lambda: draws(rng.fold(key, next(keys))), 3)
        rate = STEP_W * STEP_H * STEP_SPP * 2 / (ms / 1e3) / 1e9
        rates[cc] = rate
        log(f"[16] Disney step {STEP_W}x{STEP_H} SPP {STEP_SPP} clearcoat "
            f"{cc}: {ms:.4f} ms a step (of which the draws {draw_ms:.4f} "
            f"ms), {rate:.4f} Gsamples/s, mean estimate "
            f"{[round(float(c.mean()), 6) for c in est]}; {card}")
        del step, draws, est
    log(f"[16] phase {time.perf_counter() - t0:.1f} s")
    return rates


def texture_bytes(tex) -> int:
    return sum(t.numel() * t.element_size() for t in tex)


def trace_set_text(path: str) -> str:
    """The scene at `path` with `trace_sets "setA"` on the polymeshes of
    TRACE_SET_MESHES (about half of them, the floor among them)."""
    with open(path) as f:
        src = f.read()
    for name in TRACE_SET_MESHES:
        head = f"polymesh\n{{\n name {name}\n"
        if head not in src:
            raise AssertionError(f"no polymesh {name} in {path}")
        src = src.replace(head, head + ' trace_sets "setA"\n')
    return src


def cli_phase(card: str) -> dict:
    """Phase 20: `cli render` of scenes/textured_disk.ass at its own
    options, two passes, AOVs and the profile; every EXR read back; the
    beauty against the mean of two direct renders; what the command adds
    around `render`, piece by piece. Returns the launches of the CLI run
    and the textured frame at seed 0 (phase 22's golden)."""
    from rlshaders_tpu_torch import cli
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.io import exr
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.exr")
        reset(kernels)
        t1 = time.perf_counter()
        rc = cli.main(["render", TEXTURED, "-o", out, "--passes", "2",
                       "--aovs", "--profile"])
        wall = time.perf_counter() - t1
        launches = dict(kernels.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli render returned {rc}")
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{k} was not launched by cli render")
        files = sorted(f for f in os.listdir(tmp) if f.endswith(".exr"))
        want = ["cli.exr"] + [f"cli.{n}.exr" for n in CLI_AOVS]
        if files != sorted(want):
            raise AssertionError(f"cli render wrote {files}")
        planes = {f: exr.read_rgb(os.path.join(tmp, f)) for f in files}
        trace_mb = os.path.getsize(os.path.join(tmp, "cli_trace",
                                                "trace.json")) / 1e6
    scene = build(TEXTURED)
    size = (scene.options.yres, scene.options.xres, 3)
    for f, img in planes.items():
        if img.shape != size or not np.isfinite(img).all():
            raise AssertionError(f"{f}: shape {img.shape} or not finite")
    log(f"[20] cli render: {wall:.4f} s in cli.main (build, two profiled "
        f"passes, trace export, EXR writes), launches {launches}, trace "
        f"{trace_mb:.1f} MB; {card}")

    accel = tracemod.build(scene.geometry)
    passes = []
    for seed in (0, 7919):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        o = wavefront.render(scene, accel, seed=seed, tile_pixels=CLI_TILE)
        torch.cuda.synchronize()
        passes.append((o, time.perf_counter() - t1))
    (a, ta), (b, tb) = passes
    mean = ((a["RGBA"].double() + b["RGBA"].double()) / 2).float()
    mean = mean.cpu().numpy()
    half = np.spacing(np.abs(mean).astype(np.float16)).astype(np.float32)
    err = np.abs(planes["cli.exr"] - mean)
    log(f"[20] direct renders at seeds 0 and 7919: {ta:.4f} s and "
        f"{tb:.4f} s; the CLI's RGBA against their float64 mean: max abs "
        f"err {err.max():.3g}, pixels beyond one half-float spacing "
        f"{int((err > half).sum())}")
    if (err > half).any():
        raise AssertionError("the CLI's beauty is not the mean of its "
                             "passes")

    # what cli render adds around render, on this run's planes
    names = ["RGBA"] + CLI_AOVS
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acc = {k: a[k].double() for k in names}
    for k in names:
        acc[k] += b[k]
    host = {k: (v / 2).float().cpu().numpy() for k, v in acc.items()}
    t_mean = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        for i in range(2):
            exr.write_rgb(os.path.join(tmp, f"flush{i}.exr"),
                          (acc["RGBA"] / (i + 1)).float().cpu().numpy())
        for k, v in host.items():
            exr.write_rgb(os.path.join(tmp, f"{k}.exr"), v)
        t_exr = time.perf_counter() - t1
    nbytes = sum(v.nbytes for v in host.values())
    log(f"[20] around render: the float64 sum and mean of {len(names)} "
        f"planes and their host copy ({nbytes} B) {t_mean * 1e3:.4f} ms; "
        f"{len(names) + 2} EXR writes (two flushes) {t_exr * 1e3:.4f} ms; "
        f"{card}")
    log(f"[20] phase {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "golden": a["RGBA"].cpu().numpy()}


def trace_set_phase() -> dict:
    """Phase 21: both kernels held to the plain walk on every query of a
    64x64, AA 3 frame of the textured scene rendered through each subset
    accel of its trace set (inclusive, exclusive), and timed there."""
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.scene.build import build_text

    t0 = time.perf_counter()
    scene = build_text(trace_set_text(TEXTURED),
                       base_dir=os.path.dirname(TEXTURED))
    if scene.trace_set_names != ["setA"]:
        raise AssertionError(f"trace sets {scene.trace_set_names}")
    members = int(((scene.geometry.visibility & (1 << 8)) != 0).sum())
    log(f"[21] trace set setA: {members} of {scene.geometry.v0.shape[0]} "
        f"triangles, meshes {list(TRACE_SET_MESHES)}")
    out = {}
    for inclusive in (True, False):
        tag = "inclusive" if inclusive else "exclusive"
        accel = tracemod.build_trace_set(scene.geometry, 0, inclusive)
        log(f"[21] {tag}: {accel.tree.tri_order.shape[0]} triangles, "
            f"{accel.tree.first.shape[0]} nodes, {accel.packed.path} path")
        out[tag] = check_shape("21", f"trace_sets_{tag}", scene, accel,
                               TEXTURED_AA, TEXTURED_CHECK)
    log(f"[21] phase {time.perf_counter() - t0:.1f} s")
    return out


def suite_phase(golden_textured: np.ndarray) -> None:
    """Phase 22: `cli test`, `list` and `display` on a suite written to a
    temporary directory: 0001 the Disney spheres and 0002 the textured
    scene, each with the port's own card render at seed 0 as its golden
    (both pass), and 0003 the textured scene with the Disney golden (must
    fail)."""
    from rlshaders_tpu_torch import cli
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.io import exr
    from rlshaders_tpu_torch.scene.build import build
    from rlshaders_tpu_torch.scene.texture import decode_png

    t0 = time.perf_counter()
    scene = build(DISNEY)
    o = wavefront.render(scene, tracemod.build(scene.geometry), seed=0,
                         tile_pixels=CLI_TILE)
    golden_disney = o["RGBA"].cpu().numpy()
    del o, scene
    cases = {"0001": (DISNEY, golden_disney, "disney spheres"),
             "0002": (TEXTURED, golden_textured, "textured disk"),
             "0003": (TEXTURED, golden_disney,
                      "textured with the wrong golden")}
    with tempfile.TemporaryDirectory() as tmp:
        suite = os.path.join(tmp, "suite")
        for case, (path, golden, desc) in cases.items():
            if cli.main(["mkdir", "--suite", suite, "--desc", desc]) != 0:
                raise AssertionError(f"cli mkdir failed for {case}")
            data = os.path.join(suite, "mtoa", case, "data")
            shutil.copy(path, data)
            if path == TEXTURED:
                shutil.copytree(os.path.join(os.path.dirname(TEXTURED),
                                             "data"),
                                os.path.join(data, "data"))
            exr.write_rgb(os.path.join(suite, "mtoa", case, "ref",
                                       "ref.exr"), golden)
        listing = io.StringIO()
        with contextlib.redirect_stdout(listing):
            cli.main(["list", "--suite", suite])
        want = [f"{c}  {d}" for c, (_, _, d) in cases.items()]
        if listing.getvalue().splitlines() != want:
            raise AssertionError(f"cli list printed {listing.getvalue()!r}")
        report = os.path.join(tmp, "report.csv")
        with contextlib.chdir(tmp):
            rc = cli.main(["test", "--suite", suite, "--report", report,
                           "--save"])
        with open(report) as f:
            rows = [r.split(",") for r in f.read().splitlines()[1:]]
        log(f"[22] cli test rc {rc}: " + "; ".join(
            f"{r[0]} {r[2]} masked rmse {r[3]} full {r[4]} {r[7]} s"
            for r in rows))
        status = [(r[0], r[2]) for r in rows]
        if status != [("0001", "OK"), ("0002", "OK"), ("0003", "FAIL")]:
            raise AssertionError(f"cli test reported {status}")
        if rc != 1 or max(float(r[4]) for r in rows[:2]) >= 1e-3:
            raise AssertionError("cli test: rc or rmse off")
        for case in cases:
            shutil.copy(os.path.join(tmp, "out", f"test_{case}.exr"),
                        os.path.join(suite, "mtoa", case, "ref",
                                     "test_tpu.exr"))
        sheets = os.path.join(tmp, "display")
        if cli.main(["display", "--suite", suite, "--outdir", sheets]) != 0:
            raise AssertionError("cli display failed")
        for case in cases:
            with open(os.path.join(sheets, f"{case}.png"), "rb") as f:
                img = decode_png(f.read())
            h, w = golden_textured.shape[:2]
            if img.shape != (h, 3 * w, 3) or not img.any():
                raise AssertionError(f"display sheet {case}: {img.shape}")
        log(f"[22] cli list, test and display: the listing, the three rows "
            f"and three decodable {h}x{3 * w} sheets as expected")
    log(f"[22] phase {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 1
    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.integrator import camera as cameramod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build
    from rlshaders_tpu_torch.scene.demo import demo_scene

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name} | nvidia-smi: {card} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = kernels.build()
    log(f"[2] built {lib} in {time.perf_counter() - t0:.2f} s")

    # ---- demo: kernels vs the plain walk on every query of a frame ----
    t0 = time.perf_counter()
    scene, accel = demo_scene(skin=False)
    calls = capture_queries(scene, accel, wavefront, tracemod,
                            aa_samples=AA, xres=SIZE, yres=SIZE)
    reset(kernels)
    frame = compare(accel, calls, bvh, kernels)
    rand = compare(accel, random_queries(accel, 100_000, 7), bvh, kernels)
    log(f"[3] demo tables {table_bytes(accel)} B: launches by table path "
        f"{path_launches(kernels)}")
    for k in REPLACES:
        live = sum(int((c[3] > 0).sum()) for c in calls if c[0] == k)
        log(f"[3] {k}: frame queries {frame[k][1]} rays ({live} live, the "
            f"rest t_max <= 0), {frame[k][0]} "
            f"mismatches; random queries {rand[k][1]} rays, {rand[k][0]} "
            f"mismatches; max abs err {max(frame[k][2], rand[k][2]):.3g}")
        if frame[k][0] or rand[k][0]:
            raise AssertionError(f"{k} disagrees with its plain version")
    sacc = soup_accel(tracemod, SOUP)
    reset(kernels)
    soup = compare(sacc, random_queries(sacc, 20_000, 11), bvh, kernels)
    took = path_launches(kernels)
    log(f"[3] {SOUP}-triangle soup, tables {table_bytes(sacc)} B: launches "
        f"by table path {took}; " + "; ".join(
            f"{k} {soup[k][1]} rays, {soup[k][0]} mismatches"
            for k in REPLACES))
    if set(took) != {"global"}:
        raise AssertionError(f"the {SOUP}-triangle soup took {took}, "
                             f"expected the global path")
    if any(soup[k][0] for k in REPLACES):
        raise AssertionError(f"a kernel disagrees with its plain version "
                             f"on the {SOUP}-triangle soup")
    del sacc
    times = time_kernels(accel, calls, bvh, kernels)
    demo_bound = {}
    for k, (dm, cm, pm, r, n) in times.items():
        b = demo_bound[k] = bound(k, r, frame[k][3], accel)
        log(f"[3] {k}: all {r} rays of the frame's {n} queries: device "
            f"{dm:.4f} ms, call {cm:.4f} ms ({dm / n * 1e3:.2f} / "
            f"{cm / n * 1e3:.2f} us per launch), plain {pm:.4f} ms; walk "
            f"{frame[k][3]}; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"(bytes {b['byte_ms']:.4f} ms, operations {b['op_ms']:.4f} ms), "
            f"share of device time {b['bound_ms'] / dm:.4f}")
    del calls
    log(f"[3] phase {time.perf_counter() - t0:.1f} s")

    # ---- the demo path: a timed 256x256 frame through the kernels ----
    reset(kernels)
    out, dt = barred_render(wavefront, bvh, scene, accel, aa_samples=AA,
                            xres=SIZE, yres=SIZE)
    demo_launches = dict(kernels.LAUNCHES)
    check_planes(out, SIZE)
    for k, n in demo_launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the demo render")
    stats = out["__stats__"]
    rays = stats["nearest_rays"] + stats["shadow_rays"]
    log(f"[4] {SIZE}x{SIZE} AA {AA}: {dt:.4f} s/frame, mean RGB "
        f"{float(out['RGBA'].mean()):.6f}, launches {demo_launches}, by "
        f"table path {path_launches(kernels)}, "
        f"nearest rays {stats['nearest_rays']}, shadow rays "
        f"{stats['shadow_rays']}, {rays / dt / 1e6:.3f} Mrays/s "
        f"(nearest+shadow)")

    t0 = time.perf_counter()
    cuda_vs_cpu(wavefront, "5", {
        "cuda": (scene, accel), "cpu": demo_scene(skin=False, device="cpu")},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=32, yres=32)
    log(f"[5] phase {time.perf_counter() - t0:.1f} s")

    # ---- glass: every query of a 64x64 frame with roulette-dead lanes ----
    t0 = time.perf_counter()
    gscene = build(GLASS)
    gaccel = tracemod.build(gscene.geometry)
    calls = capture_queries(gscene, gaccel, wavefront, tracemod,
                            aa_samples=GLASS_AA, xres=GLASS_CHECK,
                            yres=GLASS_CHECK, rr_refr_start=GLASS_RR)
    reset(kernels)
    glass = compare(gaccel, calls, bvh, kernels)
    log(f"[6] captured and compared in {time.perf_counter() - t0:.1f} s; "
        f"glass tables {table_bytes(gaccel)} B: launches by table path "
        f"{path_launches(kernels)}")
    for k in REPLACES:
        log(f"[6] {k}: {glass[k][1]} rays in {query_mix(calls, k)}, "
            f"{glass[k][0]} mismatches, max abs err {glass[k][2]:.3g}")
        if glass[k][0]:
            raise AssertionError(f"{k} disagrees with its plain version on "
                                 f"the glass frame")
        dl = dead_lanes(calls, k)
        log(f"[6] {k} dead lanes: {dl['no_live']} of {dl['launches']} "
            f"launches have no live lane; live share {dl['live'] / dl['rays']:.4f}; "
            f"32-lane groups with a live lane {dl['live_groups']} of "
            f"{dl['groups']} ({dl['live_groups'] / dl['groups']:.4f}), live "
            f"share inside them "
            f"{dl['live'] / max(32 * dl['live_groups'], 1):.4f}")
    gtimes, glass_bound = {}, {}
    for k in REPLACES:
        mine = [c[1:] for c in calls if c[0] == k]
        kern, _ = pair(k, kernels, bvh, gaccel)
        dm, cm = kernel_ms(kern, mine, 3)
        prof = profiled_ms(partial(run_all, kern, mine),
                           k[len("rls_"):] + "_kernel")
        r = sum(c[0].shape[0] for c in mine)
        gtimes[k] = (dm, cm, None, r, len(mine))
        b = glass_bound[k] = bound(k, r, glass[k][3], gaccel)
        walks = glass[k][3]
        working = sum(1 for c in mine if bool((c[2] > 0).any()))
        log(f"[6] {k}: all {r} rays of the glass frame's {len(mine)} "
            f"queries: device {dm:.4f} ms (torch.profiler's sum of the "
            f"kernel's launches {prof:.4f} ms), call {cm:.4f} ms "
            f"({dm / len(mine) * 1e3:.2f} / {cm / len(mine) * 1e3:.2f} us per "
            f"launch); walk {walks}: per live ray "
            f"{walks['boxes'] / walks['rays']:.2f} slab tests, the longest "
            f"walk of a launch with a live lane "
            f"{walks['steps'] / working:.2f} on average; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes "
            f"{b['byte_ms']:.4f} ms, operations {b['op_ms']:.4f} ms), share "
            f"of device time {b['bound_ms'] / dm:.4f}")
    del calls
    profile_frame(wavefront, "6", gscene, gaccel, aa_samples=GLASS_AA,
                  xres=PROFILE_SIZE, yres=PROFILE_SIZE)
    log(f"[6] phase {time.perf_counter() - t0:.1f} s")

    # ---- the glass path: a timed 256x256, AA 3 frame ----
    reset(kernels)
    gout, gdt = barred_render(wavefront, bvh, gscene, gaccel,
                              aa_samples=GLASS_AA, xres=SIZE, yres=SIZE)
    glass_launches = dict(kernels.LAUNCHES)
    check_planes(gout, SIZE)
    if glass_launches["rls_nearest"] <= 0:
        raise AssertionError("rls_nearest was not launched by the glass "
                             "render")
    refr = float(gout["refraction"].mean())
    if not refr > 0.0:
        raise AssertionError("the refraction AOV is black")
    gstats = gout["__stats__"]
    grays = gstats["nearest_rays"] + gstats["shadow_rays"]
    log(f"[7] glass {SIZE}x{SIZE} AA {GLASS_AA}: {gdt:.4f} s/frame, mean "
        f"RGB {float(gout['RGBA'].mean()):.6f}, refraction AOV mean "
        f"{refr:.6f}, all planes finite, launches {glass_launches}, by table "
        f"path {path_launches(kernels)}, "
        f"nearest rays {gstats['nearest_rays']} ({gstats['march_segments']} "
        f"shadow segments marched), shadow rays {gstats['shadow_rays']}, "
        f"{grays / gdt / 1e6:.3f} Mrays/s (nearest+shadow)")
    del gout

    # ---- j_walk: each kernel alone at the TPU tool's query shapes ----
    t0 = time.perf_counter()
    jsets = jwalk_rays(gscene, gaccel, tracemod, rng, cameramod)
    n = JWALK_RAYS
    tmax = torch.full((n,), 1e30, device=DEVICE)
    ex = torch.full((n,), -1, dtype=torch.int32, device=DEVICE)
    jwalk = {}
    for tag, (o, d) in jsets.items():
        for k in REPLACES:
            kern, walk = pair(k, kernels, bvh, gaccel)
            q = [(o, d, tmax, ex, 0xFF)]
            counts = {}
            walk(o, d, tmax, ex, 0xFF, counts=counts)
            dm, cm = kernel_ms(kern, q, 50)
            pms = cuda_ms(lambda: walk(o, d, tmax, ex, 0xFF), 1)
            b = bound(k, n, counts, gaccel)
            jwalk[(k, tag)] = (dm, cm, pms, b)
            log(f"[8] j_walk {tag} {k}: device {dm:.4f} ms "
                f"({n / dm / 1e3:.1f} Mrays/s), call {cm:.4f} ms, plain "
                f"{pms:.4f} ms; walk {counts}; byte bound "
                f"{b['byte_ms']:.4f} ms, operation bound {b['op_ms']:.4f} "
                f"ms, share of the larger ({b['bound_by']}) of device time "
                f"{b['bound_ms'] / dm:.4f}")
    log(f"[8] phase {time.perf_counter() - t0:.1f} s")

    # ---- the glass frame on the card and on the CPU ----
    t0 = time.perf_counter()
    cscene = build(GLASS, device="cpu")
    cuda_vs_cpu(wavefront, "9", {
        "cuda": (gscene, gaccel),
        "cpu": (cscene, tracemod.build(cscene.geometry))},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=GLASS_CPU,
        yres=GLASS_CPU)
    log(f"[9] phase {time.perf_counter() - t0:.1f} s")

    # ---- skin: every query of 64x64 frames of the SSS probe stage ----
    t0 = time.perf_counter()
    sscene = build(SKIN)
    saccel = tracemod.build(sscene.geometry)
    calls = capture_queries(sscene, saccel, wavefront, tracemod,
                            aa_samples=AA, xres=SKIN_CHECK, yres=SKIN_CHECK)
    dscene, daccel = demo_scene()
    dcalls = capture_queries(dscene, daccel, wavefront, tracemod,
                             aa_samples=AA, xres=SKIN_CHECK, yres=SKIN_CHECK)
    reset(kernels)
    skin = compare(saccel, calls, bvh, kernels)
    skin_demo = compare(daccel, dcalls, bvh, kernels)
    log(f"[10] captured and compared in {time.perf_counter() - t0:.1f} s; "
        f"skin tables {table_bytes(saccel)} B, demo tables "
        f"{table_bytes(daccel)} B: launches by table path "
        f"{path_launches(kernels)}")
    for tag, res, cl in (("skin", skin, calls), ("skin demo", skin_demo,
                                                   dcalls)):
        for k in REPLACES:
            dl = dead_lanes(cl, k)
            log(f"[10] {tag} {k}: {res[k][1]} rays in {query_mix(cl, k)}, "
                f"{res[k][0]} mismatches, max abs err {res[k][2]:.3g}; "
                f"{dl['no_live']} launches with no live lane, live share "
                f"{dl['live'] / dl['rays']:.4f}")
            if res[k][0]:
                raise AssertionError(f"{k} disagrees with its plain version "
                                     f"on the {tag} frame")
    del dcalls
    stimes, skin_bound = {}, {}
    for k in REPLACES:
        mine = [c[1:] for c in calls if c[0] == k]
        kern, walk = pair(k, kernels, bvh, saccel)
        p1 = events_ms(lambda: run_all(walk, mine), 1)
        dm, cm = kernel_ms(kern, mine, 5)
        p2 = events_ms(lambda: run_all(walk, mine), 1)
        r = sum(c[0].shape[0] for c in mine)
        stimes[k] = (dm, cm, (p1 + p2) / 2, r, len(mine))
        b = skin_bound[k] = bound(k, r, skin[k][3], saccel)
        log(f"[10] {k}: all {r} rays of the skin frame's {len(mine)} "
            f"queries: device {dm:.4f} ms, call {cm:.4f} ms "
            f"({dm / len(mine) * 1e3:.2f} / {cm / len(mine) * 1e3:.2f} us "
            f"per launch), plain {(p1 + p2) / 2:.4f} ms; walk {skin[k][3]}; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes "
            f"{b['byte_ms']:.4f} ms, operations {b['op_ms']:.4f} ms), share "
            f"of device time {b['bound_ms'] / dm:.4f}")
    del calls
    log(f"[10] phase {time.perf_counter() - t0:.1f} s")

    # ---- the skin path: skin_closeup.ass at its own options ----
    t0 = time.perf_counter()
    reset(kernels)
    sout, sdt = barred_render(wavefront, bvh, sscene, saccel)
    skin_launches = dict(kernels.LAUNCHES)
    so = sscene.options
    check_planes(sout, so.xres)
    for k, n in skin_launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the skin render")
    sss = float(sout["sss"].mean())
    if not sss > 0.0:
        raise AssertionError("the sss AOV is black")
    sstats = sout["__stats__"]
    srays = sstats["nearest_rays"] + sstats["shadow_rays"]
    log(f"[11] skin {so.xres}x{so.yres} AA {so.aa_samples}: {sdt:.4f} "
        f"s/frame, mean RGB {float(sout['RGBA'].mean()):.6f}, sss AOV mean "
        f"{sss:.6f}, all planes finite, launches {skin_launches}, by table "
        f"path {path_launches(kernels)}, nearest rays "
        f"{sstats['nearest_rays']}, shadow rays {sstats['shadow_rays']}, "
        f"{srays / sdt / 1e6:.3f} Mrays/s (nearest+shadow)")
    del sout
    profile_frame(wavefront, "11", sscene, saccel, aa_samples=AA,
                  xres=PROFILE_SIZE, yres=PROFILE_SIZE)
    log(f"[11] phase {time.perf_counter() - t0:.1f} s")

    # ---- the skin frame on the card and on the CPU ----
    t0 = time.perf_counter()
    cscene = build(SKIN, device="cpu")
    cuda_vs_cpu(wavefront, "12", {
        "cuda": (sscene, saccel),
        "cpu": (cscene, tracemod.build(cscene.geometry))},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=SKIN_CPU,
        yres=SKIN_CPU)
    log(f"[12] phase {time.perf_counter() - t0:.1f} s")

    dsy = scene_phases((13, 14, 15), DISNEY, DISNEY_AA, DISNEY_CHECK,
                       DISNEY_CPU, "disney", "indirect_specular")
    disney_step_phase(card)
    tex = scene_phases((17, 18, 19), TEXTURED, TEXTURED_AA, TEXTURED_CHECK,
                       TEXTURED_CPU, "textured", "direct_diffuse")
    clirun = cli_phase(card)
    tsets = trace_set_phase()
    suite_phase(clirun["golden"])

    entries = []
    for k in REPLACES:
        def shape(dm, cm, pm, b, launches):
            return {"launches": launches, "device_ms": dm, "call_ms": cm,
                    "plain_ms": pm, "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"]}

        dm, cm, pm, _, nq = times[k]
        shapes = {"demo": shape(dm, cm, pm, demo_bound[k], nq)}
        dm, cm, pm, _, nq = gtimes[k]
        shapes["glass"] = shape(dm, cm, pm, glass_bound[k], nq)
        dm, cm, pm, _, nq = stimes[k]
        shapes["skin"] = shape(dm, cm, pm, skin_bound[k], nq)
        dm, cm, pm, _, nq = dsy["times"][k]
        shapes["disney"] = shape(dm, cm, pm, dsy["bounds"][k], nq)
        dm, cm, pm, _, nq = tex["times"][k]
        shapes["textured"] = shape(dm, cm, pm, tex["bounds"][k], nq)
        for tag, (_, tt, tb) in tsets.items():
            dm, cm, pm, _, nq = tt[k]
            shapes[f"trace_sets_{tag}"] = shape(dm, cm, pm, tb[k], nq)
        for tag in jsets:
            dm, cm, pm, b = jwalk[(k, tag)]
            shapes[f"jwalk_{tag}"] = shape(dm, cm, pm, b, 1)
        entries.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k],
            "launches": (demo_launches[k] + glass_launches[k]
                         + skin_launches[k] + dsy["launches"][k]
                         + tex["launches"][k] + clirun["launches"][k]),
            "max_abs_err": max(frame[k][2], rand[k][2], glass[k][2],
                               soup[k][2], skin[k][2], skin_demo[k][2],
                               dsy["compare"][k][2], tex["compare"][k][2],
                               *(r[k][2] for r, _, _ in tsets.values())),
            "ms": times[k][1], "plain_ms": times[k][2],
            "bound_ms": demo_bound[k]["bound_ms"],
            "bound_by": demo_bound[k]["bound_by"], "library_ms": None,
            "launches_demo": demo_launches[k],
            "launches_glass": glass_launches[k],
            "launches_skin": skin_launches[k],
            "launches_disney": dsy["launches"][k],
            "launches_textured": tex["launches"][k],
            "launches_cli": clirun["launches"][k],
            "shapes": shapes,
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
