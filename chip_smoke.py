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
   rays) and on random rays with dead lanes, exclude_tri and each
   visibility bit; prints mismatch counts, the times of both and the bound;
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
   kernels and, in one uncounted pass, the plain walk on those queries, and
   profiles a 128x128 frame, one full tile of the timed frame;
7. renders the glass scene at 256x256, AA 3, its own options, through the
   kernels (counts reset, plain walk barred); prints seconds per frame, the
   query counts, the rate and the refraction AOV;
8. the stage timing of the TPU tool tools/trace_decomp2.py (j_walk): each
   kernel alone, warm, on 262,144 coherent camera rays of the glass scene
   and 262,144 incoherent cosine-bounce rays from their hits, beside its
   byte and operation bounds;
9. renders the glass scene at 32x32 on the card and on the CPU and
   compares.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

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
PROFILE_SIZE = 128  # the profiled glass frame: one full tile at AA 3
JWALK_RAYS = 262144
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


def compare(accel, calls, bvh, kernels):
    """Run kernel and plain version on each captured query; returns per
    kernel [mismatching rays, rays, max abs error, the plain walk's work
    counts]. The walk counts its work here, so it is not timed here."""
    res = {k: [0, 0, 0.0, {}] for k in REPLACES}
    for name, o, d, tm, ex, vis in calls:
        counts = res[name][3]
        if name == "rls_nearest":
            hk = kernels.nearest(accel.tree, accel.tris, o, d, tm, ex, vis)
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
            bk = kernels.occluded(accel.tree, accel.tris, o, d, tm, ex, vis)
            bp = bvh.occluded(accel.tree, accel.tris, o, d, tm, ex, vis,
                              counts=counts)
            bad = bk != bp
            err = float(bad.any())
        r = res[name]
        r[0] += int(bad.sum())
        r[1] += o.shape[0]
        r[2] = max(r[2], err)
    return res


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


def pair(name: str, kernels, bvh):
    """(kernel wrapper, plain version) of a kernel."""
    if name == "rls_nearest":
        return kernels.nearest, bvh.intersect
    return kernels.occluded, bvh.occluded


def run_all(fn, accel, queries) -> None:
    for o, d, tm, ex, vis in queries:
        fn(accel.tree, accel.tris, o, d, tm, ex, vis)


def time_kernels(accel, calls, bvh, kernels):
    """Per kernel: (kernel ms, plain ms, rays) for all of the frame's
    queries of that kernel, run back to back."""
    out = {}
    for name in REPLACES:
        mine = [c[1:] for c in calls if c[0] == name]
        kern, walk = pair(name, kernels, bvh)
        # plain, kernel, kernel, plain: clocks drift less across a pair
        p1 = cuda_ms(lambda: run_all(walk, accel, mine), 2)
        k1 = cuda_ms(lambda: run_all(kern, accel, mine), 10)
        k2 = cuda_ms(lambda: run_all(kern, accel, mine), 10)
        p2 = cuda_ms(lambda: run_all(walk, accel, mine), 2)
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2,
                     sum(c[0].shape[0] for c in mine))
    return out


def reset(kernels) -> None:
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


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


def profile_frame(wavefront, scene, accel, **kw) -> None:
    """Device time of one frame by kernel (torch.profiler): prints the
    device busy share and the largest entries."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        wavefront.render(scene, accel, seed=SEED, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    rows = prof.key_averages()
    dev = [(getattr(r, "self_device_time_total", 0.0), r.count, r.key)
           for r in rows]
    total = sum(t for t, _, _ in dev) / 1e3
    launches = sum(r.count for r in rows if r.key == "cudaLaunchKernel")
    log(f"[6] profile: wall {wall:.4f} s (profiled), device time "
        f"{total:.4f} ms, busy share {total / 1e3 / wall:.4f}, "
        f"cudaLaunchKernel calls {launches}; reading the profile took "
        f"{time.perf_counter() - t1:.1f} s")
    for t, n, key in sorted(dev, reverse=True)[:8]:
        log(f"[6]   {t / 1e3:10.4f} ms  {n:8d} x  {key[:70]}")


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
    frame = compare(accel, calls, bvh, kernels)
    rand = compare(accel, random_queries(accel, 100_000, 7), bvh, kernels)
    for k in REPLACES:
        live = sum(int((c[3] > 0).sum()) for c in calls if c[0] == k)
        log(f"[3] {k}: frame queries {frame[k][1]} rays ({live} live, the "
            f"rest t_max <= 0), {frame[k][0]} "
            f"mismatches; random queries {rand[k][1]} rays, {rand[k][0]} "
            f"mismatches; max abs err {max(frame[k][2], rand[k][2]):.3g}")
        if frame[k][0] or rand[k][0]:
            raise AssertionError(f"{k} disagrees with its plain version")
    times = time_kernels(accel, calls, bvh, kernels)
    demo_bound = {}
    for k, (km, pm, r) in times.items():
        b = demo_bound[k] = bound(k, r, frame[k][3], accel)
        log(f"[3] {k}: all {r} rays of the frame's queries: kernel "
            f"{km:.4f} ms, plain {pm:.4f} ms; walk {frame[k][3]}; bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} (bytes "
            f"{b['byte_ms']:.4f} ms, operations {b['op_ms']:.4f} ms), "
            f"share {b['bound_ms'] / km:.4f}")
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
        f"{float(out['RGBA'].mean()):.6f}, launches {demo_launches}, "
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
    glass = compare(gaccel, calls, bvh, kernels)
    log(f"[6] captured and compared in {time.perf_counter() - t0:.1f} s")
    for k in REPLACES:
        mine = [c for c in calls if c[0] == k]
        dead = sum(int((c[3] <= 0).sum()) for c in mine)
        finite = sum(int(((c[3] > 0) & (c[3] < 1e29)).sum()) for c in mine)
        excl = sum(int((c[4] >= 0).sum()) for c in mine)
        log(f"[6] {k}: {len(mine)} queries, {glass[k][1]} rays ({dead} dead "
            f"with t_max <= 0, {finite} with a finite t_max, {excl} with an "
            f"exclude), {glass[k][0]} mismatches, max abs err "
            f"{glass[k][2]:.3g}")
        if glass[k][0]:
            raise AssertionError(f"{k} disagrees with its plain version on "
                                 f"the glass frame")
    gtimes, glass_bound = {}, {}
    for k in REPLACES:
        mine = [c[1:] for c in calls if c[0] == k]
        kern, walk = pair(k, kernels, bvh)
        km = cuda_ms(lambda: run_all(kern, gaccel, mine), 3)
        # the plain walk takes minutes here: one pass, warm from compare()
        pm = events_ms(lambda: run_all(walk, gaccel, mine), 1)
        r = sum(c[0].shape[0] for c in mine)
        gtimes[k] = (km, pm, r)
        b = glass_bound[k] = bound(k, r, glass[k][3], gaccel)
        log(f"[6] {k}: all {r} rays of the glass frame's queries: kernel "
            f"{km:.4f} ms, plain {pm:.4f} ms (one pass); "
            f"walk {glass[k][3]}; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} (bytes {b['byte_ms']:.4f} ms, operations "
            f"{b['op_ms']:.4f} ms), share {b['bound_ms'] / km:.4f}")
    del calls
    profile_frame(wavefront, gscene, gaccel, aa_samples=GLASS_AA,
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
        f"{refr:.6f}, all planes finite, launches {glass_launches}, "
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
        for k, kern, walk in (("rls_nearest", kernels.nearest, bvh.intersect),
                              ("rls_occluded", kernels.occluded,
                               bvh.occluded)):
            counts = {}
            walk(gaccel.tree, gaccel.tris, o, d, tmax, ex, 0xFF,
                 counts=counts)
            ms = cuda_ms(lambda: kern(gaccel.tree, gaccel.tris, o, d, tmax,
                                      ex, 0xFF), 50)
            pms = cuda_ms(lambda: walk(gaccel.tree, gaccel.tris, o, d, tmax,
                                       ex, 0xFF), 1)
            b = bound(k, n, counts, gaccel)
            jwalk[(k, tag)] = (ms, pms, b)
            log(f"[8] j_walk {tag} {k}: {ms:.4f} ms, {n / ms / 1e3:.1f} "
                f"Mrays/s, plain {pms:.4f} ms; walk {counts}; byte bound "
                f"{b['byte_ms']:.4f} ms, "
                f"operation bound {b['op_ms']:.4f} ms, share of the larger "
                f"({b['bound_by']}) {b['bound_ms'] / ms:.4f}")
    log(f"[8] phase {time.perf_counter() - t0:.1f} s")

    # ---- the glass frame on the card and on the CPU ----
    t0 = time.perf_counter()
    cscene = build(GLASS, device="cpu")
    cuda_vs_cpu(wavefront, "9", {
        "cuda": (gscene, gaccel),
        "cpu": (cscene, tracemod.build(cscene.geometry))},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=32, yres=32)
    log(f"[9] phase {time.perf_counter() - t0:.1f} s")

    entries = []
    for k in REPLACES:
        entry = {
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k],
            "launches": demo_launches[k] + glass_launches[k],
            "max_abs_err": max(frame[k][2], rand[k][2], glass[k][2]),
            "ms": times[k][0], "plain_ms": times[k][1],
            "bound_ms": demo_bound[k]["bound_ms"],
            "bound_by": demo_bound[k]["bound_by"], "library_ms": None,
            "launches_demo": demo_launches[k],
            "launches_glass": glass_launches[k],
            "glass_ms": gtimes[k][0], "glass_plain_ms": gtimes[k][1],
            "glass_bound_ms": glass_bound[k]["bound_ms"],
            "glass_bound_by": glass_bound[k]["bound_by"],
        }
        for tag in jsets:
            ms, pms, b = jwalk[(k, tag)]
            entry[f"jwalk_{tag}_ms"] = ms
            entry[f"jwalk_{tag}_plain_ms"] = pms
            entry[f"jwalk_{tag}_bound_ms"] = b["bound_ms"]
            entry[f"jwalk_{tag}_bound_by"] = b["bound_by"]
        entries.append(entry)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
