"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints progress; any failure raises and exits nonzero):

1. the card's name and power limit (nvidia-smi); refuses to run without a
   CUDA device;
2. builds the ray-query kernels (ops/csrc/intersect.cu) with nvcc;
3. holds each kernel against its plain PyTorch version (accel/bvh.py) on
   the card: on every query of a 256x256 demo frame (camera, GI and shadow
   rays) and on random rays with dead lanes, exclude_tri and each
   visibility bit; prints mismatch counts and the times of both;
4. renders demo_scene(skin=False) at 256x256, AA 2, through the kernels,
   with the kernels' launch counts reset first and the plain walk barred
   from CUDA tensors; prints seconds per frame, the query counts and the
   rate;
5. renders at 32x32 on the card and on the CPU (plain walk) and compares.

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

SIZE = 256          # frame width and height of the main-path render
AA = 2
SEED = 0
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_queries(scene, accel, wavefront, tracemod):
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
        wavefront.render(scene, accel, device="cuda", seed=SEED,
                         aa_samples=AA, xres=SIZE, yres=SIZE)
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
    tens = (torch.tensor(o, dtype=torch.float32, device="cuda"),
            torch.tensor(d, dtype=torch.float32, device="cuda"),
            torch.tensor(t_max, dtype=torch.float32, device="cuda"),
            torch.tensor(ex, dtype=torch.int32, device="cuda"))
    out = []
    for bit in range(8):
        for name in ("rls_nearest", "rls_occluded"):
            out.append((name, *tens, 1 << bit))
    return out


def compare(accel, calls, bvh, kernels):
    """Run kernel and plain version on each captured query; returns per
    kernel (mismatching rays, rays, max abs error)."""
    res = {k: [0, 0, 0.0] for k in REPLACES}
    for name, o, d, tm, ex, vis in calls:
        if name == "rls_nearest":
            hk = kernels.nearest(accel.tree, accel.tris, o, d, tm, ex, vis)
            hp = bvh.intersect(accel.tree, accel.tris, o, d, tm, ex, vis)
            bad = ((hk.tri != hp.tri) | (hk.t != hp.t) | (hk.u != hp.u)
                   | (hk.v != hp.v))
            hit = hp.tri >= 0
            err = max(float((hk.t - hp.t)[hit].abs().max()) if hit.any()
                      else 0.0,
                      float((hk.u - hp.u).abs().max()),
                      float((hk.v - hp.v).abs().max()))
        else:
            bk = kernels.occluded(accel.tree, accel.tris, o, d, tm, ex, vis)
            bp = bvh.occluded(accel.tree, accel.tris, o, d, tm, ex, vis)
            bad = bk != bp
            err = float(bad.any())
        r = res[name]
        r[0] += int(bad.sum())
        r[1] += o.shape[0]
        r[2] = max(r[2], err)
    return res


def time_kernels(accel, calls, bvh, kernels):
    """Per kernel: (kernel ms, plain ms, rays) for all of the frame's
    queries of that kernel, run back to back."""
    out = {}
    for name in REPLACES:
        mine = [c[1:] for c in calls if c[0] == name]
        if name == "rls_nearest":
            kern, plain = kernels.nearest, bvh.intersect
        else:
            kern, plain = kernels.occluded, bvh.occluded

        def run(fn, mine=mine):
            for o, d, tm, ex, vis in mine:
                fn(accel.tree, accel.tris, o, d, tm, ex, vis)

        # plain, kernel, kernel, plain: clocks drift less across a pair
        p1 = cuda_ms(lambda: run(plain), 2)
        k1 = cuda_ms(lambda: run(kern), 10)
        k2 = cuda_ms(lambda: run(kern), 10)
        p2 = cuda_ms(lambda: run(plain), 2)
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2,
                     sum(c[0].shape[0] for c in mine))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 1
    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.demo import demo_scene

    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name} | nvidia-smi: {card} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = kernels.build()
    log(f"[2] built {lib} in {time.perf_counter() - t0:.2f} s")

    scene, accel = demo_scene(skin=False, device="cuda")
    calls = capture_queries(scene, accel, wavefront, tracemod)
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
    for k, (km, pm, r) in times.items():
        log(f"[3] {k}: all {r} rays of the frame's queries: kernel "
            f"{km:.4f} ms, plain {pm:.4f} ms")

    # ---- the main path: a timed 256x256 frame through the kernels ----
    def barred(*args, **kwargs):
        raise AssertionError("the plain BVH walk was called on the card")

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    real = bvh.intersect, bvh.occluded
    bvh.intersect = bvh.occluded = barred
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wavefront.render(scene, accel, device="cuda", seed=SEED,
                               aa_samples=AA, xres=SIZE, yres=SIZE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        bvh.intersect, bvh.occluded = real
    launches = dict(kernels.LAUNCHES)
    stats = out["__stats__"]
    rgba = out["RGBA"]
    if tuple(rgba.shape) != (SIZE, SIZE, 3):
        raise AssertionError(f"frame shape {tuple(rgba.shape)}")
    for k, v in out.items():
        if k != "__stats__" and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite values in {k}")
    if not float(rgba.mean()) > 0.0:
        raise AssertionError("black frame")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the render")
    rays = stats["nearest_rays"] + stats["shadow_rays"]
    log(f"[4] {SIZE}x{SIZE} AA {AA}: {dt:.4f} s/frame, mean RGB "
        f"{float(rgba.mean()):.6f}, launches {launches}, nearest rays "
        f"{stats['nearest_rays']}, shadow rays {stats['shadow_rays']}, "
        f"{rays / dt / 1e6:.3f} Mrays/s (nearest+shadow)")

    # ---- the same small frame on the card and on the CPU ----
    cpu_scene, cpu_accel = demo_scene(skin=False, device="cpu")
    small = {}
    for dev, (sc, ac) in (("cuda", (scene, accel)),
                          ("cpu", (cpu_scene, cpu_accel))):
        o = wavefront.render(sc, ac, device=dev, seed=SEED, aa_samples=AA,
                             xres=32, yres=32)
        small[dev] = {k: v.cpu().numpy() for k, v in o.items()
                      if k != "__stats__"}
    worst = 1.0
    for k in small["cpu"]:
        a, b = small["cuda"][k], small["cpu"][k]
        within = float((np.abs(a - b).max(-1) <= PIX_TOL).mean())
        mean_err = abs(float(a.mean()) - float(b.mean())) / max(
            abs(float(b.mean())), 1e-6)
        log(f"[5] {k}: share of pixels within {PIX_TOL}: {within:.4f}, "
            f"mean cuda {a.mean():.6f} cpu {b.mean():.6f}")
        if within < PIX_FRAC or mean_err > MEAN_RTOL:
            raise AssertionError(f"{k}: CUDA and CPU frames disagree")
        worst = min(worst, within)

    kernels_line = {"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": max(frame[k][2], rand[k][2]),
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k in REPLACES]}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
