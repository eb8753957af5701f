"""The benchmark of rlshaders_tpu_torch: one cell, one run.

`run` builds the cell's scene on the card (set-up), renders whole frames
back to back for `seconds` (the window), judges frames of the window
against the frozen reference (`check.py`), and returns the result line.
Everything that belongs to one cell, configuration or metric is data or a
reader found by its name:

- `portbench/workloads/<cell>.json`: the cell's traffic (configuration,
  resolution, AA, tile, passes, roulette start, chips) and its check;
- `portbench/configs/<config>.json`: the scene file and its options;
- `portbench/metrics/<metric>.py`: a per-layer metric's reader;
- `BENCHMARK.json`: which metrics each cell reports.

Frame k of a run renders with seed `seed + 7919 k` (pass p of a frame with
`seed + 7919 (k passes + p)`), as `render_progressive` seeds its passes;
each frame ends in `torch.cuda.synchronize()`, and the window closes at the
first frame boundary after `seconds`. A cell with `chips` > 1 renders
through `parallel/mesh.py`: `launch` starts a process a card, and
`render_sharded` splits each frame's tiles over them.
"""
from __future__ import annotations

import importlib.util
import json
import os
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench import roofline
from portbench.spans import Spans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rlshaders_tpu")
SEED_STEP = 7919
# the kernels a traced window starts with (`torch.ones` and `add_`),
# which align the device's clock to the host's
MARKER_KERNELS = 2


class NoCard(RuntimeError):
    """The run cannot measure: no card, or fewer than the cell needs."""


def load(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def reader(name: str):
    """The per-layer metric's reader module, portbench/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, cell: str, kind: str) -> list:
    """The entries of `kind` ("end_to_end" or "per_layer") that the cell
    reports."""
    return [m for m in man[kind]
            if "workloads" not in m or cell in m["workloads"]]


def cell_spec(cell: str, overrides: dict | None = None) -> dict:
    """The cell's traffic merged over its configuration: one flat dict."""
    w = load("workloads", cell)
    c = load("configs", w["config"])
    spec = {"cell": cell, "config": w["config"],
            "scene": str(ROOT / c["scene"]), "reference": c["reference"],
            "xres": c["xres"], "yres": c["yres"], "aa": c["AA_samples"],
            "tile_pixels": 16384, "passes": 1, "rr_refr_start": 99,
            "chips": 1}
    spec.update({k: v for k, v in w.items() if k not in ("why", "check")})
    spec["check"] = dict(w["check"])
    spec.update(overrides or {})
    return spec


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the port's name starts with the latter's: whole names are
    compared)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def since_start() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


# ---------------------------------------------------------------------------
# One rank's set-up and window
# ---------------------------------------------------------------------------

def _frame(ctx, seed: int):
    """Render one frame (all its passes) and return its values at the
    checked pixels, (P, C) on the device, and the last pass's stats."""
    import torch

    from portbench import check
    from rlshaders_tpu_torch.integrator import wavefront

    s = ctx.spec
    vals = None
    for p in range(s["passes"]):
        pseed = seed + SEED_STEP * p
        if ctx.mesh is None:
            fb = wavefront.render_tiles(
                ctx.scene, ctx.accel, seed=pseed,
                tile_pixels=s["tile_pixels"], aa_samples=s["aa"],
                xres=s["xres"], yres=s["yres"],
                rr_refr_start=s["rr_refr_start"], profile=ctx.trace)
            v = check.gather(fb, ctx.idx)
            stats, names = fb.stats, fb.names
        else:
            from rlshaders_tpu_torch.parallel import mesh

            out = mesh.render_sharded(
                ctx.scene, ctx.accel, ctx.mesh, seed=pseed,
                tile_pixels=s["tile_pixels"], aa_samples=s["aa"],
                xres=s["xres"], yres=s["yres"])
            stats = out.pop("__stats__")
            names = sorted(k for k in out if k != "RGBA")
            full = torch.cat([out["RGBA"].reshape(-1, 3)]
                             + [out[k].reshape(-1, 3) for k in names], 1)
            v = full[ctx.idx]
        vals = v if vals is None else vals + v
    if s["passes"] > 1:
        vals = vals / s["passes"]
    ctx.names = names
    return vals, stats


def _warm(ctx, seed: int) -> None:
    """One tile of the frame, the last (padded where the frame does not
    fill its tiles): every tile runs the same kernels at the same sizes,
    so one warms them all. Through the mesh, a whole frame."""
    from rlshaders_tpu_torch.integrator import wavefront

    s = ctx.spec
    if ctx.mesh is not None:
        _frame(ctx, seed)
        return
    n_sub = s["aa"] * s["aa"]
    n_rays = s["xres"] * s["yres"] * n_sub
    tiles = -(-n_rays // min(s["tile_pixels"] * n_sub, n_rays))
    wavefront.render_tiles(
        ctx.scene, ctx.accel, seed=seed, tile_pixels=s["tile_pixels"],
        aa_samples=s["aa"], xres=s["xres"], yres=s["yres"],
        rr_refr_start=s["rr_refr_start"], profile=ctx.trace, parts=tiles,
        part=tiles - 1)


def _sync(ctx) -> None:
    import torch

    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def rank_run(rank: int, spec: dict) -> dict:
    """Set-up, window and (traced) readings of one rank; rank 0's dict is
    the run's. Picklable, so `mesh.launch` can run it in each process."""
    t_start = spec.get("_t0", time.perf_counter())
    spans = Spans()
    trace = bool(spec["trace"])
    with spans.span("setup.import"):
        import torch

        from rlshaders_tpu_torch.accel import trace as tracemod
        from rlshaders_tpu_torch.integrator import sss as sssmod
        from rlshaders_tpu_torch.integrator import wavefront
        from rlshaders_tpu_torch.ops import intersect
        from rlshaders_tpu_torch.scene import build as buildmod
    device = torch.device(spec["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        with spans.span("setup.context"):
            torch.zeros(1, device=device)
        with spans.span("setup.kernels"):
            intersect.build()
    ctx = SimpleNamespace(spec=spec, device=device, trace=trace, mesh=None,
                          spans=spans)
    world = spec["chips"]
    if world > 1:
        from rlshaders_tpu_torch.parallel import mesh as meshmod

        ctx.mesh = meshmod.make_mesh(world)
    with spans.span("setup.build"):
        t_b = time.perf_counter()
        ctx.scene = buildmod.build(spec["scene"], device=str(device))
        ctx.accel = tracemod.build(ctx.scene.geometry)
        _sync(ctx)
        build_s = time.perf_counter() - t_b
    ctx.idx = torch.nonzero(spec["_checked"]).reshape(-1).to(device)
    stages = (wavefront._tile, sssmod.sss_stage)
    if trace:
        # spans around the program's stages, from this file
        wavefront._tile = spans.wrap("tile", stages[0])
        sssmod.sss_stage = spans.wrap("sss", stages[1])
    try:
        return _measure(ctx, spec, spans, build_s, t_start)
    finally:
        wavefront._tile, sssmod.sss_stage = stages


def _measure(ctx, spec: dict, spans, build_s: float, t_start: float):
    import torch

    device, trace, world = ctx.device, ctx.trace, spec["chips"]
    with spans.span("setup.warm"):
        # the cell's own shapes, with a seed no frame of the window takes
        _warm(ctx, spec["seed"] + SEED_STEP * 1_000_003)
        _sync(ctx)
    setup_s = time.perf_counter() - t_start + spec.get("_before", 0.0)
    parts = ", ".join(f"{n[6:]} {spans.seconds(n):.3f}" for n in (
        "setup.import", "setup.context", "setup.kernels", "setup.build",
        "setup.warm"))
    print(f"set-up {setup_s:.3f} s: before the harness "
          f"{spec.get('_before', 0.0):.3f}, torch "
          f"{spec.get('_torch_s', 0.0):.3f}, {parts}", file=sys.stderr)
    mem_setup = (torch.cuda.max_memory_allocated(device)
                 if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    prof = None
    if trace and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    marker_host = time.perf_counter_ns()
    if prof is not None:
        # the first kernel of the trace: aligns the device's clock to spans
        torch.ones(1, device=device).add_(1)
    frames, kept, stats_rows, ends = 0, [], [], []
    t0 = time.perf_counter()
    while True:
        with spans.span("frame"):
            vals, stats = _frame(ctx, spec["seed"] + SEED_STEP * frames
                                 * spec["passes"])
            _sync(ctx)
        ends.append(time.perf_counter())
        kept.append(vals)
        stats_rows.append(dict(stats))
        frames += 1
        stop = time.perf_counter() - t0 >= spec["seconds"]
        if world > 1:
            # every rank takes rank 0's decision: the frames' collectives
            # must pair up
            import torch.distributed as dist

            flag = torch.tensor([float(stop)], device=device)
            dist.broadcast(flag, 0)
            stop = bool(flag.item())
        if stop:
            break
    t1 = time.perf_counter()
    each = np.diff([t0] + ends)
    print(f"frames: {frames}, the first {each[0]:.4f} s, the others "
          f"{float(np.min(each[1:], initial=0.0)):.4f}-"
          f"{float(np.max(each[1:], initial=0.0)):.4f} s", file=sys.stderr)
    if prof is not None:
        _sync(ctx)
        prof.__exit__(None, None, None)
    mem_window = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    out = {
        "frames": frames, "window_s": t1 - t0, "setup_s": setup_s,
        "build_s": build_s, "names": ctx.names,
        "values": [v.cpu().numpy() for v in kept],
        "stats": stats_rows, "mem_peak": max(mem_setup, mem_window),
        "mem_window": mem_window,
    }
    if trace and not any(r[0] == "tile" for r in spans.rows):
        raise RuntimeError("no 'tile' span in the traced window: the "
                           "program no longer calls wavefront._tile "
                           "through its module")
    if trace:
        # TileRenderer(profile=True)'s stage seconds and calls: each
        # frame's renderer is new, so its stats are that frame's
        out["stages"] = {k: sum(r.get(k, 0) for r in stats_rows)
                         for k in ("t_tile", "n_tile", "t_sss", "n_sss")}
        if prof is not None:
            t = time.perf_counter()
            out.update(_device_readings(prof, spans, marker_host,
                                        t1 - t0))
            t2 = time.perf_counter()
            # one more frame, not timed, its queries sampled for the walk
            out["queries"] = roofline.capture_and_count(ctx, spec, _frame)
            print(f"trace: events read in {t2 - t:.3f} s, queries "
                  f"counted in {time.perf_counter() - t2:.3f} s",
                  file=sys.stderr)
    if world > 1:
        import torch.distributed as dist

        rows = [None] * world
        dist.all_gather_object(rows, {k: out.get(k) for k in
                                      ("busy_s", "mem_peak", "mem_window")})
        out["rank_rows"] = rows
    return out


def _device_readings(prof, spans, marker_host: int, window_s: float):
    """Kernels by name, the union of device activity and the longest idle
    gaps from the profiler's raw events (CUDA activity only)."""
    import torch

    evs = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            evs.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    evs.sort()
    # the marker is the window's first event; host time = device - offset
    offset = evs[0][0] - marker_host if evs else 0
    print(f"trace: marker {[n for _, _, n in evs[:MARKER_KERNELS]]}",
          file=sys.stderr)
    evs = evs[MARKER_KERNELS:]
    by_name = {}
    for s, e, name in evs:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += (e - s) / 1e6
        row[1] += 1
    merged = []
    for s, e, _ in evs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_ns = sum(e - s for s, e in merged)
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    idle = [[spans.innermost(at - offset), g / 1e9] for g, at in gaps[:10]]
    ops = sorted(((v[0] / 1e3, k) for k, v in by_name.items()),
                 reverse=True)[:10]
    return {"kernels": by_name, "busy_s": busy_ns / 1e9,
            "trace_window_s": window_s,
            "breakdown": {"device_ops": [[k, s] for s, k in ops],
                          "idle_gaps": idle}}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def run(cell: str, seed: int, seconds: float, trace: int, *,
        device: str = "cuda", overrides: dict | None = None,
        t0: float | None = None, before: float = 0.0) -> dict:
    """One run of the cell; returns the result line (a dict) and prints
    the compared numbers to standard error. `device` "cpu" skips the look
    for a card (the tests drive the rest of a run so)."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = cell_spec(cell, overrides)
    man = manifest()
    spec.update(seed=int(seed), seconds=float(seconds), trace=int(trace),
                device=device, _t0=t0, _before=before)
    t = time.perf_counter()
    import torch

    spec["_torch_s"] = time.perf_counter() - t
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < spec["chips"]:
            raise NoCard(f"{torch.cuda.device_count()} cards, the cell "
                         f"needs {spec['chips']}")
    chk = spec["check"]
    from portbench import check

    spec["_live"], spec["_checked"] = check.blocks(
        spec["seed"], spec["xres"], spec["yres"], chk["blocks"],
        chk["block"])
    if spec["chips"] > 1:
        from rlshaders_tpu_torch.parallel import mesh

        res = mesh.launch(rank_run, spec["chips"], spec, device=device,
                          timeout_s=900.0)
    else:
        res = rank_run(0, spec)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{', '.join(bad)}")
    return finish(spec, man, res)


def finish(spec: dict, man: dict, res: dict) -> dict:
    """The check against the reference, the metrics and the result line."""
    import torch

    from portbench import check

    cell = spec["cell"]
    if spec["device"] == "cuda":
        torch.cuda.empty_cache()
        kind = torch.cuda.get_device_name(0)
        # after the window: no part of set-up
        spec["_card"] = card_line()
    else:
        kind = "cpu"
    chk = spec["check"]
    # frames drawn from the seed, past the first where there are more: a
    # fault that keeps a frame's state shows from the second frame on
    r = random.Random(spec["seed"] * 31 + 7)
    pool = range(1 if res["frames"] > 1 else 0, res["frames"])
    frames = sorted(r.sample(pool, min(chk["frames"], len(pool))))
    ref = check.Reference(spec["scene"], spec["device"], spec["reference"])
    idx = torch.nonzero(spec["_checked"]).reshape(-1)
    rows = []
    t_ref = time.perf_counter()
    for k in frames:
        want = None
        for p in range(spec["passes"]):
            v, names = ref.frame(spec["seed"] + SEED_STEP * (
                k * spec["passes"] + p), spec, spec["_live"], idx)
            want = v if want is None else want + v
        want = want / spec["passes"]
        rows.append(check.numbers(
            check.planes(res["values"][k], res["names"]),
            check.planes(want, names), chk["atol"], chk["rtol"]))
    ref_s = time.perf_counter() - t_ref
    got = check.worst(rows)
    limits = chk["limits"]
    correct = all(got[k] <= limits[k] for k in limits)
    compared = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    metrics = {}
    if spec["trace"]:
        ctx = SimpleNamespace(spec=spec, res=res, card=spec.get("_card"))
        for m in cell_metrics(man, cell, "per_layer"):
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"frame_s": res["window_s"] / res["frames"],
               "setup_s": res["setup_s"]}
        for m in cell_metrics(man, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": m["unit"]}
    rows_mem = [x["mem_peak"] for x in res.get("rank_rows") or [res]]
    device = {"platform": "gpu" if spec["device"] == "cuda" else "cpu",
              "kind": kind, "count": spec["chips"],
              "memory_peak_bytes": int(max(rows_mem))}
    line = {"correct": bool(correct), "attempted": res["frames"],
            "failed": 0 if correct else len(frames), "metrics": metrics,
            "device": device}
    if spec["trace"] and "busy_s" in res:
        busy = [x["busy_s"] for x in res.get("rank_rows") or [res]]
        device["busy_s"] = float(np.mean(busy))
        device["window_s"] = res["trace_window_s"]
        line["breakdown"] = res["breakdown"]
    print(f"reference: frames {frames} of {res['frames']}, "
          f"{int(idx.numel())} pixels, {ref_s:.3f} s", file=sys.stderr)
    for k, v in compared.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    line["card"] = spec.get("_card", "not read")
    line["checks"] = compared
    return line
