"""The program's own spans and counters (`rlshaders_tpu_torch/core/
tracer.py`), read after a traced run's window for the readers of the
generation tree's stages, the frame driver's idle time and the live lanes.

The window's profiler events are gone when the readers run, so `capture`
renders frames of its own, once for all its readers, on a scene and tree
it builds again, through the harness's `_frame` and `_sync` as the window
renders them:

1. one frame with the tracer's counters on (`live_lanes`, `lanes`; their
   reductions are in this frame alone), then a synchronize;
2. frames with the spans on, untimed and without the per-tile
   synchronizations of `profile`, each ending in a synchronize: enough
   for about CAPTURE_S seconds, at least one.

On the card a torch.profiler run records the card's activity and the CUDA
runtime calls over both; the tracer charges each kernel of part 2 to the
innermost span open at its launch, and each idle gap, from the end of
part 1 on, to the span open at the launch that ended it
(`tracer.attribute`). Work launched outside the program's spans is the
harness's (its gather of checked pixels between frames). The whole table
goes to standard error. On the CPU only part 1 runs.

A program without the tracer gives None, and every reader nothing.
"""
from __future__ import annotations

import contextlib
import importlib.util
import sys
import time
from types import SimpleNamespace

CAPTURE_S = 3.0
TRACER = "rlshaders_tpu_torch.core.tracer"


def capture(ctx):
    """The readings (a dict), computed once a run and kept on the
    readers' ctx; None where the program has no tracer or the cell runs
    on more than one chip."""
    if not hasattr(ctx, "stages"):
        ctx.stages = _capture(ctx)
    return ctx.stages


def device_ms(ctx, name: str):
    """Device ms a frame of the kernels launched inside span `name`."""
    cap = capture(ctx)
    if cap is None or cap.get("device_ms") is None:
        return None
    return cap["device_ms"].get(name, 0.0)


def _capture(ctx):
    spec = ctx.spec
    if spec["chips"] > 1 or importlib.util.find_spec(TRACER) is None:
        return None
    import torch

    from portbench import harness
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.core import tracer
    from rlshaders_tpu_torch.scene import build as buildmod

    device = torch.device(spec["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    scene = buildmod.build(spec["scene"], device=str(device))
    run = SimpleNamespace(
        spec=spec, device=device, trace=False, mesh=None, scene=scene,
        accel=tracemod.build(scene.geometry),
        idx=torch.nonzero(spec["_checked"]).reshape(-1).to(device))
    tracer.take()      # the rows the window's profiled frames left
    seed, step = spec["seed"], harness.SEED_STEP * spec["passes"]
    frames = max(1, round(CAPTURE_S * ctx.res["frames"]
                          / ctx.res["window_s"]))
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        recorder = profile(activities=[ProfilerActivity.CUDA])
    else:
        recorder = contextlib.nullcontext()
    with recorder as prof:
        with tracer.enabled(spans=True, counters=True):
            harness._frame(run, seed)
            harness._sync(run)
        rows, counts = tracer.take()
        out = {"live_lanes": counts.get("live_lanes", 0),
               "lanes": counts.get("lanes", 0), "device_ms": None}
        print(f"stages: live lanes {out['live_lanes']} of {out['lanes']}",
              file=sys.stderr)
        if prof is None:
            _host_table(tracer, rows)
            return out
        since = time.time_ns()
        tiles = 0
        with tracer.enabled(spans=True):
            for k in range(1, frames + 1):
                _, stats = harness._frame(run, seed + step * k)
                harness._sync(run)
                tiles += stats["tiles"] * spec["passes"]
    rows, _ = tracer.take()
    t = time.perf_counter()
    kernels, launches, syncs = tracer.device_events(prof)
    att = tracer.attribute(rows, kernels, launches, syncs, since)
    per = 1e6 * frames
    out.update(
        frames=frames,
        device_ms={k: v / per for k, v in att.device_ns.items()},
        idle_ms={k: v / per for k, v in att.idle_ns.items()},
        launches={k: v / frames for k, v in att.launches.items()},
        driver_idle_ms=att.driver_idle_ns / per,
        matched=1.0 - att.device_ns.get(tracer.UNMATCHED, 0)
        / max(att.kernel_ns, 1))
    _device_table(tracer, att, out, rows, since, tiles, kernels, launches,
                  time.perf_counter() - t)
    return out


def _host_table(tracer, rows) -> None:
    for name, (ns, n) in sorted(tracer.host_table(rows).items()):
        print(f"stages: span {name:10s} host {ns / 1e9:.6f} s, {n} rows",
              file=sys.stderr)


def _device_table(tracer, att, out, rows, since, tiles, kernels, launches,
                  read_s) -> None:
    frames = out["frames"]
    err = sys.stderr
    labels = sorted(set(att.device_ns) | set(att.idle_ns) | set(att.syncs),
                    key=lambda k: -att.device_ns.get(k, 0))
    for k in labels:
        name = "harness" if k == tracer.OUTSIDE else k
        print(f"stages: span {name:10s} device "
              f"{out['device_ms'].get(k, 0.0)!r} ms/frame, "
              f"{out['launches'].get(k, 0.0)!r} launches/frame, idle "
              f"{out['idle_ms'].get(k, 0.0)!r} ms/frame in "
              f"{att.gaps.get(k, 0) / frames!r} gaps, "
              f"{att.syncs.get(k, 0) / frames!r} syncs/frame", file=err)
    shares = ", ".join(
        f"{k} {100 * v / max(att.kernel_ns, 1):.2f}%"
        for k, v in sorted(att.device_ns.items(), key=lambda x: -x[1]))
    early = sum(1 for s, _, c in kernels if c in launches and s < launches[c])
    kept = [r for r in rows if r[1] >= since]
    print(f"stages: {frames} frames; kernels {att.kernels}, device "
          f"{att.kernel_ns / 1e6 / frames!r} ms/frame (the table sums to "
          f"{sum(att.device_ns.values()) / 1e6 / frames!r}), matched "
          f"{100 * out['matched']!r}%, {att.unmatched} with no launch, "
          f"{early} starting before their launch (card clock less host's "
          f"{att.skew_ns} ns at least); busy "
          f"{att.busy_ns / 1e6 / frames!r} of "
          f"{att.window_ns / 1e6 / frames!r} ms/frame, driver idle "
          f"{out['driver_idle_ms']!r} ms/frame; shares {shares}", file=err)
    print(f"stages: span rows {len(kept) / frames!r} a frame, tile spans "
          f"{sum(1 for r in kept if r[0] == 'tile')} for {tiles} tiles; "
          f"events read and charged in {read_s:.3f} s", file=err)
