"""The program's counters over one frame rendered after a traced run's
window, every counter kept, for the readers of those that `stages.py`
does not keep (it keeps `lanes` and `live_lanes`).

`capture` builds the scene and its tree again and renders the run's
first frame through the harness's `_frame` and `_sync`, as part 1 of
`stages._capture` does, with the tracer's counters on (their reductions
are in this frame alone) and its spans off. A program without the
tracer, or a cell on more than one chip, gives None, and every reader
nothing; a counter the program does not keep is missing from the dict.
"""
from __future__ import annotations

import importlib.util
import sys
from types import SimpleNamespace

from portbench.stages import TRACER


def capture(ctx):
    """{counter: int} of one frame, computed once a run and kept on the
    readers' ctx; None where the program has no tracer or the cell runs
    on more than one chip."""
    if not hasattr(ctx, "counters"):
        ctx.counters = _capture(ctx)
    return ctx.counters


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
    tracer.take()      # what the frames before left
    with tracer.enabled(counters=True):
        harness._frame(run, spec["seed"])
        harness._sync(run)
    _, counts = tracer.take()
    print("counters: " + ", ".join(f"{k} {v}" for k, v in
                                   sorted(counts.items())), file=sys.stderr)
    return counts
