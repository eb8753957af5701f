#!/usr/bin/env python3
"""Readings that set the output check's limits, at a cell's own sizes.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--device cuda] [--out readings.json]

For each seed, one frame of the cell (the seed's first frame of a run,
with that run's checked pixels) rendered three ways, each judged against
the reference (`check.numbers`):
- "program": the program's timed path, `wavefront.render_tiles` at the
  cell's sizes: the lower readings;
- "control": the reference itself in the program's place, computed with
  every float32 result rounded to bfloat16 (`lowprec.py`), the step below
  the configuration's float32: the upper readings;
and prints one JSON line a seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: str, seeds: list, device: str = "cuda",
             overrides: dict | None = None) -> list:
    import torch

    from portbench import check, harness
    from portbench.lowprec import Bfloat16Results

    spec = harness.cell_spec(cell, overrides)
    chk = spec["check"]
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene import build as buildmod

    ref = check.Reference(spec["scene"], device, spec["reference"])
    # the control's own tables: an in-place rounding must not reach the
    # reference's
    low_ref = check.Reference(spec["scene"], device, spec["reference"])
    scene = buildmod.build(spec["scene"], device=device)
    accel = tracemod.build(scene.geometry)
    rows = []
    for seed in seeds:
        live, checked = check.blocks(seed, spec["xres"], spec["yres"],
                                     chk["blocks"], chk["block"])
        idx = torch.nonzero(checked).reshape(-1)
        t = time.perf_counter()
        want, names = ref.frame(seed, spec, live, idx)
        row = {"seed": seed, "reference_s": time.perf_counter() - t}
        want_p = check.planes(want, names)
        fb = wavefront.render_tiles(
            scene, accel, seed=seed, tile_pixels=spec["tile_pixels"],
            aa_samples=spec["aa"], xres=spec["xres"], yres=spec["yres"],
            rr_refr_start=spec["rr_refr_start"])
        got = check.gather(fb, idx.to(fb.image.device)).cpu().numpy()
        row["program"] = check.numbers(check.planes(got, fb.names), want_p,
                                       chk["atol"], chk["rtol"])
        del fb
        t = time.perf_counter()
        with Bfloat16Results():
            low, names_low = low_ref.frame(seed, spec, live, idx)
        row["control_s"] = time.perf_counter() - t
        row["control"] = check.numbers(check.planes(low, names_low), want_p,
                                       chk["atol"], chk["rtol"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "portbench" / "reference", ROOT):
        sys.path.insert(0, str(p))
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(args.workload, seeds, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
