"""Two versions of the ray-query kernels in turns on one card.

Run from the repository root, with another version of the package (its
`rlshaders_tpu_torch/` directory) unpacked below a directory that
.gitignore lists:

    git archive <commit> rlshaders_tpu_torch | tar -x -C parent_tree
    python3 kernel_turns.py parent_tree [results.json]

The other version is imported as `rls_parent`, with its own wrappers and
kernels, built from its own source. Its wrappers take the tables it packs
itself (`pack`), or, in a version from before packed tables, the
structure-of-arrays tables (tree, tris). Both are
given the same queries: every query of chip_smoke.py's 256x256 demo frame
and of its 64x64, AA 3 glass frame with roulette from depth 2 (captured
with this tree's package), and the two j_walk sets. For each kernel and
shape, in turns (parent, this tree, this tree, parent):

- device_ms: the shape's queries captured in one CUDA graph, replays timed
  with CUDA events (chip_smoke.device_ms);
- call_ms: the same queries as eager wrapper calls, timed with CUDA events;
- torch.profiler's sum of the kernel's launches over one eager pass.

Then the demo (256x256, AA 2), glass (256x256, AA 3), skin close-up
(256x256, AA 2), Disney spheres and textured (256x256, AA 3, their own
options) frames, each rendered twice by each package's own render(), in
turns. Prints the
card and writes everything to results.json (by default
out/kernel_turns.json).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from functools import partial

import torch

import chip_smoke as cs

PARENT = "rls_parent"
SHAPES = ("demo", "glass", "jwalk_coherent", "jwalk_incoherent")


def load_parent(root: str):
    """The package under root/rlshaders_tpu_torch, imported as
    `rls_parent` (its imports inside the package are relative)."""
    pkg = os.path.join(os.path.abspath(root), "rlshaders_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        PARENT, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = mod
    spec.loader.exec_module(mod)
    return mod


def sub(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def queries(gscene, gaccel, dscene, daccel) -> dict:
    """{shape: {kernel: [(o, d, t_max, exclude, vis_mask), ...]}} with the
    accel each shape runs on."""
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.integrator import camera as cameramod
    from rlshaders_tpu_torch.integrator import wavefront

    out = {}
    for shape, (scene, accel, kw) in {
        "demo": (dscene, daccel, dict(aa_samples=cs.AA, xres=cs.SIZE,
                                      yres=cs.SIZE)),
        "glass": (gscene, gaccel, dict(aa_samples=cs.GLASS_AA,
                                       xres=cs.GLASS_CHECK,
                                       yres=cs.GLASS_CHECK,
                                       rr_refr_start=cs.GLASS_RR)),
    }.items():
        calls = cs.capture_queries(scene, accel, wavefront, tracemod, **kw)
        out[shape] = (accel, {k: [c[1:] for c in calls if c[0] == k]
                              for k in cs.REPLACES})
    n = cs.JWALK_RAYS
    tmax = torch.full((n,), 1e30, device=cs.DEVICE)
    ex = torch.full((n,), -1, dtype=torch.int32, device=cs.DEVICE)
    jsets = cs.jwalk_rays(gscene, gaccel, tracemod, rng, cameramod)
    for tag, (o, d) in jsets.items():
        out[f"jwalk_{tag}"] = (gaccel, {k: [(o, d, tmax, ex, 0xFF)]
                                        for k in cs.REPLACES})
    return out


def wrappers(old, new, accel) -> dict:
    """{version: {kernel: fn(o, d, t_max, exclude, vis_mask)}}. A version
    with packed tables (`pack`) gets them packed by its own code; an older
    one takes the structure-of-arrays tables."""
    tables = ((old.pack(accel.tree, accel.tris),) if hasattr(old, "pack")
              else (accel.tree, accel.tris))
    p = accel.packed
    return {
        "parent": {"rls_nearest": partial(old.nearest, *tables),
                   "rls_occluded": partial(old.occluded, *tables)},
        "this": {"rls_nearest": partial(new.nearest, p),
                 "rls_occluded": partial(new.occluded, p)},
    }


def main(root: str, results: str) -> int:
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.ops import intersect as new
    from rlshaders_tpu_torch.scene.build import build
    from rlshaders_tpu_torch.scene.demo import demo_scene

    t_start = time.perf_counter()
    card = cs.card_line()
    cs.log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} "
           f"| torch {torch.__version__} cuda {torch.version.cuda}")
    parent = load_parent(root)
    old = sub(PARENT, "ops.intersect")
    cs.log(f"built parent {old.build()} and this tree {new.build()}")

    dscene, daccel = demo_scene(skin=False)
    gscene = build(cs.GLASS)
    gaccel = tracemod.build(gscene.geometry)
    qs = queries(gscene, gaccel, dscene, daccel)
    result = {"card": card, "kernels": {}, "frames": {}}

    reps = {"demo": 10, "glass": 3, "jwalk_coherent": 50,
            "jwalk_incoherent": 50}
    for shape in SHAPES:
        accel, mine = qs[shape]
        fns = wrappers(old, new, accel)
        for k in cs.REPLACES:
            q = mine[k]
            rec = {"launches": len(q), "rays": sum(x[0].shape[0] for x in q),
                   "device_ms": {"parent": [], "this": []},
                   "call_ms": {"parent": [], "this": []}, "profiled_ms": {}}
            for ver in ("parent", "this", "this", "parent"):
                dm, cm = cs.kernel_ms(fns[ver][k], q, reps[shape])
                rec["device_ms"][ver].append(dm)
                rec["call_ms"][ver].append(cm)
            for ver in ("parent", "this"):
                rec["profiled_ms"][ver] = cs.profiled_ms(
                    partial(cs.run_all, fns[ver][k], q),
                    k[len("rls_"):] + "_kernel")
            result["kernels"][f"{k} {shape}"] = rec
            n = len(q)
            cs.log(f"{k} {shape}: {n} launches, {rec['rays']} rays; device "
                   f"ms parent {rec['device_ms']['parent']} this "
                   f"{rec['device_ms']['this']}; call ms parent "
                   f"{rec['call_ms']['parent']} this {rec['call_ms']['this']}"
                   f"; profiled ms {rec['profiled_ms']}; per launch (us, "
                   f"first turn) device {rec['device_ms']['parent'][0] / n * 1e3:.2f}"
                   f" -> {rec['device_ms']['this'][0] / n * 1e3:.2f}, call "
                   f"{rec['call_ms']['parent'][0] / n * 1e3:.2f} -> "
                   f"{rec['call_ms']['this'][0] / n * 1e3:.2f}")

    pscene = sub(PARENT, "scene.build").build(cs.GLASS)
    pskin = sub(PARENT, "scene.build").build(cs.SKIN)
    ptrace = sub(PARENT, "accel.trace")
    sscene = build(cs.SKIN)

    def both(path):
        out = {}
        for ver, pkg, tr in (("parent", PARENT, ptrace),
                             ("this", "rlshaders_tpu_torch", tracemod)):
            sc = sub(pkg, "scene.build").build(path)
            out[ver] = (sub(pkg, "integrator.wavefront"), sc,
                        tr.build(sc.geometry))
        return out

    frames = {
        "demo": {"parent": (sub(PARENT, "integrator.wavefront"),
                            *sub(PARENT, "scene.demo").demo_scene(
                                skin=False)),
                 "this": (sub("rlshaders_tpu_torch", "integrator.wavefront"),
                          dscene, daccel)},
        "glass": {"parent": (sub(PARENT, "integrator.wavefront"), pscene,
                             ptrace.build(pscene.geometry)),
                  "this": (sub("rlshaders_tpu_torch", "integrator.wavefront"),
                           gscene, gaccel)},
        "skin": {"parent": (sub(PARENT, "integrator.wavefront"), pskin,
                            ptrace.build(pskin.geometry)),
                 "this": (sub("rlshaders_tpu_torch", "integrator.wavefront"),
                          sscene, tracemod.build(sscene.geometry))},
        "disney": both(cs.DISNEY),
        "textured": both(cs.TEXTURED),
    }
    aa = {"demo": cs.AA, "glass": cs.GLASS_AA, "skin": cs.AA,
          "disney": cs.DISNEY_AA, "textured": cs.TEXTURED_AA}
    for shape, vers in frames.items():
        secs = {"parent": [], "this": []}
        for ver in ("parent", "this", "this", "parent") * 2:
            wf, scene, accel = vers[ver]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wf.render(scene, accel, seed=cs.SEED, aa_samples=aa[shape],
                      xres=cs.SIZE, yres=cs.SIZE)
            torch.cuda.synchronize()
            secs[ver].append(time.perf_counter() - t0)
        result["frames"][shape] = secs
        cs.log(f"{shape} frame {cs.SIZE}x{cs.SIZE} AA {aa[shape]} seconds: "
               f"{secs}")
    del parent

    os.makedirs(os.path.dirname(os.path.abspath(results)), exist_ok=True)
    with open(results, "w") as f:
        json.dump(result, f, indent=1)
    cs.log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2] if len(sys.argv) == 3
                  else os.path.join("out", "kernel_turns.json")))
