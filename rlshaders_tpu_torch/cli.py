"""Command-line renderer and testsuite harness of the port.

    python -m rlshaders_tpu_torch.cli render scene.ass -o out.exr

Counterpart of rlshaders_tpu/cli.py, with its subcommands and options:
`render` is the kick-equivalent entry point (`kick -i scene.ass -o
out.exr`); `test` renders each case of a testsuite and gates on RMS error
< 0.005 against the case's golden (the reference's runtest.py); `list`,
`mkdir`, `display`, `dcc` and `patterns` as in the JAX package.
Differences, all deliberate:

* `render`, `test` and `patterns` take `--device` (default cuda): the card
  unless the caller asks for the CPU; without a card, torch's own error;
* the stats line counts the rays the port handed to its two ray queries,
  over every pass (the JAX counter counts each family ray twice, and its
  line counts the last pass only);
* `render --profile` passes `profile=True` to the renderer (the JAX
  package reads RLS_PROFILE) and traces with torch.profiler into
  `<output>_trace/trace.json` (the card's activity on a CUDA scene),
  printing the five CUDA kernels with the most device time;
* `display` writes its PNG sheets and `test` resizes a render with
  `io/png.py`, not PIL;
* `--suite` defaults to `testsuite` in the working directory.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

import numpy as np

RAYS_HELP = ("the stats line counts the rays handed to the nearest and "
             "any-hit queries over all passes (the JAX package's counter "
             "counts each family ray twice, and only the last pass)")


def _build(scene_path: str, device: str):
    from .accel import trace as tracemod
    from .scene import build as buildmod

    scene = buildmod.build(scene_path, device=device)
    accel = tracemod.build(scene.geometry)
    return scene, accel


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host(out: dict) -> dict:
    """The planes of a render as numpy arrays (one copy each), and its
    stats."""
    return {k: (v if k == "__stats__" or isinstance(v, np.ndarray)
                else v.cpu().numpy()) for k, v in out.items()}


def _profiled(fn, trace_path: str, device):
    """Run fn under torch.profiler and write its Chrome trace to
    trace_path; on the card, print the five CUDA kernels with the most
    device time. Returns fn's result.

    A CUDA scene records the card's activity (its kernels, and the CUDA
    runtime calls that launch them on the host), a CPU scene the CPU's.
    The CPU's activity is not recorded beside the card's: it adds about 40
    events a torch op, some twenty million for a 256x256 frame at AA 3,
    whose parsing alone takes minutes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        out = fn()
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    print(f"[rls] profile trace -> {trace_path}")
    if cuda:
        # the raw events: turning a frame's million events into
        # FunctionEvents (`prof.events()`, `key_averages()`) takes a minute
        ms, count = {}, {}
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if (e.device_type() == torch.autograd.DeviceType.CUDA
                    and not name.startswith(("Memcpy", "Memset"))):
                ms[name] = ms.get(name, 0.0) + e.duration_ns() / 1e6
                count[name] = count.get(name, 0) + 1
        for name in sorted(ms, key=ms.get, reverse=True)[:5]:
            print(f"[rls]   kernel {ms[name]:10.4f} ms x{count[name]:<7d} "
                  f"{name[:100]}")
    return out


def cmd_render(args):
    from .integrator import wavefront
    from .io import exr

    t0 = time.time()
    scene, tree = _build(args.scene, args.device)
    t_build = time.time() - t0
    vis = scene.geometry.visibility
    n_tris = int(((vis & 0xFF) != 0).sum())     # bits 8.. are trace sets
    print(f"[rls] scene: {n_tris} tris "
          f"(tables {vis.shape[0]}), "
          f"{len(scene.material_names)} materials, build {t_build:.2f}s")

    def run():
        """The planes and the render's seconds."""
        t0 = time.time()
        if args.passes > 1:
            out = wavefront.render_progressive(
                scene, tree, args.passes, seed=args.seed,
                tile_pixels=args.tile, aa_samples=args.aa, xres=args.res,
                yres=args.res, flush_path=args.output, profile=args.profile)
        else:
            out = wavefront.render(
                scene, tree, seed=args.seed, tile_pixels=args.tile,
                aa_samples=args.aa, xres=args.res, yres=args.res,
                profile=args.profile)
        _sync(scene.device)
        return out, time.time() - t0

    if args.profile:
        trace = os.path.join(os.path.splitext(args.output)[0] + "_trace",
                             "trace.json")
        out, t_render = _profiled(run, trace, scene.device)
    else:
        out, t_render = run()
    out = _host(out)
    img = out["RGBA"]
    stats = out.pop("__stats__", {})
    timed = sorted(
        (k[2:], v, stats.get("n_" + k[2:], 0))
        for k, v in stats.items() if k.startswith("t_")
    )
    for name, tsec, cnt in timed:
        print(f"[rls]   stage {name:12s} {tsec:8.2f}s  x{cnt}")
    aa = args.aa or scene.options.aa_samples
    n_samples = img.shape[0] * img.shape[1] * aa * aa
    passes = max(args.passes, 1)
    shadow = stats.get("shadow_rays", 0) * passes
    total_rays = stats.get("nearest_rays", 0) * passes + shadow
    print(f"[rls] render {img.shape[1]}x{img.shape[0]} aa={aa} "
          f"in {t_render:.2f}s "
          f"| {n_samples/1e6:.2f} Mcam-samples "
          f"| {total_rays/1e6:.1f} Mrays ({shadow/1e6:.1f} shadow) "
          f"| {total_rays / max(t_render, 1e-9) / 1e6:.2f} Mrays/s")

    exr.write_rgb(args.output, img)
    print(f"[rls] wrote {args.output}")
    if args.aovs:
        base, ext = os.path.splitext(args.output)
        for name, aov in out.items():
            if name == "RGBA":
                continue
            exr.write_rgb(f"{base}.{name}{ext}", aov)
            print(f"[rls] wrote {base}.{name}{ext}")
    return 0


def _expand_serial_no(spec: str):
    """Expand a case spec into 4-digit case ids. Supports the reference
    harness's serial-range syntax (runtest.py expand_serial_no, :30-43):
    comma-separated items, each a number or an inclusive `a..b` range —
    e.g. "1..3,9" -> 0001 0002 0003 0009."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if ".." in item:
            a, b = item.split("..")
            out.extend(f"{n:04d}" for n in range(int(a), int(b) + 1))
        else:
            out.append(f"{int(item):04d}")
    return out


def _golden_noise_floor(ref: np.ndarray, test: np.ndarray, wm) -> float:
    """Estimate the golden's own per-pixel MC noise as an rmse floor.

    3x3 box high-pass of both images over the non-watermark pixels: for
    white noise the high-pass passes sqrt(8)/3 of the noise sigma; real
    image structure appears in BOTH high-passes, so the golden's EXCESS
    high-pass energy over ours estimates its noise (docs/fidelity.md)."""
    def hp_sq(img):
        g = img.mean(-1)
        p = np.pad(g, 1, mode="edge")
        sm = sum(
            p[1 + dy:(p.shape[0] - 1 + dy), 1 + dx:(p.shape[1] - 1 + dx)]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)
        ) / 9.0
        return (g - sm) ** 2

    m = ~wm if (wm is not None and wm.shape == ref.shape[:2]) else np.ones(
        ref.shape[:2], bool)
    excess = np.maximum(hp_sq(ref)[m].mean() - hp_sq(test)[m].mean(), 0.0)
    return float(np.sqrt(excess) * 3.0 / np.sqrt(8.0))


def cmd_test(args):
    from .integrator import wavefront
    from .io import exr, png
    from .utils import watermark

    suite = args.suite
    cases = (
        _expand_serial_no(args.cases)
        if args.cases
        else sorted(os.listdir(os.path.join(suite, "mtoa")))
    )
    # Every golden carries the Arnold license watermark; the gate is the
    # watermark-masked RMSE against the PINNED mask, the full-frame RMSE
    # beside it. A derived mask that grew past the pinned coverage is
    # reported, and the pinned one still gates.
    wm = watermark.pinned_mask()
    derived = watermark.watermark_mask(suite)
    if (derived is not None
            and derived.mean() > watermark.PINNED_COVERAGE + 1e-6):
        print(f"[rls] WARNING: derived watermark mask coverage "
              f"{derived.mean():.4f} exceeds pinned "
              f"{watermark.PINNED_COVERAGE:.4f}; gating on the PINNED mask")
    results = []
    for case in cases:
        case_dir = os.path.join(suite, "mtoa", case)
        data = os.path.join(case_dir, "data")
        ref_path = os.path.join(case_dir, "ref", "ref.exr")
        readme = os.path.join(case_dir, "README")
        desc = ""
        if os.path.exists(readme):
            with open(readme) as f:
                desc = f.readline().strip()
        scenes = [f for f in os.listdir(data) if f.endswith(".ass")]
        scene_path = os.path.join(data, scenes[0])
        try:
            t0 = time.time()
            scene, tree = _build(scene_path, args.device)
            if args.passes > 1:
                # converged scoring: the mean of independently seeded
                # passes, so the measured RMSE is bias, not MC variance;
                # with --save the running mean is flushed after each pass
                flush = None
                if args.save:
                    os.makedirs("out", exist_ok=True)
                    flush = os.path.join("out", f"conv_{case}.exr")
                out = wavefront.render_progressive(
                    scene, tree, passes=args.passes, aa_samples=args.aa,
                    tile_pixels=args.tile, verbose=True, flush_path=flush)
            else:
                out = wavefront.render(
                    scene, tree, aa_samples=args.aa, tile_pixels=args.tile)
            out.pop("__stats__", None)
            test = _host({"RGBA": out["RGBA"]})["RGBA"]
            dt = time.time() - t0
            ref = exr.read_rgb(ref_path)
            if test.shape != ref.shape:
                im = (np.clip(test, 0, 1) * 255).astype(np.uint8)
                test = png.resize(im, ref.shape[1::-1]).astype(
                    np.float32) / 255
            err = exr.rmse(ref, test)
            if wm is not None and ref.shape[:2] == wm.shape:
                diff = (ref - test)[~wm]
                err_gate = float(np.sqrt(np.mean(diff * diff)))
            else:
                err_gate = err
            ok = err_gate < args.threshold
            # the goldens carry their own Monte-Carlo noise; the implied
            # floor is the rmse a noise-free render would still measure
            flo = _golden_noise_floor(ref, test, wm)
            cov = float(wm.mean()) if wm is not None else 0.0
            results.append((case, desc, ok, err_gate, err, flo, cov, dt))
            print(f"[{case}] {'OK  ' if ok else 'FAIL'} "
                  f"rmse={err_gate:.5f} (full {err:.5f}, watermark-masked "
                  f"{cov*100:.1f}%, "
                  f"golden-noise floor ~{flo:.5f}) "
                  f"{dt:.1f}s  {desc}")
            if args.save:
                # never into the (read-only) suite: the repo-local out/
                os.makedirs("out", exist_ok=True)
                exr.write_rgb(os.path.join("out", f"test_{case}.exr"), test)
        except Exception as e:  # noqa: BLE001 - one case's fault is its row
            results.append((case, desc, False, float("nan"), float("nan"),
                            float("nan"), 0.0, 0.0))
            print(f"[{case}] ERROR {type(e).__name__}: {e}")
            traceback.print_exc()
    n_ok = sum(1 for r in results if r[2])
    print(f"\n{n_ok}/{len(results)} passed (gate rmse < {args.threshold})")
    if args.report:
        with open(args.report, "w") as f:
            f.write("case,desc,status,masked_rmse,full_rmse,"
                    "golden_noise_floor,mask_coverage,seconds\n")
            for case, desc, ok, err, full, flo, cov, dt in results:
                f.write(f"{case},{desc},{'OK' if ok else 'FAIL'},"
                        f"{err:.6f},{full:.6f},{flo:.6f},{cov:.4f},"
                        f"{dt:.1f}\n")
    return 0 if n_ok == len(results) else 1


def cmd_mkdir(args):
    """Create a new testsuite case skeleton (runtest.py mkdir, :83-104):
    mtoa/NNNN/{data/, ref/, README} with the next free serial number."""
    mtoa = os.path.join(args.suite, "mtoa")
    existing = sorted(
        int(d) for d in os.listdir(mtoa) if d.isdigit()
    ) if os.path.isdir(mtoa) else []
    sn = args.sn if args.sn else (existing[-1] + 1 if existing else 1)
    case = os.path.join(mtoa, f"{sn:04d}")
    if os.path.exists(case):
        print(f"[rls] case {case} already exists")
        return 1
    os.makedirs(os.path.join(case, "data"))
    os.makedirs(os.path.join(case, "ref"))
    with open(os.path.join(case, "README"), "w") as f:
        f.write(args.desc + "\n")
    print(f"[rls] created {case}")
    return 0


def cmd_dcc(args):
    """Export DCC integration files (.mtd UI metadata + Maya AE templates),
    generated from the shader registry."""
    from .models import dcc

    for path in dcc.export(args.outdir):
        print(f"[rls] wrote {path}")
    return 0


def cmd_display(args):
    """Write side-by-side ref|test|5x-diff PNG sheets per case (the headless
    stand-in for runtest.py display's `iv` viewer, runtest.py:246-254)."""
    from .io import exr, png

    cases = (
        [f"{int(c):04d}" for c in args.cases.split(",")]
        if args.cases
        else sorted(os.listdir(os.path.join(args.suite, "mtoa")))
    )
    os.makedirs(args.outdir, exist_ok=True)
    for case in cases:
        ref_p = os.path.join(args.suite, "mtoa", case, "ref", "ref.exr")
        test_p = os.path.join(args.suite, "mtoa", case, "ref", "test_tpu.exr")
        if not (os.path.exists(ref_p) and os.path.exists(test_p)):
            print(f"[{case}] missing ref/test exr, skip")
            continue
        ref = exr.read_rgb(ref_p)
        test = exr.read_rgb(test_p)
        err = np.sqrt(((ref - test) ** 2).mean(-1, keepdims=True)) * 5.0
        sheet = np.concatenate(
            [ref, test, np.repeat(err, 3, axis=-1)], axis=1
        )
        srgb = (np.clip(sheet, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)
        out = os.path.join(args.outdir, f"{case}.png")
        png.write_png(out, srgb)
        print(f"[{case}] -> {out}")
    return 0


def cmd_list(args):
    """List testsuite cases with their descriptions (runtest.py `list`)."""
    mtoa = os.path.join(args.suite, "mtoa")
    for case in sorted(os.listdir(mtoa)):
        readme = os.path.join(mtoa, case, "README")
        desc = ""
        if os.path.exists(readme):
            with open(readme) as f:
                desc = f.readline().strip()
        print(f"{case}  {desc}")
    return 0


def cmd_patterns(args):
    """Dump BRDF radiance + sampling-pattern images over a roughness sweep —
    the reference's disabled node_initialize harness (rlGgx.cpp:202-224)."""
    import torch

    from .bsdf import ggx
    from .core.vec3 import V3
    from .utils import sample_writer

    dev = torch.device(args.device)
    t = float(np.deg2rad(args.theta))
    wo = V3(*(torch.tensor(c, dtype=torch.float32, device=dev)
              for c in (np.sin(t), 0.0, np.cos(t))))
    white = V3(*(torch.ones((), device=dev) for _ in range(3)))
    os.makedirs(args.outdir, exist_ok=True)
    for i in range(args.steps):
        rough = (i + 0.5) / args.steps
        # the JAX package's make_params(ones(3), rough, ior): isotropic,
        # entering, white specular color
        p = ggx.make_params(torch.tensor(rough, device=dev),
                            torch.tensor(args.ior, device=dev),
                            torch.tensor(0.0, device=dev),
                            torch.tensor(True, device=dev))

        def sample_fn(wos, rx, ry):
            wi, _ = ggx.sample(p, wos, rx, ry)
            return wi

        def eval_fn(wos, wi):
            return ggx.eval_brdf(p, wos, wi, white)

        path = os.path.join(args.outdir, f"ggx_is.roughness.{i:04d}.exr")
        missing = sample_writer.write_pattern(
            path, eval_fn, sample_fn, wo, count=args.count
        )
        print(f"[rls] {path}  roughness={rough:.3f}  missing={missing}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rlshaders_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a .ass scene to EXR",
                       epilog=RAYS_HELP)
    r.add_argument("scene")
    r.add_argument("-o", "--output", default="out.exr")
    r.add_argument("--res", type=int, default=None)
    r.add_argument("--aa", type=int, default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--passes", type=int, default=1,
                   help="spp chunks; partial results flushed after each")
    r.add_argument("--tile", type=int, default=8192)
    r.add_argument("--aovs", action="store_true", help="write AOV images too")
    r.add_argument("--profile", action="store_true",
                   help="per-stage wall timing + torch.profiler trace dump")
    r.add_argument("--device", default="cuda",
                   help="where the scene and the render live (cuda, cpu)")
    r.set_defaults(fn=cmd_render)

    t = sub.add_parser("test", help="run the golden-image testsuite")
    t.add_argument("--suite", default="testsuite")
    t.add_argument("--cases", default=None,
                   help="case numbers: comma list and/or a..b ranges (1..5,9)")
    t.add_argument("--aa", type=int, default=None)
    t.add_argument("--passes", type=int, default=1,
                   help=">1 = converged scoring: average N seeded passes")
    t.add_argument("--tile", type=int, default=8192)
    t.add_argument("--threshold", type=float, default=0.005)
    t.add_argument("--save", action="store_true")
    t.add_argument("--report", default=None)
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_test)

    ls = sub.add_parser("list", help="list testsuite cases")
    ls.add_argument("--suite", default="testsuite")
    ls.set_defaults(fn=cmd_list)

    mk = sub.add_parser("mkdir", help="create a new testsuite case skeleton")
    mk.add_argument("--suite", default="testsuite")
    mk.add_argument("--sn", type=int, default=0,
                    help="serial number (default: next)")
    mk.add_argument("--desc", default="new test case")
    mk.set_defaults(fn=cmd_mkdir)

    dp = sub.add_parser("display",
                        help="write ref|test|diff comparison sheets")
    dp.add_argument("--suite", default="testsuite")
    dp.add_argument("--cases", default=None)
    dp.add_argument("--outdir", default="display")
    dp.set_defaults(fn=cmd_display)

    dc = sub.add_parser("dcc", help="export .mtd + Maya AE templates")
    dc.add_argument("--outdir", default="dcc")
    dc.set_defaults(fn=cmd_dcc)

    pp = sub.add_parser("patterns", help="dump sampling-pattern diagnostics")
    pp.add_argument("--outdir", default="patterns")
    pp.add_argument("--steps", type=int, default=9)
    pp.add_argument("--theta", type=float, default=45.0)
    pp.add_argument("--ior", type=float, default=1.5)
    pp.add_argument("--count", type=int, default=2500)
    pp.add_argument("--device", default="cuda")
    pp.set_defaults(fn=cmd_patterns)

    args = ap.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
