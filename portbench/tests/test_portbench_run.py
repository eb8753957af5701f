"""The benchmark's command without a card, and the rest of a run on the
CPU at a tiny size: a sound run comes out correct, and a run whose timed
path is broken underneath comes out not correct, once for each fault a
one-chip cell can have."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
sys.path[:0] = [str(ROOT), str(BENCH / "reference")]

from portbench import harness  # noqa: E402

SEED = 2 ** 31 + 4099
# (xres, yres, tile_pixels): the one-tile frame, and a frame of four tiles
# whose last is padded
TINY = {"disney.frame512": (12, 12, 144), "disney.hd": (16, 9, 40)}


def command(cwd: Path, cell: str = "disney.frame512"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_no_result():
    out = command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cannot measure" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def tiny(cell: str) -> dict:
    xres, yres, tile = TINY[cell]
    chk = dict(harness.cell_spec(cell)["check"], blocks=2, block=4)
    return {"xres": xres, "yres": yres, "tile_pixels": tile, "check": chk}


def run(cell: str, trace: int = 0) -> dict:
    return harness.run(cell, SEED, 0.01, trace, device="cpu",
                       overrides=tiny(cell))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"frame_s", "setup_s"}
    assert list(line)[-1] == "checks"
    for v in line["checks"].values():
        assert v["value"] <= v["limit"]


def test_traced_run_reads_counts_and_spans():
    line = run("disney.hd", trace=1)
    assert line["correct"] is True
    m = line["metrics"]
    # no device trace on the CPU: those readers find nothing
    assert {"build_s", "tile_s", "query_rays"} <= set(m)
    assert not {"idle_share", "query_roofline", "kernels_per_frame"} & set(m)


def stale_seed(monkeypatch, cell):
    """Every frame rendered with the seed of the first (set-up's warm
    frame): the frame's state returned unchanged."""
    from rlshaders_tpu_torch.integrator import wavefront

    real = wavefront.render_tiles
    first = {}

    def render_tiles(*a, seed=0, **kw):
        return real(*a, seed=first.setdefault("seed", seed), **kw)

    monkeypatch.setattr(wavefront, "render_tiles", render_tiles)


def half_samples(monkeypatch, cell):
    """Half of each pixel's samples left out of the splat, the pixel the
    mean over the rest."""
    from rlshaders_tpu_torch.integrator import splat

    real = splat.splat_accum
    n_sub = harness.cell_spec(cell)["aa"] ** 2

    def splat_accum(vals, pixel, sub_xy, *a, **kw):
        lane = torch.arange(pixel.shape[0], device=pixel.device)
        drop = (lane % n_sub) >= (n_sub + 1) // 2
        return real(vals, torch.where(drop, -1, pixel), sub_xy, *a, **kw)

    monkeypatch.setattr(splat, "splat_accum", splat_accum)


def altered_answer(monkeypatch, cell):
    """Each sample's RGB altered where the generation tree produces it."""
    from rlshaders_tpu_torch.integrator import wavefront

    real = wavefront._tile

    def _tile(*a, **kw):
        rgb, aovs, sss_in = real(*a, **kw)
        return rgb * 1.05, aovs, sss_in

    monkeypatch.setattr(wavefront, "_tile", _tile)


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("fault", [stale_seed, half_samples, altered_answer],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    line = run(cell)
    assert line["correct"] is False, json.dumps(line["checks"])


def test_two_chips_through_the_mesh():
    """A cell with `chips` 2 runs through parallel/mesh.py's `launch` and
    `render_sharded` (gloo on the CPU), and the frame is the whole frame."""
    over = tiny("disney.frame512")
    over.update(chips=2, tile_pixels=36)
    line = harness.run("disney.frame512", SEED, 0.01, 0, device="cpu",
                       overrides=over)
    assert line["correct"] is True
    assert line["device"]["count"] == 2


def test_bound_arithmetic():
    from portbench import roofline

    q = {"rays": 10, "live": 8, "boxes": 100, "tris": 40, "nodes": 3,
         "slots": 5}
    nbytes = 8 * 48 + 2 * 20 + 3 * 36 + 5 * 45
    ops = 9 * 8 + 25 * 100 + 53 * 40
    want = max(nbytes / 3.35e12, ops / 67e12) * 1e3
    assert roofline.bound_ms("rls_nearest", q) == pytest.approx(want)
    assert roofline.is_query("void nearest_kernel<1>(Query)")
    assert not roofline.is_query("void at::native::vectorized_gather_kernel")


def test_query_counts_scale_to_the_frame():
    """The sampled walk's counts, scaled, come near the whole frame's, and
    the rays handed to each kernel are counted exactly."""
    from types import SimpleNamespace

    from portbench import roofline
    from rlshaders_tpu_torch.accel import trace
    from rlshaders_tpu_torch.scene import build

    spec = harness.cell_spec("disney.frame512", tiny("disney.frame512"))
    spec.update(seed=SEED, device="cpu", trace=0)
    scene = build.build(spec["scene"], device="cpu")
    ctx = SimpleNamespace(spec=spec, device=torch.device("cpu"), trace=False,
                          mesh=None, scene=scene,
                          accel=trace.build(scene.geometry),
                          idx=torch.arange(4))
    whole = roofline.capture_and_count(ctx, spec, harness._frame, 1.0)
    part = roofline.capture_and_count(ctx, spec, harness._frame, 0.25)
    for k in whole:
        assert part[k]["rays"] == whole[k]["rays"] > 0
        for f in ("live", "boxes", "tris"):
            assert part[k][f] == pytest.approx(whole[k][f], rel=0.25), (k, f)
        assert 0 < part[k]["nodes"] <= whole[k]["nodes"]


def test_query_capture_must_see_every_ray(monkeypatch):
    """A frame whose queries bypass `accel.trace`'s functions (here: half
    of the nearest rays) fails the capture, and so the traced run."""
    from types import SimpleNamespace

    from portbench import roofline
    from rlshaders_tpu_torch.accel import trace
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene import build

    spec = harness.cell_spec("disney.frame512", tiny("disney.frame512"))
    spec.update(seed=SEED, device="cpu", trace=0)
    scene = build.build(spec["scene"], device="cpu")
    ctx = SimpleNamespace(spec=spec, device=torch.device("cpu"), trace=False,
                          mesh=None, scene=scene,
                          accel=trace.build(scene.geometry),
                          idx=torch.arange(4))
    real = wavefront._nearest

    def _nearest(sc, o, d, *a, **kw):
        sc.stats["nearest_rays"] += o.shape[0] - o.shape[0] // 2
        return real(sc, o, d, *a, **kw)

    monkeypatch.setattr(wavefront, "_nearest", _nearest)
    with pytest.raises(roofline.CaptureMissed, match="rls_nearest"):
        roofline.capture_and_count(ctx, spec, harness._frame)


def test_traced_run_needs_the_tile_span(monkeypatch):
    """A traced run in which the harness's span around the program's tile
    stage never opens fails, rather than reading its gaps unlabelled."""
    from rlshaders_tpu_torch.integrator import wavefront

    real = wavefront._tile
    monkeypatch.setattr(harness.Spans, "wrap", lambda self, name, fn: fn)
    with pytest.raises(RuntimeError, match="no 'tile' span"):
        run("disney.frame512", trace=1)
    assert wavefront._tile is real
