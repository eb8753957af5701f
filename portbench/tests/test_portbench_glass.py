"""The glass-sphere configuration on the CPU: the frozen reference equals
the program's render of its scene, with roulette off and from refraction
depth 2, and a traced run of `glass.frame512` at a tiny size reads the
new per-layer metrics.

The frames are 8x8 at AA 3 with the configuration's own depths (each
render some 25 s on a CPU: a frame's time is its tile's 462 query calls,
not its pixels). Both sides take the plain walk over trees whose leaves
may hold their triangles in another order (`test_portbench_reference.
py`); no tie between two hits goes the other way at this size, and the
frames agree in every value."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
sys.path[:0] = [str(ROOT), str(BENCH / "reference")]

from portbench import counters, harness, stages  # noqa: E402

SCENE = BENCH / "configs" / "glass_sphere.ass"
SEED = 2 ** 31 + 4099
NEW = ("refract_device_ms", "march_device_ms", "refr_live_share")


@pytest.mark.parametrize("rr_refr_start", [99, 2])
def test_reference_equals_program(rr_refr_start):
    from rlsref.accel import trace as rtrace
    from rlsref.integrator import wavefront as rwave
    from rlsref.scene import build as rbuild

    from rlshaders_tpu_torch.accel import trace
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene import build

    kw = dict(seed=2 ** 31 + 77, aa_samples=3, xres=8, yres=8,
              tile_pixels=64, rr_refr_start=rr_refr_start)
    scene = build.build(str(SCENE), device="cpu")
    prog = wavefront.render(scene, trace.build(scene.geometry), **kw)
    rscene = rbuild.build(str(SCENE), device="cpu")
    ref = rwave.render(rscene, rtrace.build(rscene.geometry), **kw)
    assert prog["__stats__"] == ref["__stats__"]
    assert prog["__stats__"]["march_segments"] > 0
    for name in prog:
        if name != "__stats__":
            np.testing.assert_array_equal(prog[name].numpy(),
                                          ref[name].numpy(), err_msg=name)
    assert float(prog["refraction"].mean()) > 0.01


def test_traced_run_reads_the_refraction_metrics():
    """On the CPU the span readers find no device reading and return
    nothing; the counted frame gives the share of live refraction
    lanes."""
    spec = harness.cell_spec("glass.frame512")
    assert (spec["xres"], spec["yres"], spec["aa"], spec["rr_refr_start"],
            spec["tile_pixels"]) == (512, 512, 3, 2, 262144)
    chk = dict(spec["check"], blocks=2, block=4)
    line = harness.run("glass.frame512", SEED, 0.01, 1, device="cpu",
                       overrides={"xres": 8, "yres": 8, "aa": 1,
                                  "tile_pixels": 64, "check": chk})
    assert line["correct"] is True
    m = line["metrics"]
    assert 0.0 < m["refr_live_share"]["value"] <= 100.0
    assert m["refr_live_share"]["unit"] == "%"
    assert not {"refract_device_ms", "march_device_ms"} & set(m)


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    monkeypatch.setattr(stages, "TRACER", "rlshaders_tpu_torch.core.nope")
    monkeypatch.setattr(counters, "TRACER", "rlshaders_tpu_torch.core.nope")
    ctx = SimpleNamespace(spec={"chips": 1}, res={}, card=None)
    assert [harness.reader(n).read(ctx) for n in NEW] == [None] * 3
    assert ctx.stages is None and ctx.counters is None


def test_a_program_without_the_new_spans_or_counters_reads_nothing():
    """The parent's program: spans and counters, but none of these."""
    ctx = SimpleNamespace(spec={"chips": 1}, res={}, card=None,
                          stages={"device_ms": {"generation": 3.0}},
                          counters={"lanes": 10, "live_lanes": 4})
    assert [harness.reader(n).read(ctx) for n in NEW] == [None] * 3
