"""The port's spans and counters (rlshaders_tpu_torch/core/tracer.py) on
the CPU: off, they record nothing and change no pixel; on, each tile
stage is one `tile` span with the generation tree's stages beneath it;
`live_lanes` is the count of valid hits; the spans share torch.profiler's
host clock; and the attribution of device activity to spans, on
synthetic rows, is a partition that charges each kernel to the innermost
span at its launch and each idle gap to the launch that ended it. On a
reduced glass sphere the refraction spawns and the shadow march are spans
of their own, and the refraction counters count the spawns' lanes and
those roulette left alive; the grid has neither."""
import random
import re
from pathlib import Path

import pytest
import torch

from rlshaders_tpu_torch import cli as tcli
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import tracer
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene import demo as tdemo

ROOT = Path(__file__).resolve().parents[1]

SPANS = {"render", "camera", "tile", "sss", "generation", "surface",
         "material", "bsdf", "light", "rng", "query", "splat"}
# 8x8 at AA 1 in tiles of 16 pixels: four tiles
FRAME = dict(aa_samples=1, xres=8, yres=8, tile_pixels=16)
# the benchmark's glass sphere at refraction depth 2 (roulette from 2
# reaches the chain's second spawn) with no diffuse or glossy families: 16x16
# at AA 1 in one tile, where roulette kills some lanes
GLASS = {"GI_refraction_depth": 2, "GI_diffuse_depth": 0,
         "GI_glossy_depth": 0, "GI_diffuse_samples": 1,
         "GI_glossy_samples": 1}
GLASS_FRAME = dict(aa_samples=1, xres=16, yres=16, tile_pixels=256)


@pytest.fixture(scope="module")
def demo():
    return tdemo.demo_scene(skin=False, device="cpu")


@pytest.fixture(autouse=True)
def clean():
    tracer.take()
    yield
    tracer.take()


def test_off_records_nothing_and_on_changes_no_pixel(demo):
    scene, accel = demo
    off = twave.render(scene, accel, **FRAME)
    assert tracer.take() == ([], {})
    on = twave.render(scene, accel, profile=True, **FRAME)
    rows, counters = tracer.take()
    assert rows and counters == {}
    assert set(off) == set(on)
    for k in off:
        if k != "__stats__":
            assert torch.equal(off[k], on[k]), k
    assert not tracer.TRACER.spans_on and not tracer.TRACER.counters_on


def test_each_tile_is_a_span_with_the_stages_beneath(demo):
    scene, accel = demo
    stats = twave.render(scene, accel, profile=True, **FRAME)["__stats__"]
    rows, _ = tracer.take()
    names = [r[0] for r in rows]
    assert set(names) <= SPANS
    assert names.count("tile") == stats["n_tile"] == stats["tiles"] == 4
    assert [r for r in rows if r[3] < 0] == [rows[0]]
    assert rows[0][0] == "render"

    def chain(i):
        while i >= 0:
            yield rows[i][0]
            i = rows[i][3]

    for i, (name, s, e, parent) in enumerate(rows):
        assert s <= e
        if parent >= 0:
            ps, pe = rows[parent][1:3]
            assert ps <= s and e <= pe, (name, rows[parent][0])
            assert parent < i and rows[parent][0] != name
        if name in ("generation", "surface", "material", "bsdf", "light",
                    "query"):
            assert "tile" in chain(i), name
    below = {rows[i][0] for i in range(len(rows)) if "tile" in
             list(chain(rows[i][3]))}
    assert {"generation", "bsdf", "light", "rng", "query"} <= below
    assert {"camera", "splat"} <= set(names) - below


def test_live_lanes_is_the_count_of_valid_hits(demo, monkeypatch):
    """Every generation of this opaque scene is shaded from one nearest
    query, so `lanes` is the nearest rays and `live_lanes` their hits."""
    scene, accel = demo
    seen = {"rays": 0, "hits": 0}
    real = ttrace.nearest

    def nearest(*a, **kw):
        hit = real(*a, **kw)
        seen["rays"] += hit.tri.shape[0]
        seen["hits"] += int((hit.tri >= 0).sum())
        return hit

    monkeypatch.setattr(ttrace, "nearest", nearest)
    with tracer.enabled(spans=False, counters=True):
        stats = twave.render(scene, accel, **FRAME)["__stats__"]
    rows, counters = tracer.take()
    assert rows == [] and stats["march_segments"] == 0
    assert counters["lanes"] == seen["rays"] == stats["nearest_rays"]
    assert counters["live_lanes"] == seen["hits"]
    assert 0 < counters["live_lanes"] < counters["lanes"]


def glass_scene():
    with open(ROOT / "portbench" / "configs" / "glass_sphere.ass") as f:
        src = f.read()
    for k, v in GLASS.items():
        src, n = re.subn(rf"^ {k} \d+$", f" {k} {v}", src, flags=re.M)
        assert n == 1, k
    scene = tbuild.build_text(src, device="cpu")
    return scene, ttrace.build(scene.geometry)


@pytest.fixture(scope="module")
def glass():
    """Frames of the reduced glass sphere: roulette from 2 with the tracer
    off, and with spans and counters on, each spawn's n * nb recorded;
    roulette off with the counters on."""
    scene, accel = glass_scene()
    tracer.take()
    off = twave.render(scene, accel, rr_refr_start=2, **GLASS_FRAME)
    assert tracer.take() == ([], {})
    spawned = []
    real = twave._refr_t

    def refr_t(*args, **kwargs):
        spawned.append(args[4].x.shape[0] * args[9])
        return real(*args, **kwargs)

    twave._refr_t = refr_t
    try:
        with tracer.enabled(spans=True, counters=True):
            on = twave.render(scene, accel, rr_refr_start=2, **GLASS_FRAME)
    finally:
        twave._refr_t = real
    rows, counters = tracer.take()
    with tracer.enabled(counters=True):
        twave.render(scene, accel, rr_refr_start=99, **GLASS_FRAME)
    _, no_rr = tracer.take()
    return dict(off=off, on=on, rows=rows, counters=counters, no_rr=no_rr,
                spawned=spawned)


def test_glass_refract_and_march_rows_nest_inside_tile(glass):
    rows = glass["rows"]
    names = [r[0] for r in rows]
    assert set(names) <= SPANS | {"refract", "march"}
    assert names.count("tile") == 1

    def chain(i):
        while i >= 0:
            yield rows[i][0]
            i = rows[i][3]

    for name in ("refract", "march"):
        at = [i for i, n in enumerate(names) if n == name]
        assert at, name
        for i in at:
            assert "tile" in chain(rows[i][3]), name
            assert name not in chain(rows[i][3]), name
    # a refraction spawn's draws, BSDF samples and trace stay innermost
    under = {rows[i][0] for i in range(len(rows))
             if rows[i][3] >= 0 and rows[rows[i][3]][0] == "refract"}
    assert {"rng", "bsdf", "query"} <= under
    # the march's nearest queries, one a step
    assert "query" in {rows[i][0] for i in range(len(rows))
                       if rows[i][3] >= 0 and rows[rows[i][3]][0] == "march"}
    assert glass["on"]["__stats__"]["march_segments"] > 0


def test_glass_refraction_counters(glass):
    c, no_rr = glass["counters"], glass["no_rr"]
    spawned = glass["spawned"]
    # 256 camera lanes spawn nb_r = 4 rays each; at the chain's next depth
    # each of those 1,024 lanes spawns one
    assert spawned == [256 * 4, 1024 * 1]
    assert c["refr_lanes"] == sum(spawned) == no_rr["refr_lanes"]
    assert 0 < c["refr_live_lanes"] <= c["refr_lanes"]
    assert c["refr_live_lanes"] < no_rr["refr_live_lanes"] <= c["refr_lanes"]


def test_glass_frame_equal_with_the_tracer_on_and_off(glass):
    off, on = glass["off"], glass["on"]
    assert set(off) == set(on)
    for k in off:
        if k == "__stats__":
            assert off[k] == on[k]
        else:
            assert torch.equal(off[k], on[k]), k
    assert float(off["refraction"].abs().sum()) > 0.0


def test_grid_has_no_refraction_rows_or_counters():
    scene = tbuild.build(str(ROOT / "portbench" / "configs" /
                             "disney_grid.ass"), device="cpu")
    accel = ttrace.build(scene.geometry)
    with tracer.enabled(spans=True, counters=True):
        stats = twave.render(scene, accel, aa_samples=1, xres=4, yres=4,
                             tile_pixels=16)["__stats__"]
    rows, counters = tracer.take()
    names = {r[0] for r in rows}
    assert {"tile", "generation", "query"} <= names
    assert not {"refract", "march"} & names
    assert not {"refr_lanes", "refr_live_lanes"} & set(counters)
    assert counters["lanes"] > 0 and stats["march_segments"] == 0


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.ones(4096), torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.enabled(spans=True):
            with tracer.span("light"):
                a + b
    (row,), _ = tracer.take()
    adds = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add"]
    assert len(adds) == 1
    assert row[1] <= adds[0].start_ns() <= adds[0].end_ns() <= row[2]


def test_tracer_api():
    with tracer.span("rng"):
        pass
    tracer.count("lanes", 3)
    assert tracer.take() == ([], {})

    @tracer.traced("bsdf")
    def f(x):
        """doc"""
        with tracer.span("bsdf"):      # the same name: no second row
            tracer.count("lanes", x)
            tracer.count("live_lanes", torch.tensor([True, False, True]))
        return x

    assert f.__name__ == "f" and f.__doc__ == "doc"
    with tracer.enabled(counters=True):
        assert not tracer.TRACER.spans_on
        with tracer.enabled(spans=True):
            f(2)
            f(3)
            with tracer.span("light"):
                with pytest.raises(RuntimeError, match="light"):
                    tracer.take()
        assert not tracer.TRACER.spans_on and tracer.TRACER.counters_on
    rows, counters = tracer.take()
    assert [(r[0], r[3]) for r in rows] == [("bsdf", -1), ("bsdf", -1),
                                             ("light", -1)]
    assert counters == {"lanes": 5, "live_lanes": 4}
    assert not tracer.TRACER.counters_on


# ---------------------------------------------------------------------------
# Attribution on synthetic rows (host ns) and kernels (device ns, one clock)
# ---------------------------------------------------------------------------

ROWS = [("render", 0, 100, -1),      # 0
        ("tile", 10, 60, 0),         # 1
        ("rng", 20, 30, 1),          # 2
        ("bsdf", 30, 40, 1),         # 3
        ("splat", 70, 80, 0),        # 4
        ("camera", 5, 5, 0)]         # 5, empty: holds no time
# (start, end, correlation id) and {id: launch}
KERNELS = [(22, 24, 1), (36, 38, 2), (38, 45, 3), (55, 58, 4), (73, 74, 5),
           (90, 95, 6), (101, 103, 7), (103, 104, 8), (110, 112, 9)]
LAUNCHES = {1: 21, 2: 35, 3: 36, 4: 50, 5: 72, 6: 90, 7: 101, 9: 96}


@pytest.mark.parametrize("order", ["sorted", "reversed", "shuffled"])
@pytest.mark.parametrize("skew", [0, -10, 7])
def test_attribution_is_a_partition_by_launch(order, skew):
    """The same charges in any order of the events, and wherever the
    card's clock stands against the host's."""
    ks = [(s + skew, e + skew, c) for s, e, c in KERNELS]
    if order == "reversed":
        ks.reverse()
    elif order == "shuffled":
        random.Random(7).shuffle(ks)
    att = tracer.attribute(ROWS, ks, LAUNCHES, [25, 50, 95, 120])
    assert att.device_ns == {"rng": 2, "bsdf": 2 + 7, "tile": 3, "splat": 1,
                             "render": 5 + 2, tracer.OUTSIDE: 2,
                             tracer.UNMATCHED: 1}
    assert att.launches == {"rng": 1, "bsdf": 2, "tile": 1, "splat": 1,
                            "render": 2, tracer.OUTSIDE: 1,
                            tracer.UNMATCHED: 1}
    assert sum(att.device_ns.values()) == att.kernel_ns == sum(
        e - s for s, e, _ in KERNELS)
    assert (att.kernels, att.unmatched) == (9, 1)
    # gaps: 24-36 by bsdf's launch at 35; 45-55 by tile's own at 50;
    # 58-73 by splat's at 72; 74-90 by render's at 90; 95-101 outside
    # every span; 104-110 by a launch at 96, before the gap: queued
    assert att.idle_ns == {"bsdf": 12, "tile": 10, "splat": 15,
                           "render": 16, tracer.OUTSIDE: 6,
                           tracer.QUEUED: 6}
    assert att.gaps == dict.fromkeys(att.idle_ns, 1)
    assert att.syncs == {"rng": 1, "tile": 1, "render": 1,
                         tracer.OUTSIDE: 1}
    assert att.skew_ns == skew
    assert att.driver_idle_ns == 15 + 16
    assert att.window_ns == 112 - 22
    assert att.busy_ns + sum(att.idle_ns.values()) == att.window_ns


def test_attribution_window_opens_after_the_lead_in():
    """Kernels launched before `since_ns` are left out; the gap from the
    last of them to the next kernel counts, charged to its launch."""
    lead = [(0, 8, 11), (9, 12, 12), (2, 3, 13)]
    launches = {**LAUNCHES, 11: 1, 12: 2, 13: 2}
    att = tracer.attribute(ROWS, lead + KERNELS, launches, [5, 25],
                           since_ns=20)
    assert att.syncs == {"rng": 1}
    assert att.kernels == 9
    assert att.idle_ns["rng"] == 22 - 12
    assert att.window_ns == 112 - 12
    assert sum(att.device_ns.values()) == att.kernel_ns


def test_attribution_follows_a_drifting_card_clock():
    """The card's clock 3 ms behind the host's a second later: the host
    waited for the card at 1.010-1.025 ms all the same (a global offset
    would call that gap queued), and the kernel launched at 1 s + 1 us
    waited behind the one before it."""
    ms = 1_000_000
    rows = [("render", 0, 2000 * ms, -1)]
    kernels = [(1005000, 1010000, 1), (1025000, 1030000, 2),
               (1032000, 1033000, 3), (997005000, 997010000, 4),
               (997012000, 997013000, 5)]
    launches = {1: 1000000, 2: 1020000, 3: 1021000, 4: 1000 * ms,
                5: 1000 * ms + 1000}
    att = tracer.attribute(rows, kernels, launches)
    assert att.idle_ns == {"render": 15000 + (997005000 - 1033000),
                           tracer.QUEUED: 2000 + 2000}
    assert att.skew_ns == -2995000


def test_innermost_sweep():
    rows = [("render", 0, 10, -1), ("tile", 2, 10, 0), ("rng", 2, 4, 1),
            ("bsdf", 4, 10, 1), ("splat", 10, 12, -1)]
    times = [0, 1, 2, 3, 4, 9, 10, 11, 12, -1]
    assert tracer.innermost(rows, times) == [0, 0, 2, 2, 3, 3, 4, 4, -1, -1]


def test_host_table_is_self_time():
    rows = [("render", 0, 100, -1), ("tile", 10, 60, 0), ("rng", 20, 30, 1),
            ("rng", 70, 75, 0)]
    assert tracer.host_table(rows) == {"render": [100 - 50 - 5, 1],
                                       "tile": [40, 1], "rng": [15, 2]}


def test_cli_profile_prints_a_line_per_span(tmp_path, capsys):
    src = tmp_path / "demo.ass"
    src.write_text(tdemo.DEMO_SCENE_ASS.replace('shader "mat_skin"',
                                                'shader "mat_floor"'))
    out = tmp_path / "p.exr"
    assert tcli.main(["render", str(src), "-o", str(out), "--res", "4",
                      "--aa", "1", "--profile", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    spans = dict(re.findall(r"^\[rls\]   span (\w+) +\d+\.\d{4}s  x(\d+)$",
                            text, re.M))
    assert {"render", "camera", "tile", "generation", "bsdf", "light",
            "rng", "query", "splat"} <= set(spans) <= SPANS
    assert spans["render"] == "1" and spans["tile"] == "1"
    assert re.search(r"^\[rls\]   stage tile +\d+\.\d\ds  x1$", text, re.M)
    assert tracer.take() == ([], {})
