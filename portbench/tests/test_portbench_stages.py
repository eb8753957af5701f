"""The readers of the program's spans and counters (`portbench/stages.py`)
on the CPU: a traced run reports `live_lane_share` and no device reading;
a program without the tracer reads nothing and does not fail; and the
harness's own device readings are what they were on fixed events."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "portbench" / "reference")]

from portbench import harness, stages  # noqa: E402
from portbench.spans import Spans  # noqa: E402

SEED = 2 ** 31 + 4099
READERS = ("rng_device_ms", "bsdf_device_ms", "light_device_ms",
           "driver_idle_ms", "live_lane_share")


def tiny_traced_run():
    chk = dict(harness.cell_spec("disney.frame512")["check"], blocks=2,
               block=4)
    return harness.run("disney.frame512", SEED, 0.01, 1, device="cpu",
                       overrides={"xres": 12, "yres": 12,
                                  "tile_pixels": 144, "check": chk})


def test_traced_run_reports_the_live_lanes_and_no_device_reading():
    line = tiny_traced_run()
    assert line["correct"] is True
    m = line["metrics"]
    assert 0.0 < m["live_lane_share"]["value"] < 100.0
    assert m["live_lane_share"]["unit"] == "%"
    assert not {"rng_device_ms", "bsdf_device_ms", "light_device_ms",
                "driver_idle_ms"} & set(m)


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    monkeypatch.setattr(stages, "TRACER", "rlshaders_tpu_torch.core.nope")
    ctx = SimpleNamespace(spec={"chips": 1}, res={}, card=None)
    assert [harness.reader(n).read(ctx) for n in READERS] == [None] * 5
    assert ctx.stages is None


class Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)


def test_device_readings_on_fixed_events():
    """The harness's kernels, busy time and idle gaps from its marker and
    spans, with host runtime events beside the card's (which it skips)."""
    evs = [Event("fill", 1000, 10, True), Event("add_", 1010, 10, True),
           Event("cudaLaunchKernel", 995, 5, False),
           Event("k_a", 1100, 50, True), Event("k_b", 1140, 40, True),
           Event("Memcpy HtoD", 1300, 20, True),
           Event("cudaMemcpyAsync", 1290, 30, False),
           Event("k_a", 1500, 100, True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    spans = Spans()
    spans.rows = [("frame", 0, 1000, 1), ("tile", 50, 250, 2)]
    out = harness._device_readings(prof, spans, 0, 2.0)
    approx = pytest.approx
    assert out["kernels"] == {"k_a": approx([150e-6, 2]),
                              "k_b": approx([40e-6, 1]),
                              "Memcpy HtoD": approx([20e-6, 1])}
    assert out["busy_s"] == approx((80 + 20 + 100) / 1e9)
    assert out["trace_window_s"] == 2.0
    bd = out["breakdown"]
    assert [k for k, _ in bd["device_ops"]] == ["k_a", "k_b", "Memcpy HtoD"]
    assert [s for _, s in bd["device_ops"]] == approx([150e-9, 40e-9, 20e-9])
    # the device clock lies 1000 ns after the host's (the marker): the
    # gaps from device 1320 and 1180 open in "frame" and in "tile"
    assert [k for k, _ in bd["idle_gaps"]] == ["frame", "tile"]
    assert [s for _, s in bd["idle_gaps"]] == approx([180e-9, 120e-9])
