"""BENCHMARK.json against the benchmark's contract, and the harness's
look-up of cells, configurations and metric readers by file name."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# a width is never cut (hidden, latent, state, projection sizes, ..._dim)
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per)")


@pytest.fixture(scope="module")
def man():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def line_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes(man):
    assert set(man) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[kind]:
            assert set(e) - {"workloads"} == KEYS[kind], (kind, e["name"])
            if "workloads" in e:
                assert kind in ("end_to_end", "per_layer")
    assert 1 <= len(man["configs"]) <= 24
    assert 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51


def test_names_units_and_lines(man):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e and kind in ("configs", "workloads", "per_layer"):
                    if key == "source" and kind == "per_layer":
                        continue
                    assert line_ok(e[key]), (e["name"], key)
    for kind in ("configs", "workloads"):
        ns = [e["name"] for e in man[kind]]
        assert len(ns) == len(set(ns)), kind
    metrics = [n for is_m, n in names if is_m]
    assert len(metrics) == len(set(metrics))
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in man["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
    for word in man["command"]:
        assert line_ok(word)
    assert len(man["command"]) <= 32


def test_paths_and_command(man):
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in man["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in man["paths"])
    for c in man["configs"]:
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(BENCH).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_bounds(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in man["end_to_end"]]


def test_chip_budget(man):
    """A full check with 24 cells fits its 43,200 seconds."""
    rs = man["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    fours = sum(w["chips"] == 4 for w in man["workloads"])
    assert fours <= max(1, len(man["workloads"]) // 4)


def reported(man, cell: str, kind: str) -> list:
    return [m["name"] for m in man[kind]
            if "workloads" not in m or cell in m["workloads"]]


def test_every_cell_reports_enough(man):
    configs = {c["name"] for c in man["configs"]}
    used = {w["config"] for w in man["workloads"]}
    assert used == configs
    for w in man["workloads"]:
        e2e = reported(man, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reported(man, w["name"], "per_layer")


def test_moves_names_a_reported_metric(man):
    cells = [w["name"] for w in man["workloads"]]
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in reported(man, cell, "end_to_end"), \
                (m["name"], cell)


def test_layers_are_perf_mds(man):
    """Every metric's layer is a row of PERF.md's table of layers (§3),
    letter for letter."""
    text = (ROOT / "PERF.md").read_text()
    sec = text.split("## 3. Layers", 1)[1].split("\n## ", 1)[0]
    rows = {line.split("|")[1].strip() for line in sec.splitlines()
            if line.startswith("| ") and not line.startswith("| Layer")}
    for m in man["per_layer"]:
        assert m["layer"] in rows, m["name"]


def test_shares_are_rooflines_or_counts(man):
    for m in man["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


@pytest.fixture(scope="module")
def harness():
    sys.path[:0] = [str(ROOT), str(BENCH / "reference")]
    from portbench import harness
    return harness


def test_harness_finds_everything_by_name(man, harness):
    for c in man["configs"]:
        assert harness.load("configs", c["name"])["name"] == c["name"]
    for w in man["workloads"]:
        spec = harness.cell_spec(w["name"])
        assert spec["config"] == w["config"]
        assert spec["chips"] == w["chips"]
        assert Path(spec["scene"]).is_file()
        assert Path(spec["scene"]).resolve().is_relative_to(BENCH)
    for m in man["per_layer"]:
        mod = harness.reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"]), m["name"]
    for name in ("nope",):
        with pytest.raises(FileNotFoundError):
            harness.reader(name)
        with pytest.raises(FileNotFoundError):
            harness.cell_spec(name)


def test_config_files_state_the_scene_as_run(man):
    """Each configuration's options are its scene file's, but for those
    that `reduced` lists."""
    sys.path[:0] = [str(BENCH / "reference")]
    from rlsref.scene.ass_parser import parse

    keys = ("AA_samples", "GI_diffuse_samples", "GI_glossy_samples",
            "GI_diffuse_depth", "GI_glossy_depth", "GI_total_depth",
            "GI_sss_samples", "xres", "yres")
    for c in man["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (BENCH / "reference" / cfg["reference"] / "__init__.py"
                ).is_file()
        opts = [n for n in parse(str(ROOT / cfg["scene"]))
                if n.type == "options"][0]
        for k in keys:
            if k in cfg and k not in cfg["reduced"]:
                assert int(opts.get(k)) == cfg[k], (c["name"], k)


def test_adding_by_new_files_only(tmp_path, man):
    """A new configuration, cell and metric are new files and new entries
    in BENCHMARK.json: the harness takes them with no file edited."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    new = dict(man)
    new["configs"] = man["configs"] + [dict(
        man["configs"][0], name="disney_copy",
        file="portbench/configs/disney_copy.json")]
    new["workloads"] = man["workloads"] + [dict(
        man["workloads"][0], name="disney_copy.tiny", config="disney_copy",
        traffic="tiny")]
    new["per_layer"] = man["per_layer"] + [dict(
        man["per_layer"][0], name="frames_seen", unit="frames",
        layer="frame driver", moves="frame_s",
        workloads=["disney_copy.tiny"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cfg = json.loads((BENCH / "configs" / "disney_grid.json").read_text())
    cfg["name"] = "disney_copy"
    (tmp_path / "portbench/configs/disney_copy.json").write_text(
        json.dumps(cfg))
    cell = json.loads(
        (BENCH / "workloads" / "disney.frame512.json").read_text())
    cell.update(config="disney_copy", xres=64, yres=32, tile_pixels=512,
                passes=3)
    (tmp_path / "portbench/workloads/disney_copy.tiny.json").write_text(
        json.dumps(cell))
    (tmp_path / "portbench/metrics/frames_seen.py").write_text(
        'LAYER = "frame driver"\nUNIT = "frames"\n'
        'SOURCE = "host_clock"\nMOVES = "frame_s"\n\n\n'
        'def read(ctx):\n    return float(ctx.res["frames"])\n')
    code = (
        "import json, types\n"
        "from portbench import harness\n"
        "man = harness.manifest()\n"
        "s = harness.cell_spec('disney_copy.tiny')\n"
        "names = [m['name'] for m in harness.cell_metrics("
        "man, 'disney_copy.tiny', 'per_layer')]\n"
        "ctx = types.SimpleNamespace(res={'frames': 7})\n"
        "print(json.dumps([s['xres'], s['passes'], s['scene'], names, "
        "harness.reader('frames_seen').read(ctx)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    xres, passes, scene, names, frames = json.loads(out.stdout)
    assert (xres, passes, frames) == (64, 3, 7.0)
    assert scene.startswith(str(tmp_path))
    assert "frames_seen" in names
    after = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and p in before}
    assert after == before
