"""The port's command line against the JAX package's, on the CPU.

`render`: both packages' `cli.main(["render", <the reduced copy of
scenes/disney_spheres.ass of tests/test_torch_disney_render.py>, "--res",
"16", "--aa", "1", "--passes", "2", "--aovs"])`, the port's with
`--device cpu`. Every EXR (half floats) agrees within half-float rounding
of the render slice's tolerance: |port - jax| <= one half-float spacing
at the value + 2.1e-7 (the Disney frame's largest difference,
tests/test_torch_disney_render.py). `render_progressive` agrees with the
JAX function plane by plane within tests/test_torch_refract.py's
`frames_agree` and within 1e-6 everywhere (measured at seeds 3 and 7922:
7.2e-7 at most, on RGBA and indirect_diffuse).

`test`, `list`, `mkdir` and `display` run against a suite built in
tmp_path, and their reports, listings, skeletons and PNG sheets are held
to the JAX package's on the same suite; `dcc`'s files are byte-equal to
the JAX package's.
"""
import os
import re

import numpy as np
import pytest
from PIL import Image

from rlshaders_tpu import cli as jcli
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.accel import trace as jtrace
from test_torch_disney_render import REDUCED, disney_copy
from test_torch_refract import PLANES, frames_agree
from rlshaders_tpu_torch import cli as tcli
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.io import exr
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene import demo as tdemo
from rlshaders_tpu_torch.scene import texture

cpu_math.settle()

RES = 16
RENDER_TOL = 2.1e-7
PROGRESSIVE_TOL = 1e-6
RENDER = ["--res", str(RES), "--aa", "1", "--passes", "2", "--aovs"]
AOV_FILES = ["out.exr"] + [f"out.{p}.exr" for p in PLANES if p != "RGBA"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' render of the reduced Disney copy, and both packages'
    render_progressive of it (the JAX tile program compiles once)."""
    root = tmp_path_factory.mktemp("cli")
    scene = disney_copy(root / "d.ass", **REDUCED)
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        os.makedirs(root / pkg)
        assert main(["render", scene, "-o", str(root / pkg / "out.exr")]
                    + RENDER + extra) == 0
    kw = dict(seed=3, aa_samples=1, xres=RES, yres=RES, verbose=False)
    js = jbuild.build(scene)
    jprog = jwave.render_progressive(js, jtrace.build(js.geometry), 2, **kw)
    ts = tbuild.build(scene, device="cpu")
    tprog = twave.render_progressive(ts, ttrace.build(ts.geometry), 2, **kw)
    return root, jprog, tprog


@pytest.mark.parametrize("name", AOV_FILES)
def test_render_exrs_match_jax_cli(runs, name):
    root = runs[0]
    jc, jh = exr.read(str(root / "jax" / name))
    tc, th = exr.read(str(root / "port" / name))
    assert jh == th and th["dataWindow"] == (0, 0, RES - 1, RES - 1)
    assert sorted(jc) == sorted(tc) == ["B", "G", "R"]
    for ch in "RGB":
        a, b = tc[ch].astype(np.float64), jc[ch].astype(np.float64)
        assert (a == a.astype(np.float16)).all()      # half floats
        assert np.isfinite(a).all()
        spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(
            np.float16)).astype(np.float64)
        assert (np.abs(a - b) <= spacing + RENDER_TOL).all(), (name, ch)
    if name == "out.exr":
        assert float(tc["G"].mean()) > 0.0


@pytest.mark.parametrize("name", PLANES)
def test_render_progressive_matches_jax(runs, name):
    _, jprog, tprog = runs
    assert isinstance(tprog[name], np.ndarray)
    assert tprog[name].dtype == np.float32
    frames_agree({name: _Np(tprog[name])}, jprog, name, RES)
    err = float(np.abs(tprog[name] - np.asarray(jprog[name])).max())
    assert err <= PROGRESSIVE_TOL, (name, err)


class _Np:
    """frames_agree reads `.numpy()` of the port's planes."""

    def __init__(self, a):
        self.a = a

    def numpy(self):
        return self.a


def test_render_progressive_is_the_mean_of_its_passes(runs):
    """Pass p is `render` at seed + 7919 p; the flush file holds the
    running mean of the beauty in half floats."""
    root = runs[0]
    scene = tbuild.build(str(root / "d.ass"), device="cpu")
    accel = ttrace.build(scene.geometry)
    kw = dict(aa_samples=1, xres=8, yres=8)
    flush = str(root / "flush.exr")
    prog = twave.render_progressive(scene, accel, 2, seed=5,
                                    flush_path=flush, verbose=False, **kw)
    a = twave.render(scene, accel, seed=5, **kw)
    b = twave.render(scene, accel, seed=5 + 7919, **kw)
    for k in PLANES:
        mean = ((a[k].double() + b[k].double()) / 2).float().numpy()
        np.testing.assert_array_equal(prog[k], mean, err_msg=k)
    np.testing.assert_array_equal(
        exr.read_rgb(flush), prog["RGBA"].astype(np.float16).astype(
            np.float32))
    assert prog["__stats__"] == b["__stats__"]


def test_render_prints_the_jax_lines(runs, capsys, tmp_path):
    """The build line and the stats line keep the JAX format; rays are
    the port's real counts over both passes."""
    root = runs[0]
    assert tcli.main(["render", str(root / "d.ass"), "-o",
                      str(tmp_path / "o.exr"), "--device", "cpu"]
                     + RENDER) == 0
    out = capsys.readouterr().out
    assert re.search(r"^\[rls\] scene: 2402 tris \(tables 2402\), 7 "
                     r"materials, build \d+\.\d\ds$", out, re.M), out
    assert len(re.findall(r"^\[rls\] pass [12]/2 done in \d+\.\d+s$", out,
                          re.M)) == 2
    m = re.search(r"^\[rls\] render 16x16 aa=1 in (\S+)s \| 0\.00 "
                  r"Mcam-samples \| (\S+) Mrays \((\S+) shadow\) \| (\S+) "
                  r"Mrays/s$", out, re.M)
    assert m, out
    scene = tbuild.build(str(root / "d.ass"), device="cpu")
    stats = twave.render(scene, ttrace.build(scene.geometry), aa_samples=1,
                         xres=RES, yres=RES)["__stats__"]
    rays = 2 * (stats["nearest_rays"] + stats["shadow_rays"])
    assert m.group(2) == f"{rays / 1e6:.1f}"
    assert m.group(3) == f"{2 * stats['shadow_rays'] / 1e6:.1f}"


def test_profile_writes_a_trace_and_stage_lines(tmp_path, capsys):
    """--profile on the CPU: the skin demo at 4x4, one pass; a Chrome
    trace of the CPU's activity and one line per stage."""
    src = tmp_path / "demo.ass"
    src.write_text(tdemo.DEMO_SCENE_ASS)
    out = tmp_path / "p.exr"
    assert tcli.main(["render", str(src), "-o", str(out), "--res", "4",
                      "--aa", "1", "--profile", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    trace = tmp_path / "p_trace" / "trace.json"
    assert trace.stat().st_size > 0
    with open(trace) as f:
        assert f.read(64).lstrip().startswith("{")
    assert re.search(r"^\[rls\]   stage tile +\d+\.\d\ds  x1$", text, re.M)
    assert re.search(r"^\[rls\]   stage sss +\d+\.\d\ds  x1$", text, re.M)
    assert out.exists()


@pytest.fixture(scope="module")
def suite(runs, tmp_path_factory):
    """A three-case suite made by both packages' `mkdir`: 0001 the reduced
    Disney copy at 16x16 with the JAX CLI's frame as its golden, 0002 the
    same with the golden upscaled to 32x32 by PIL (the harness resizes the
    render), 0003 with the JAX direct_diffuse AOV as its golden (fails)."""
    root = runs[0]
    base = tmp_path_factory.mktemp("suites")
    suites = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        s = base / pkg
        for desc in ("disney reduced", "disney golden 32x32",
                     "disney wrong golden"):
            assert main(["mkdir", "--suite", str(s), "--desc", desc]) == 0
        suites[pkg] = s
    s = suites["jax"]
    jout = exr.read_rgb(str(root / "jax" / "out.exr"))
    big = np.asarray(Image.fromarray(
        (np.clip(jout, 0, 1) * 255).astype(np.uint8)).resize((32, 32)),
        np.float32) / 255
    goldens = {"0001": jout, "0002": big,
               "0003": exr.read_rgb(str(root / "jax" /
                                        "out.direct_diffuse.exr"))}
    for case, ref in goldens.items():
        disney_copy(s / "mtoa" / case / "data" / "d.ass", **REDUCED,
                    xres=RES, yres=RES, AA_samples=1)
        exr.write_rgb(str(s / "mtoa" / case / "ref" / "ref.exr"), ref)
    for case in ("0001", "0003"):
        exr.write_rgb(str(s / "mtoa" / case / "ref" / "test_tpu.exr"),
                      exr.read_rgb(str(root / "port" / "out.exr")))
    return suites


def test_mkdir_makes_the_jax_skeleton(suite):
    def tree(root):
        return sorted((os.path.relpath(d, root), sorted(fs))
                      for d, _, fs in os.walk(root / "mtoa")
                      if "data" not in d and "ref" not in d)

    assert tree(suite["port"]) == tree(suite["jax"])
    for case in ("0001", "0002", "0003"):
        a = (suite["port"] / "mtoa" / case / "README").read_text()
        b = (suite["jax"] / "mtoa" / case / "README").read_text()
        assert a == b
    assert tcli.main(["mkdir", "--suite", str(suite["port"]), "--sn",
                      "2"]) == 1
    assert tcli.main(["mkdir", "--suite", str(suite["port"]), "--sn",
                      "7", "--desc", "x"]) == 0
    assert (suite["port"] / "mtoa" / "0007" / "README").read_text() == "x\n"


def test_list_prints_the_jax_listing(suite, capsys):
    s = str(suite["jax"])
    jcli.main(["list", "--suite", s])
    want = capsys.readouterr().out
    assert tcli.main(["list", "--suite", s]) == 0
    assert capsys.readouterr().out == want
    assert want.splitlines()[0] == "0001  disney reduced"


def test_test_reports_as_the_jax_harness(suite, tmp_path):
    """Both harnesses on the same suite at 2 passes: the same statuses,
    and RMSEs within 1e-4 (the renders agree within half-float rounding;
    the 32x32 case resizes through io/png.py against PIL)."""
    s = str(suite["jax"])
    rows = {}
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        report = tmp_path / f"{pkg}.csv"
        rc = main(["test", "--suite", s, "--aa", "1", "--passes", "2",
                   "--report", str(report)] + extra)
        assert rc == 1                      # 0003 fails
        rows[pkg] = [r.split(",") for r in
                     report.read_text().splitlines()[1:]]
    assert [r[:3] for r in rows["port"]] == [r[:3] for r in rows["jax"]]
    assert [r[2] for r in rows["port"]] == ["OK", "OK", "FAIL"]
    for a, b in zip(rows["port"], rows["jax"]):
        for i in (3, 4, 5):
            assert abs(float(a[i]) - float(b[i])) <= 1e-4, (a, b)
        assert a[6] == b[6]
    assert float(rows["port"][0][3]) < 1e-3


def test_display_writes_the_jax_sheets(suite, tmp_path, capsys):
    s = str(suite["jax"])
    jcli.main(["display", "--suite", s, "--outdir", str(tmp_path / "j")])
    want = capsys.readouterr().out
    assert tcli.main(["display", "--suite", s, "--outdir",
                      str(tmp_path / "t")]) == 0
    assert capsys.readouterr().out == want.replace(str(tmp_path / "j"),
                                                   str(tmp_path / "t"))
    assert "[0002] missing ref/test exr, skip" in want
    for case in ("0001", "0003"):
        p = tmp_path / "t" / f"{case}.png"
        mine = np.asarray(Image.open(p))
        assert mine.shape == (RES, 3 * RES, 3)
        np.testing.assert_array_equal(
            mine, np.asarray(Image.open(tmp_path / "j" / f"{case}.png")))
        with open(p, "rb") as f:
            np.testing.assert_array_equal(texture.decode_png(f.read()), mine)
    assert not (tmp_path / "t" / "0002.png").exists()


def test_dcc_files_equal_jax(tmp_path):
    from rlshaders_tpu.models import dcc as jdcc

    jpaths = jdcc.export(str(tmp_path / "j"))
    assert tcli.main(["dcc", "--outdir", str(tmp_path / "t")]) == 0
    assert len(jpaths) > 1
    for jp in jpaths:
        rel = os.path.relpath(jp, tmp_path / "j")
        with open(jp, "rb") as f, open(tmp_path / "t" / rel, "rb") as g:
            assert f.read() == g.read(), rel
