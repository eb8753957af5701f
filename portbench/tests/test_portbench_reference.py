"""The frozen reference against the program's CPU render, at a tiny size.

On the CPU both take the plain walk; the reference builds its own tree
with the NumPy builder, whose leaves may hold their triangles in another
order than the program's native builder, so a tie between two hits could
go the other way: none does at these sizes, and the frames agree in every
value."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
sys.path[:0] = [str(ROOT), str(BENCH / "reference")]

from portbench import check  # noqa: E402

# scene file, xres, yres, AA. The reference keeps the SSS stage for a
# later configuration with rlSkin: the repository's skin scene holds it to
# the program meanwhile.
SCENES = {"disney_grid": (BENCH / "configs" / "disney_grid.ass", 16, 9, 2),
          "skin_closeup": (ROOT / "scenes" / "skin_closeup.ass", 10, 10, 2)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def frames(request):
    """(program planes, reference planes, reference objects, sizes) of one
    scene's whole frame."""
    from rlsref.accel import trace as rtrace
    from rlsref.integrator import wavefront as rwave
    from rlsref.scene import build as rbuild

    from rlshaders_tpu_torch.accel import trace
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene import build

    path, xres, yres, aa = SCENES[request.param]
    path = str(path)
    kw = dict(seed=2 ** 31 + 77, aa_samples=aa, xres=xres, yres=yres,
              tile_pixels=xres * yres)
    scene = build.build(path, device="cpu")
    prog = wavefront.render(scene, trace.build(scene.geometry), **kw)
    rscene = rbuild.build(path, device="cpu")
    raccel = rtrace.build(rscene.geometry)
    ref = rwave.render(rscene, raccel, **kw)
    return prog, ref, (rwave, rscene, raccel, kw)


def test_reference_equals_program(frames):
    prog, ref, _ = frames
    assert prog["__stats__"] == ref["__stats__"]
    for name in prog:
        if name != "__stats__":
            np.testing.assert_array_equal(prog[name].numpy(),
                                          ref[name].numpy(), err_msg=name)
    assert float(prog["RGBA"].mean()) > 0.01


def test_live_pixels_give_the_whole_frames_values(frames):
    """The reference's live-pixel render: every checked pixel as the whole
    frame gives it, with fewer rays walked."""
    _, ref, (rwave, rscene, raccel, kw) = frames
    xres, yres = kw["xres"], kw["yres"]
    live, checked = check.blocks(5, xres, yres, 2, 3)
    fb = rwave.render_tiles(rscene, raccel, live_pixels=live, **kw)
    idx = torch.nonzero(checked).reshape(-1)
    got = check.planes(check.gather(fb, idx).numpy(), fb.names)
    for name, v in got.items():
        want = ref[name].reshape(-1, 3)[idx].numpy()
        np.testing.assert_array_equal(v, want, err_msg=name)
    assert live.sum() < xres * yres


def test_live_pixels_over_several_tiles(frames):
    """Over a frame of four tiles, the last padded, the tiles without a
    live pixel are left out and the checked pixels keep their values."""
    _, _, (rwave, rscene, raccel, kw) = frames
    kw = dict(kw, tile_pixels=kw["xres"] * kw["yres"] // 4 + 1)
    whole = rwave.render_tiles(rscene, raccel, **kw)
    live, checked = check.blocks(3, kw["xres"], kw["yres"], 1, 2)
    fb = rwave.render_tiles(rscene, raccel, live_pixels=live, **kw)
    idx = torch.nonzero(checked).reshape(-1)
    np.testing.assert_array_equal(check.gather(fb, idx).numpy(),
                                  check.gather(whole, idx).numpy())
    assert whole.stats["tiles"] == 4
    assert 1 <= fb.stats["tiles"] < 4


def test_blocks_follow_the_seed():
    a = check.blocks(11, 64, 48, 3, 8)
    b = check.blocks(11, 64, 48, 3, 8)
    c = check.blocks(12, 64, 48, 3, 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    live, checked = a
    assert bool((live | ~checked).all())
    assert int(checked.sum()) <= 3 * 64


def test_numbers():
    want = {"RGBA": np.ones((4, 3)), "sss": np.zeros((4, 3))}
    got = {k: v.copy() for k, v in want.items()}
    assert check.numbers(got, want, 1e-3, 1e-2) == {
        "bad_share": 0.0, "mean_gap": 0.0, "nonfinite": 0.0}
    got["RGBA"][0, 0] = 1.5
    n = check.numbers(got, want, 1e-3, 1e-2)
    assert n["bad_share"] == 1 / 24
    assert n["mean_gap"] == pytest.approx(0.5 / 4)
    assert check.numbers({"RGBA": got["RGBA"]}, want, 1e-3, 1e-2)[
        "bad_share"] == 1.0
    got["sss"][1, 1] = np.nan
    n = check.numbers(got, want, 1e-3, 1e-2)
    assert n["nonfinite"] == 1.0 and n["bad_share"] == 2 / 24
    assert n["mean_gap"] == pytest.approx(0.5 / 4)


def test_control_leaves_the_reference_as_it_was():
    """The control's rounding reaches no table of another reference."""
    from portbench import harness
    from portbench.lowprec import Bfloat16Results

    spec = harness.cell_spec("disney.frame512",
                             {"xres": 12, "yres": 12, "tile_pixels": 144})
    ref = check.Reference(spec["scene"], "cpu", "rlsref")
    low = check.Reference(spec["scene"], "cpu", "rlsref")
    live, checked = check.blocks(1, 12, 12, 2, 4)
    idx = torch.nonzero(checked).reshape(-1)
    a, _ = ref.frame(7, spec, live, idx)
    with Bfloat16Results():
        c, _ = low.frame(7, spec, live, idx)
    b, _ = ref.frame(7, spec, live, idx)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
