"""Tests of the port that need a CUDA card (marker `gpu`); they skip here.

This file imports neither jax nor the JAX package, so it runs on a machine
without them. Run it on the card without the repository's conftest.py
(which imports jax):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The kernels must equal their plain versions exactly (the .cu file builds
with -fmad=false and repeats the plain walk's order of operations), also
on the queries of the transparent-shadow march: per-ray finite t_max, dead
lanes and exclude = the previous hit; on both table paths (tables in
shared memory or in global memory); on soups too large for shared memory;
on launches whose lanes are all dead or all dead but the last; on sparse
live lanes, where the any-hit kernel splits a ray's walk over a warp's
idle lanes; and at ray counts that are no multiple of a warp or a block.
The CUDA renders (the demo, the glass sphere, the skin close-up with its
SSS probe stage, the Disney spheres and the textured scene with its disk
lights) are held to the CPU renders with chip_smoke.py's tolerance, and
material dispatch, its texture lookups and the bump map queue no
device-to-host copy. `cli render` writes the same EXRs on the card as on
the CPU within that tolerance, and the trace-set accels of
`build_trace_set` have the same tables on both and the kernels the same
hits as the CPU walk.
"""
import os
import types

import numpy as np
import pytest
import torch

from rlshaders_tpu_torch.accel import bvh
from rlshaders_tpu_torch.accel import trace
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _soup_accel(device, t=900, seed=3, size=0.3):
    rs = np.random.default_rng(seed)
    geom = types.SimpleNamespace(
        v0=torch.tensor(rs.uniform(-1, 1, (t, 3)), dtype=torch.float32),
        e1=torch.tensor(rs.uniform(-size, size, (t, 3)), dtype=torch.float32),
        e2=torch.tensor(rs.uniform(-size, size, (t, 3)), dtype=torch.float32),
        visibility=torch.tensor(np.where(rs.random(t) < 0.5, 2, 3),
                                dtype=torch.int32),
        opaque=torch.tensor(rs.random(t) < 0.7),
    )
    geom = types.SimpleNamespace(**{k: v.to(device)
                                    for k, v in vars(geom).items()})
    return trace.build(geom)


def _rays(device, n, seed=4, n_tris=900):
    """Random rays with axis-aligned ones, dead lanes (t_max <= 0),
    unbounded ones and excludes."""
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16] = [0.0, -1.0, 0.0]
    d[:8, 0] = -0.0
    t_max = rs.uniform(-0.5, 3.0, n)
    t_max[:100] = 1e30
    ex = np.where(rs.random(n) < 0.3, rs.integers(0, n_tris, n), -1)
    return [torch.tensor(a, dtype=dt, device=device) for a, dt in (
        (rs.uniform(-2, 2, (n, 3)), torch.float32), (d, torch.float32),
        (t_max, torch.float32), (ex, torch.int32))]


def _assert_kernels_equal_walk(acc, args, vis_mask, packed=None):
    from rlshaders_tpu_torch.ops import intersect as kernels

    packed = acc.packed if packed is None else packed
    hk = kernels.nearest(packed, *args, vis_mask)
    hp = bvh.intersect(acc.tree, acc.tris, *args, vis_mask)
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    bk = kernels.occluded(packed, *args, vis_mask)
    bp = bvh.occluded(acc.tree, acc.tris, *args, vis_mask)
    assert torch.equal(bk, bp)
    return hp, bp


@pytest.mark.gpu
def test_kernels_match_plain_walk(cuda_device):
    from rlshaders_tpu_torch.ops import intersect as kernels

    acc = _soup_accel(cuda_device)
    assert acc.packed.path == "shared"
    args = _rays(cuda_device, 20000)
    before = dict(kernels.LAUNCHES)
    for vis_mask in (1, 2, 3, 4):
        _assert_kernels_equal_walk(acc, args, vis_mask)
    assert kernels.LAUNCHES["rls_nearest"] == before["rls_nearest"] + 4
    assert kernels.LAUNCHES["rls_occluded"] == before["rls_occluded"] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["shared", "global"])
def test_every_table_path_matches_plain_walk(cuda_device, path):
    from rlshaders_tpu_torch.ops import intersect as kernels

    acc = _soup_accel(cuda_device)
    args = _rays(cuda_device, 20000, seed=6)
    before = kernels.PATH_LAUNCHES[path]
    for vis_mask in (1, 2):
        _assert_kernels_equal_walk(acc, args, vis_mask,
                                   acc.packed._replace(path=path))
    assert kernels.PATH_LAUNCHES[path] == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("t,path", [(12000, "global"), (4000, "global")])
def test_large_soups_take_their_path(cuda_device, t, path):
    """Neither soup's tables fit in shared memory (the 4,000-triangle
    soup's nodes alone would)."""
    acc = _soup_accel(cuda_device, t=t, seed=8, size=0.05)
    assert acc.packed.path == path
    args = _rays(cuda_device, 30000, seed=9, n_tris=t)
    for vis_mask in (1, 2):
        hp, bp = _assert_kernels_equal_walk(acc, args, vis_mask)
    assert bool((hp.tri >= 0).any()) and bool(bp.any())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_ragged_ray_counts(cuda_device, n):
    acc = _soup_accel(cuda_device)
    args = _rays(cuda_device, n, seed=n)
    args[2][:] = 5.0        # all lanes live, bounded
    _assert_kernels_equal_walk(acc, args, 3)
    args[2][n // 2:] = 0.0  # the second half dead
    _assert_kernels_equal_walk(acc, args, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("live", ["none", "last"])
def test_launches_of_dead_lanes(cuda_device, live):
    """All lanes dead (t_max 0 or below), or all but the last."""
    acc = _soup_accel(cuda_device)
    n = 70000
    args = _rays(cuda_device, n, seed=12)
    args[2][:] = torch.where(torch.arange(n, device=cuda_device) % 2 == 0,
                             0.0, -1.0)
    if live == "last":
        args[2][-1] = 1e30
    hp, bp = _assert_kernels_equal_walk(acc, args, 3)
    assert bool((hp.tri[:-1] == -1).all()) and not bool(bp[:-1].any())
    assert torch.equal(hp.t[:-1], args[2][:-1])


@pytest.mark.gpu
def test_wrapper_refuses_bad_inputs(cuda_device):
    from rlshaders_tpu_torch.ops import intersect as kernels

    acc = _soup_accel(cuda_device)
    o = torch.zeros((4, 3), device=cuda_device)
    d = torch.ones((4, 3), device=cuda_device)
    tm = torch.ones(4, device=cuda_device)
    ex = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.nearest(acc.packed, o, d, tm, ex.long(), 1)
    with pytest.raises(ValueError):
        kernels.nearest(acc.packed, o.cpu(), d, tm, ex, 1)
    with pytest.raises(ValueError):
        kernels.occluded(acc.packed, o, d.t().contiguous().t(), tm, ex, 1)


@pytest.mark.gpu
def test_cuda_render_matches_cpu_render(cuda_device):
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene.demo import demo_scene

    out = {}
    for dev in (cuda_device, "cpu"):
        scene, accel = demo_scene(skin=False, device=dev)
        out[str(dev)] = wavefront.render(scene, accel, seed=0, aa_samples=2,
                                         xres=32, yres=32)
    a, b = out["cuda"]["RGBA"].cpu().numpy(), out["cpu"]["RGBA"].numpy()
    assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


def _glass(device):
    from rlshaders_tpu_torch.scene.build import build

    scene = build("scenes/glass_sphere.ass", device=device)
    return scene, trace.build(scene.geometry)


@pytest.mark.gpu
def test_kernel_matches_plain_walk_on_march_queries(cuda_device):
    """A shadow march through the glass sphere, step by step: each step's
    rays carry the remaining segment as t_max (0 once used up) and exclude
    the triangle the previous step hit."""
    from rlshaders_tpu_torch.ops import intersect as kernels

    _, acc = _glass(cuda_device)
    rs = np.random.default_rng(5)
    n = 50000
    o = np.stack([rs.uniform(-1.5, 1.5, n), rs.uniform(2.5, 4.0, n),
                  rs.uniform(-1.5, 1.5, n)], 1)
    d = np.stack([rs.uniform(-1.5, 1.5, n), np.zeros(n),
                  rs.uniform(-1.5, 1.5, n)], 1) - o
    length = np.linalg.norm(d, axis=1)
    d /= length[:, None]
    t_max = np.where(rs.random(n) < 0.2, 0.0, length * rs.uniform(0.2, 1.2, n))
    o, d, remaining = (torch.tensor(a, dtype=torch.float32,
                                    device=cuda_device)
                       for a in (o, d, t_max))
    ex = torch.full((n,), -1, dtype=torch.int32, device=cuda_device)
    finite = dead = excluded = 0
    for _ in range(4):
        tm = torch.clamp_min(remaining, 0.0)
        hk = kernels.nearest(acc.packed, o, d, tm, ex, 2)
        hp = bvh.intersect(acc.tree, acc.tris, o, d, tm, ex, 2)
        for a, b in zip(hk, hp):
            assert torch.equal(a, b)
        finite += int(((tm > 0) & (tm < 1e29)).sum())
        dead += int((tm <= 0).sum())
        excluded += int((ex >= 0).sum())
        ok = (hk.tri >= 0) & (hk.t < remaining)
        step = torch.where(ok, hk.t + 2e-3, remaining)
        o = o + d * step[:, None]
        remaining = remaining - step
        ex = torch.where(ok, hk.tri, -1)
    assert finite > n // 2 and dead > n // 2 and excluded > n // 10


@pytest.mark.gpu
def test_cuda_glass_render_matches_cpu_render(cuda_device):
    from rlshaders_tpu_torch.integrator import wavefront

    out = {}
    for dev in (cuda_device, "cpu"):
        scene, accel = _glass(dev)
        out[str(dev)] = wavefront.render(scene, accel, seed=0, aa_samples=2,
                                         xres=32, yres=32)
    for name in ("RGBA", "refraction"):
        a, b = out["cuda"][name].cpu().numpy(), out["cpu"][name].numpy()
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


@pytest.mark.gpu
@pytest.mark.parametrize("share", [0.01, 0.05, 0.2])
def test_sparse_live_lanes(cuda_device, share):
    """A few live lanes a warp (the any-hit kernel splits their walks over
    the warp's idle lanes), on the soup and on the glass scene."""
    rs = np.random.default_rng(int(share * 100))
    for acc in (_soup_accel(cuda_device), _glass(cuda_device)[1]):
        args = _rays(cuda_device, 50000, seed=13)
        dead = torch.tensor(rs.random(50000) >= share, device=cuda_device)
        args[2] = torch.where(dead, 0.0, args[2].abs() + 0.1)
        for vis_mask in (1, 2):
            _assert_kernels_equal_walk(acc, args, vis_mask)


@pytest.mark.gpu
def test_cuda_sss_stage_matches_cpu(cuda_device):
    """scenes/skin_closeup.ass at 8x8, AA 1: the SSS probe stage's queries
    run through the kernels and its draws and shading on the card, held to
    the CPU render (the plain walk) with chip_smoke.py's tolerance."""
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene.build import build

    out = {}
    for dev in (cuda_device, "cpu"):
        scene = build("scenes/skin_closeup.ass", device=dev)
        out[str(dev)] = wavefront.render(scene, trace.build(scene.geometry),
                                         seed=0, aa_samples=1, xres=8,
                                         yres=8)
    for name in ("RGBA", "sss"):
        a, b = out["cuda"][name].cpu().numpy(), out["cpu"][name].numpy()
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert float(out["cuda"]["sss"].mean()) > 0.0
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


@pytest.mark.gpu
def test_cuda_disney_render_matches_cpu(cuda_device):
    """scenes/disney_spheres.ass at 8x8 at its own AA 3 and GI samples: the
    Disney lanes and the indirect multipliers on the card, held to the CPU
    render (the plain walk) with chip_smoke.py's tolerance."""
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene.build import build

    out = {}
    for dev in (cuda_device, "cpu"):
        scene = build("scenes/disney_spheres.ass", device=dev)
        out[str(dev)] = wavefront.render(scene, trace.build(scene.geometry),
                                         seed=0, xres=8, yres=8)
    for name in ("RGBA", "indirect_diffuse", "indirect_specular"):
        a, b = out["cuda"][name].cpu().numpy(), out["cpu"][name].numpy()
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert float(out["cuda"]["indirect_specular"].mean()) > 0.0
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


@pytest.mark.gpu
def test_cuda_textured_render_matches_cpu(cuda_device):
    """scenes/textured_disk.ass at 8x8 at its own AA 3 and GI samples: the
    texture lookups, the bump map and the disk lights on the card, held to
    the CPU render (the plain walk) with chip_smoke.py's tolerance."""
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene.build import build

    out = {}
    for dev in (cuda_device, "cpu"):
        scene = build("scenes/textured_disk.ass", device=dev)
        out[str(dev)] = wavefront.render(scene, trace.build(scene.geometry),
                                         seed=0, xres=8, yres=8)
    for name in ("RGBA", "direct_diffuse", "indirect_diffuse",
                 "indirect_specular"):
        a, b = out["cuda"][name].cpu().numpy(), out["cpu"][name].numpy()
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert float(out["cuda"]["direct_diffuse"].mean()) > 0.0
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


@pytest.mark.gpu
def test_dispatch_makes_no_host_copy(cuda_device):
    """dispatch.gather and the lobes on CUDA tables with every lane kind
    on (the per-table flags are decided once, on the host) queue no
    synchronizing operation."""
    from rlshaders_tpu_torch.core.vec3 import V3, normalize
    from rlshaders_tpu_torch.models import dispatch
    from rlshaders_tpu_torch.scene.build import build

    mats = build("scenes/disney_spheres.ass", device=cuda_device).materials
    tscene = build("scenes/textured_disk.ass", device=cuda_device)
    n = 4096
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    mat_id = torch.randint(0, mats.mtype.shape[0], (n,), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    entering = torch.rand(n, generator=gen, device=cuda_device) < 0.5
    wo, wi = (normalize(V3(*torch.rand(3, n, generator=gen,
                                       device=cuda_device) - 0.4))
              for _ in range(2))
    rx, ry = torch.rand(2, n, generator=gen, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = dispatch.gather(mats, mat_id, entering, has_skin=True,
                            has_disney=True)
        m = dispatch.skin_layer_fields(m, wo)
        outs = [*dispatch.eval_diffuse(m, wo, wi),
                *dispatch.eval_specular(m, wo, wi),
                dispatch.sample_specular(m, wo, rx, ry),
                dispatch.sample_diffuse(m, wo, rx, ry)]
        tmats = tscene.materials
        tid = mat_id % tmats.mtype.shape[0]
        p = V3(*(8.0 * torch.rand(3, n, generator=gen, device=cuda_device)
                 - 4.0))
        fp = torch.rand(n, generator=gen, device=cuda_device) * 1e-2
        uv = torch.rand(n, 2, generator=gen, device=cuda_device) * 3 - 1
        tm = dispatch.gather(tmats, tid, entering, has_skin=False,
                             has_disney=True, tex=dispatch.TexLookup(
                                 tscene.textures, uv, p, fp, fp * 2.0,
                                 -0.5, 2.2))
        outs += [tm.diffuse_color, tm.spec_weight,
                 dispatch.apply_bump(tmats, tscene.textures, tid, p, wo,
                                     fp=fp, tex_gamma=2.2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert m.dsy is not None and m.ggx2 is not None
    for o in outs:
        t = o.aos() if isinstance(o, V3) else o
        assert bool(torch.isfinite(t).all())


@pytest.mark.gpu
def test_cli_render_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """`cli render` of scenes/skin_closeup.ass at 8x8, AA 1 on the card and
    on the CPU: every EXR within chip_smoke.py's tolerance (half-float
    files)."""
    from rlshaders_tpu_torch import cli
    from rlshaders_tpu_torch.io import exr

    for dev in ("cuda", "cpu"):
        os.makedirs(tmp_path / dev)
        assert cli.main(["render", "scenes/skin_closeup.ass", "-o",
                         str(tmp_path / dev / "out.exr"), "--res", "8",
                         "--aa", "1", "--aovs", "--device", dev]) == 0
    names = sorted(os.listdir(tmp_path / "cpu"))
    assert names == sorted(os.listdir(tmp_path / "cuda"))
    assert "out.sss.exr" in names
    for name in names:
        a = exr.read_rgb(str(tmp_path / "cuda" / name))
        b = exr.read_rgb(str(tmp_path / "cpu" / name))
        assert a.shape == b.shape == (8, 8, 3)
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98, name
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean()) + 1e-6, name


@pytest.mark.gpu
def test_trace_set_accels_on_the_card_match_the_cpu(cuda_device):
    """build_trace_set over CUDA tensors: the same tables as over CPU
    tensors, and the kernels' hits equal the CPU walk's on random rays."""
    from rlshaders_tpu_torch.scene.build import build_text

    with open("scenes/textured_disk.ass") as f:
        src = f.read()
    for name in ("floor", "inv_panel", "bump_ball", "dsy_ball"):
        head = f"polymesh\n{{\n name {name}\n"
        assert head in src
        src = src.replace(head, head + ' trace_sets "setA"\n')
    scenes = {dev: build_text(src, device=dev, base_dir="scenes")
              for dev in ("cuda", "cpu")}
    assert scenes["cpu"].trace_set_names == ["setA"]
    for inclusive in (True, False):
        acc = {dev: trace.build_trace_set(s.geometry, 0, inclusive)
               for dev, s in scenes.items()}
        for a, b in zip(acc["cuda"].tree, acc["cpu"].tree):
            assert torch.equal(a.cpu(), b)
        args = _rays("cpu", 20_000, seed=5 + inclusive,
                     n_tris=scenes["cpu"].geometry.v0.shape[0])
        args[0] = args[0] * 4.0
        for vis_mask in (1, 2, 0xFF):
            hk = trace.nearest(acc["cuda"], *(a.to(cuda_device)
                                              for a in args[:2]), vis_mask,
                               args[3].to(cuda_device), t_max=args[2].to(
                                   cuda_device))
            hp = trace.nearest(acc["cpu"], args[0], args[1], vis_mask,
                               args[3], t_max=args[2])
            for x, y in zip(hk, hp):
                assert torch.equal(x.cpu(), y)
            ok = trace.occluded(acc["cuda"], *(a.to(cuda_device)
                                               for a in args[:3]), vis_mask,
                                args[3].to(cuda_device))
            op = trace.occluded(acc["cpu"], *args[:3], vis_mask, args[3])
            assert torch.equal(ok.cpu(), op)
