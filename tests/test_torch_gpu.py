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
hits as the CPU walk. The committed image files (scenes/data/modes and
scenes/data/formats, formats_b, formats_c, formats_d and formats_e)
decode on the card's machine, which has no PIL, to the digests of PIL's
decode, and chip_smoke.py's frames of phases 32, 34, 36, 38 and 40 (a
DDS, a TGA and a
JPEG TIFF; a QOI, a PCX and a Group 4 TIFF; a BC7 and a BC6H DDS and a
BLP; an ICO, an ICNS and an IM; a 2048x2048 lossy WebP, a lossless WebP
and a WebP with alpha; a SPIDER, a palette WebP and a quality-5 WebP; a
2048x2048 JP2, a lossless RGBA JP2 and an animated lossy WebP; a palette
JP2, a tiled J2K and an animated lossless WebP; a 2048x2048 AVIF, an
RGBA AVIF and a premultiplied one; a lossless 4:4:4 AVIF, a 4:0:0 AVIF
with alpha and a limited-range 4:2:2 AVIF) render on the card as on the
CPU. The random draws' kernels (ops/rng.py) equal the CPU draws bit for
bit, and a tile of the benchmark's disney_grid frame drawn by them equals
the same tile with core/rng.py's plain draws forced in. The lobes' kernels
(ops/bsdf.py) are held lane by lane to models/dispatch.py's eager code on
the card in every lobe call of a disney_grid tile, a glass tile and a
skin close-up tile, one launch a call, and handle every lane of a CUDA
tile.
"""
import contextlib
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


# SHA-256 of PIL's RGB decode of the committed JPEG textures
# (tools/make_jpeg_textures.py; tests/test_torch_jpeg.py checks them
# against PIL)
JPEG_DIGESTS = {
    "scenes/data/grid.jpg":
        "95c6e193d2be4e9f04f28f29048cfc0acf2ac85fc03479fa7c978f919caa9603",
    "scenes/data/logo.jpg":
        "6ca72db18beca40ae8d32c3fe2421a339667c534ed778bf6106a07b9db5df803",
}


@pytest.mark.gpu
def test_render_sharded_over_nccl_matches_render(cuda_device, tmp_path):
    """render_sharded at world size 1 over NCCL in this process (one rank's
    all-reduce, the collective a multi-GPU run makes) against render on
    the card: the demo at 32x32, AA 2, four tiles. The splat's atomics
    move the last bits of both frames, so they are held to chip_smoke.py's
    tolerance; the ray counts are equal."""
    import torch.distributed as dist
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.parallel import mesh

    scene, accel = mesh.demo_scene(skin=False, device=cuda_device)
    kw = dict(tile_pixels=256, aa_samples=2, xres=32, yres=32)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        m = mesh.make_mesh()
        assert m.device_type == "cuda"
        out = mesh.render_sharded(scene, accel, m, **kw)
    finally:
        dist.destroy_process_group()
    ref = wavefront.render(scene, accel, **kw)
    assert out["__stats__"] == ref["__stats__"]
    assert out["__stats__"]["tiles"] == 4
    for name, b in ref.items():
        if name == "__stats__":
            continue
        a, b = out[name].cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all(), name
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98, name
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean()) + 1e-6, name


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(JPEG_DIGESTS))
def test_committed_jpegs_decode_to_their_digests(cuda_device, path):
    """The decoder on the card's machine, which has no PIL: the committed
    JPEGs decode to the digests of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.jpeg import decode_jpeg

    with open(path, "rb") as f:
        px = decode_jpeg(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == JPEG_DIGESTS[path]


# SHA-256 of PIL's RGB decode of every file of scenes/data/modes
# (tools/make_image_modes.py prints them; tests/test_torch_image_modes.py
# checks them against PIL and chip_smoke.py's copy)
MODE_DIGESTS = {
    "scenes/data/modes/grid.gif":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_8bit_topdown_v5.bmp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_grey16.png":
        "c1f7d702a80ae5e7dc52d62ef2577cbbb25c045d6dda3a49a872130518f48cc0",
    "scenes/data/modes/grid_grey1_adam7.png":
        "363cb8b7a0c1362aad878f833388374ba3cda6a58460528ef537cfcf74ecbe8b",
    "scenes/data/modes/grid_grey4.png":
        "240bf383fa47ede915297c2869089a394e4105c00ed50916a793c4a13608361f",
    "scenes/data/modes/grid_minwhite1.tif":
        "363cb8b7a0c1362aad878f833388374ba3cda6a58460528ef537cfcf74ecbe8b",
    "scenes/data/modes/grid_os2_1bit.bmp":
        "65bd463b46b3fa067437a411131c777912210f14c48fa231d4cb863dc1650a5a",
    "scenes/data/modes/grid_palette_packbits.tif":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_progressive.jpg":
        "95c6e193d2be4e9f04f28f29048cfc0acf2ac85fc03479fa7c978f919caa9603",
    "scenes/data/modes/grid_rgb.jpg":
        "e16ee891b5d66530e8d707cb424ae0a13ba198a67660c2bfc84eb3014c2e912d",
    "scenes/data/modes/grid_rgb16.png":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_rgb16_lzw_pred2_mm.tif":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_rle8.bmp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_tiles_deflate_planar2_mm.tif":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/logo_4bit.bmp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_565_bitfields.bmp":
        "4b38b26737b78000b0c0b48a24e452e82394331479f703e4709c00030f6a9aaa",
    "scenes/data/modes/logo_cmyk.jpg":
        "9c0106c01f67da1ffe90ee2e00ed6d2eee3ac2a30a694e1fe4484dcb80d63db1",
    "scenes/data/modes/logo_cmyk_deflate.tif":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_greyalpha8.png":
        "ab4446635cd496cfa7a2c79898d822b09c77ef0c63426e1f36201878179ff0bc",
    "scenes/data/modes/logo_interlaced_local.gif":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_lzw_pred2.tif":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_offset87a.gif":
        "4e925c96023fa6014bc64dccff150cb5dcf5eefcc56043fb9741c3edeb3879e6",
    "scenes/data/modes/logo_palette_adam7.png":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_progressive.jpg":
        "6ca72db18beca40ae8d32c3fe2421a339667c534ed778bf6106a07b9db5df803",
    "scenes/data/modes/logo_rgba16_adam7.png":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_rle4.bmp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/texture_2048.jpg":
        "8fe53ffcd38d108910a6da2c19e7b8e85defd7a95fcb9711d8e961c91d2c8024",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(MODE_DIGESTS))
def test_committed_image_modes_decode_to_their_digests(cuda_device, path):
    """The decoders on the card's machine, which has no PIL: every
    committed image mode decodes to the digest of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == MODE_DIGESTS[path]


# SHA-256 of PIL's RGB decode of every file of scenes/data/formats (printed
# by tools/make_image_formats.py; pinned by chip_smoke.py too)
FORMAT_DIGESTS = {
    "scenes/data/formats/grid.qoi":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats/grid_ascii.ppm":
        "cee47d398d8d24c381acdefa62aff5d47e010e4a55a253500f2c9ce6de337654",
    "scenes/data/formats/grid_bc5_half.dds":
        "e47b86a56cc1f89bc39bee7b6930e179e04774da9f954a078e8a5de5b77ee404",
    "scenes/data/formats/grid_bits.pbm":
        "42ca3c9a0b2a8ec3ed6115a060f696ee8be84efa7c3ecb4157e90c9cc060b5e6",
    "scenes/data/formats/grid_cmap16_mirrored_rle.tga":
        "798f61bc94ec20227730dac0f42b86a04f2353b70f545b0367dcf54c1b07e245",
    "scenes/data/formats/grid_grey_topdown.tga":
        "973b2927b32f358ee132eee66d6f2433bff570be78cbbaef95998d2ac2892080",
    "scenes/data/formats/grid_group3_2d_fill_lsb_minwhite.tif":
        "42ca3c9a0b2a8ec3ed6115a060f696ee8be84efa7c3ecb4157e90c9cc060b5e6",
    "scenes/data/formats/grid_planes4.pcx":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats/grid_rgb.pcx":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats/grid_rle.sgi":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats/grid_ycbcr420_tiles_jpeg.tif":
        "1dc73c34e3f3f96984b3ce545abc78efd68f83d972b671f230bafd49c9a558b7",
    "scenes/data/formats/logo.pfm":
        "8bdfe77adc3ef8b0636ef081b0627110319d08e628d3cb239fa3e8b9c951ef29",
    "scenes/data/formats/logo_bgr15_half.tga":
        "8d36750d3294b929296629048437c870098f8f2c9af5185b41ce876493ea03df",
    "scenes/data/formats/logo_dxt5.dds":
        "e6eb01bd1e8a05a45104aeffb554e32da4f6c1a35a33ed959c749730f8ace3e6",
    "scenes/data/formats/logo_group4.tif":
        "ec2d15d962e2cd0028f779f0fd7acbd77742ad4ee6196eef0f945da94574b402",
    "scenes/data/formats/logo_jpeg.tif":
        "9c0106c01f67da1ffe90ee2e00ed6d2eee3ac2a30a694e1fe4484dcb80d63db1",
    "scenes/data/formats/logo_mh_strips.tif":
        "ec2d15d962e2cd0028f779f0fd7acbd77742ad4ee6196eef0f945da94574b402",
    "scenes/data/formats/logo_palette.dib":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats/logo_palette.pcx":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats/logo_rgb12.ppm":
        "62c78e652dc843de1ee8a10bffc27ed34425f7febdc7246d1f2ce2942ce2e6b0",
    "scenes/data/formats/logo_rgb_half.dds":
        "9fc2c55bb8bb6e1a2acbb39e637d6c878d1e0517cfdc0d2a7da288aca51095f9",
    "scenes/data/formats/logo_rgba.qoi":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats/logo_rgba_half.sgi":
        "9fc2c55bb8bb6e1a2acbb39e637d6c878d1e0517cfdc0d2a7da288aca51095f9",
    "scenes/data/formats/logo_rle.tga":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats/texture_2048_dxt1.dds":
        "992f0a6d348f20ada83c65a356bdc76941940433c0e250fcc29937bb8d6db00e",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_DIGESTS))
def test_committed_image_formats_decode_to_their_digests(cuda_device, path):
    """The decoders of the formats on the card's machine, which has no PIL:
    every committed file decodes to the digest of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_DIGESTS[path]


# chip_smoke.py phase 32's frames: the images of the textured scene's three
# MayaFile slots (the grid, the logo, the inverted logo)
FORMAT_FRAMES = {
    "C": ("formats/texture_2048_dxt1.dds", "formats/logo_rle.tga",
          "formats/logo_jpeg.tif"),
    "D": ("formats/grid.qoi", "formats/logo_palette.pcx",
          "formats/logo_group4.tif"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_FRAMES))
def test_format_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """chip_smoke.py phase 32's frame (scenes/textured_disk.ass with a
    DDS, a TGA and a JPEG TIFF, or a QOI, a PCX and a Group 4 TIFF in its
    texture slots) at 8x8 and its own AA 3 and GI samples: through both
    kernels on the card, held to the CPU render with chip_smoke.py's
    tolerance."""
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build_text

    with open("scenes/textured_disk.ass") as f:
        src = f.read()
    for old, new in zip(('"data/grid.png"', '"data/logo.png"',
                         '"data/logo.png"'), FORMAT_FRAMES[tag]):
        src = src.replace(old, f'"data/{new}"', 1)
    out = {}
    for dev in (cuda_device, "cpu"):
        scene = build_text(src, device=dev, base_dir="scenes")
        assert scene.textures.n_levels.shape == (3,)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out[str(dev)] = wavefront.render(scene, trace.build(scene.geometry),
                                         seed=0, xres=8, yres=8)
        if dev != "cpu":
            assert all(n > 0 for n in kernels.LAUNCHES.values())
    for name in ("RGBA", "direct_diffuse", "indirect_diffuse",
                 "indirect_specular"):
        a, b = out["cuda"][name].cpu().numpy(), out["cpu"][name].numpy()
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert float(out["cuda"]["direct_diffuse"].mean()) > 0.0
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


FORMAT_B_DIGESTS = {
    "scenes/data/formats_b/grid.msp":
        "42ca3c9a0b2a8ec3ed6115a060f696ee8be84efa7c3ecb4157e90c9cc060b5e6",
    "scenes/data/formats_b/grid.xbm":
        "42ca3c9a0b2a8ec3ed6115a060f696ee8be84efa7c3ecb4157e90c9cc060b5e6",
    "scenes/data/formats_b/grid_bc4_ati1.dds":
        "e69093b2cc964a3a14d0533a22a1891b8426805c6fe817a802eebaa1445dc540",
    "scenes/data/formats_b/grid_bc6h_uf16.dds":
        "24816b19d2ec58fa1ec2b138cddd1d97b7149bcfb2c1277044d58c26e967e1d9",
    "scenes/data/formats_b/grid_bmp32.ico":
        "e482778d49d9cdf65d05c2114c91775e119b3216fc817dc14c690dc391e7c1eb",
    "scenes/data/formats_b/grid_dxt1.blp":
        "cc4f280c86efa2aeb94bbd57783c3c2078c19900975e8ebf0fcccf05975e46a3",
    "scenes/data/formats_b/grid_palette.blp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_b/grid_png.icns":
        "e482778d49d9cdf65d05c2114c91775e119b3216fc817dc14c690dc391e7c1eb",
    "scenes/data/formats_b/grid_rgb.im":
        "e482778d49d9cdf65d05c2114c91775e119b3216fc817dc14c690dc391e7c1eb",
    "scenes/data/formats_b/logo.cur":
        "9fc2c55bb8bb6e1a2acbb39e637d6c878d1e0517cfdc0d2a7da288aca51095f9",
    "scenes/data/formats_b/logo_bc4_odd.dds":
        "14a218dd10b398eebe1770b66d185afb0e7f94811b6714cf29f6d7abc12c0fcc",
    "scenes/data/formats_b/logo_bc6h_sf16.dds":
        "419b2b263acbbe191b196d681d57d0bf40fe4de2e048d154025407415f7a7ec4",
    "scenes/data/formats_b/logo_bc7_srgb.dds":
        "e31fa5d65f786ea8b846811fe3eb0242c6c059692b3454a3f6d642546be6e3e9",
    "scenes/data/formats_b/logo_dxt3.blp":
        "b1cf3cbff4b7ea8f4ef718f15c185a445f9039d2e0787eec4ae5e2b650698a47",
    "scenes/data/formats_b/logo_dxt5_odd.blp":
        "c2e61035b3cd6a203462a786889965b2a70a5beaed7340cafa6a8bcdaba335d6",
    "scenes/data/formats_b/logo_f32.im":
        "f61fef78ebe981ba385947fdc0ab941a05b3684e8b63dc3c782fb7dba7ead5b9",
    "scenes/data/formats_b/logo_it32.icns":
        "c25a95c9d9c5ff3c17407a81803655855065f51c2de740ee2887d3fa0a29a4bc",
    "scenes/data/formats_b/logo_jpeg.blp":
        "5a76a7d2fd3c89c1c35d296581cc81371e03b87ed399f2f3f16afca706e802e2",
    "scenes/data/formats_b/logo_palette.blp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_b/logo_palette.im":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_b/logo_png.ico":
        "e0413348d4143c8414c640bc2b475f10e1bf3bd261c5d20026e6d9e1b84b3ed6",
    "scenes/data/formats_b/logo_rle.msp":
        "9279e2093299d64288501876af0686003254afa383d805f7b3ab8f6bbf8bb6da",
    "scenes/data/formats_b/logo_ycc.im":
        "f3c0e0eceb403b11caeddb7aceb9ca7e1b4f752e58f014c1c68be276830e9f1a",
    "scenes/data/formats_b/texture_2048_bc7.dds":
        "4a463dc0bef814d02a20c3ae3f197c55c75cb5b5cd1b0c6ffb5935c12d42fd46",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_B_DIGESTS))
def test_committed_image_formats_b_decode_to_their_digests(cuda_device,
                                                           path):
    """The decoders of the game-texture and icon formats on the card's
    machine, which has no PIL: every committed file of
    scenes/data/formats_b decodes to the digest of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_B_DIGESTS[path]


# chip_smoke.py phase 34's frames, in the textured scene's three MayaFile
# slots (the grid, the logo, the inverted logo)
FORMAT_B_FRAMES = {
    "E": ("formats_b/texture_2048_bc7.dds", "formats_b/logo_bc6h_sf16.dds",
          "formats_b/logo_dxt3.blp"),
    "F": ("formats_b/grid_bmp32.ico", "formats_b/logo_it32.icns",
          "formats_b/logo_palette.im"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_B_FRAMES))
def test_format_b_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """chip_smoke.py phase 34's frame (scenes/textured_disk.ass with a BC7
    DDS, a BC6H DDS and a DXT3 BLP, or an ICO, an ICNS and an IM in its
    texture slots) at 8x8 and its own AA 3 and GI samples: through both
    kernels on the card, held to the CPU render with chip_smoke.py's
    tolerance."""
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build_text

    with open("scenes/textured_disk.ass") as f:
        src = f.read()
    for old, new in zip(('"data/grid.png"', '"data/logo.png"',
                         '"data/logo.png"'), FORMAT_B_FRAMES[tag]):
        src = src.replace(old, f'"data/{new}"', 1)
    out = {}
    for dev in (cuda_device, "cpu"):
        scene = build_text(src, device=dev, base_dir="scenes")
        assert scene.textures.n_levels.shape == (3,)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out[str(dev)] = wavefront.render(scene, trace.build(scene.geometry),
                                         seed=0, xres=8, yres=8)
        if dev != "cpu":
            assert all(n > 0 for n in kernels.LAUNCHES.values())
    for name in ("RGBA", "direct_diffuse", "indirect_diffuse",
                 "indirect_specular"):
        a, b = out["cuda"][name].cpu().numpy(), out["cpu"][name].numpy()
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert float(out["cuda"]["direct_diffuse"].mean()) > 0.0
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


FORMAT_C_DIGESTS = {
    "scenes/data/formats_c/crop_12colours_lossless.webp":
        "baf1c4f351aebc09af6065b70635f18f5e2bf5a271b953e1be73f01dba057141",
    "scenes/data/formats_c/crop_17x33.webp":
        "a35c28f0b9e23d207f1dd55356a05baa88dcf4bf8d1ebd8832dab799e670f55d",
    "scenes/data/formats_c/crop_200colours_lossless.webp":
        "a551c82465d61e288863fa7055092bd79e32ac2d705fbbf68874994385199078",
    "scenes/data/formats_c/crop_lossless_m0.webp":
        "d08ee73a38b5a124fc26f93e0557a0491e1bdb3da6f973e10e5b7f88d3be6146",
    "scenes/data/formats_c/crop_lossless_m6.webp":
        "d08ee73a38b5a124fc26f93e0557a0491e1bdb3da6f973e10e5b7f88d3be6146",
    "scenes/data/formats_c/crop_q100.webp":
        "d866221320c4e1069271eb4919696bf88c98d136d39e89071af3a229d517863f",
    "scenes/data/formats_c/grid_big_endian.spider":
        "ef8c72bb8c402cfad35ac5ca20cb502a6073cbcb19d254ba851cf9dff90d382a",
    "scenes/data/formats_c/grid_half.spider":
        "973b2927b32f358ee132eee66d6f2433bff570be78cbbaef95998d2ac2892080",
    "scenes/data/formats_c/grid_icc.webp":
        "3a122d0c539f20895c079307b011c776f74441c40869be273e134d5b450c62fe",
    "scenes/data/formats_c/grid_lossless_m0.webp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_c/grid_lossless_m6.webp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_c/grid_q50.webp":
        "f21d36aa0f12ca7b5229876e661c156077503ce5cf6746a18dbecced4931d297",
    "scenes/data/formats_c/logo_alpha_exif.webp":
        "df219bf266aad832943e276f53c887286e39442b55de9d2e7fff196f7eb60c6d",
    "scenes/data/formats_c/logo_alpha_lossy.webp":
        "59f14f0c0b152c96025fe9d8056221bbc62ec219ba772cfd37a725b4e0eeeec7",
    "scenes/data/formats_c/logo_f32.spider":
        "a1cfff658fb32ef964d5f1851ece5abd0be46a55c7a468446a7f1b76d713adf3",
    "scenes/data/formats_c/logo_odd_q75.webp":
        "0378e1f632c5e63c5c657019bd4606ce03f2af16e83dcc26ace981c8dbc6acd6",
    "scenes/data/formats_c/logo_palette_lossless.webp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_c/logo_q5.webp":
        "25d93a757d6756fd282063337e1aeab445a664f0fd95f754b7a5749bfdd8042e",
    "scenes/data/formats_c/logo_rgba_lossless.webp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_c/logo_rgba_lossless_m0.webp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_c/logo_stack.spider":
        "4ac3678960dee078bfb14cf91496e955161b4eaf5baa28150975dfb9317b3b44",
    "scenes/data/formats_c/pixel_1x1.webp":
        "723c5189b7cd4addbb16b3ccb29c50596084185751e9a866e00aac09afb463a2",
    "scenes/data/formats_c/texture_2048.webp":
        "84ebb4efeb0844264cb81c14df8982c28b71e24bb5a9786568921221ce0c33c6",
    "scenes/data/formats_c/vp8_partitions8_sharp.webp":
        "2868c421799e583721701a61daed1e4f3527e90f24b36179677d4e507ae5f759",
    "scenes/data/formats_c/vp8_segments_deltas.webp":
        "8cb1c1a071306fb18df04fc06570812a9c18670154af901a829c49cd3b98b256",
    "scenes/data/formats_c/vp8_simple_filter.webp":
        "3fa908da2f001f72d7b2dd1d0ce9e7c078509cc073bf9a71bd1fd8ae26784e74",
    "scenes/data/formats_c/vp8l_all_predictors.webp":
        "ec625d18ddabddeed03b2a415164eb9857b1a43eaf5d9d9e9130c5effe4d65a2",
    "scenes/data/formats_c/vp8l_palette5_past.webp":
        "59122175770d03434c67debbcf7123f957da58924aaa0cd185767da472404a17",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_C_DIGESTS))
def test_committed_image_formats_c_decode_to_their_digests(cuda_device,
                                                           path):
    """The SPIDER and WebP decoders on the card's machine, which has no
    PIL: every committed file of scenes/data/formats_c decodes to the
    digest of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_C_DIGESTS[path]


# chip_smoke.py phase 36's frames, in the textured scene's three MayaFile
# slots (the grid, the logo, the inverted logo)
FORMAT_C_FRAMES = {
    "G": ("formats_c/texture_2048.webp", "formats_c/logo_rgba_lossless.webp",
          "formats_c/logo_alpha_lossy.webp"),
    "H": ("formats_c/grid_half.spider",
          "formats_c/logo_palette_lossless.webp", "formats_c/logo_q5.webp"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_C_FRAMES))
def test_format_c_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """chip_smoke.py phase 36's frame (scenes/textured_disk.ass with a
    2048x2048 lossy WebP, a lossless RGBA WebP and a lossy WebP with
    alpha, or a SPIDER, a palette lossless WebP and a quality-5 WebP in
    its texture slots) at 8x8 and its own AA 3 and GI samples: through
    both kernels on the card, held to the CPU render with chip_smoke.py's
    tolerance."""
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build_text

    with open("scenes/textured_disk.ass") as f:
        src = f.read()
    for old, new in zip(('"data/grid.png"', '"data/logo.png"',
                         '"data/logo.png"'), FORMAT_C_FRAMES[tag]):
        src = src.replace(old, f'"data/{new}"', 1)
    out = {}
    for dev in (cuda_device, "cpu"):
        scene = build_text(src, device=dev, base_dir="scenes")
        assert scene.textures.n_levels.shape == (3,)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out[str(dev)] = wavefront.render(scene, trace.build(scene.geometry),
                                         seed=0, xres=8, yres=8)
        if dev != "cpu":
            assert all(n > 0 for n in kernels.LAUNCHES.values())
    for name in ("RGBA", "direct_diffuse", "indirect_diffuse",
                 "indirect_specular"):
        a, b = out["cuda"][name].cpu().numpy(), out["cpu"][name].numpy()
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert float(out["cuda"]["direct_diffuse"].mean()) > 0.0
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


FORMAT_D_DIGESTS = {
    "scenes/data/formats_d/crop_cinema2k.j2k":
        "b3def4a753f0baf96ff7cc4be62a815ce2ad2492b764b2eb0ae9b216e2c04d77",
    "scenes/data/formats_d/crop_cinema4k.j2k":
        "b3def4a753f0baf96ff7cc4be62a815ce2ad2492b764b2eb0ae9b216e2c04d77",
    "scenes/data/formats_d/crop_cprl.j2k":
        "3ddcc5ec4c888b7610b1739ebcbf874c67c44525ffdae54e526dedad12a059fc",
    "scenes/data/formats_d/crop_lrcp.j2k":
        "87b7534b86e9bbccf623fc1ed98814e831cd86642329ff59bbb7c5ef27e6a99e",
    "scenes/data/formats_d/crop_palette.jp2":
        "a551c82465d61e288863fa7055092bd79e32ac2d705fbbf68874994385199078",
    "scenes/data/formats_d/crop_pcrl.j2k":
        "d08ee73a38b5a124fc26f93e0557a0491e1bdb3da6f973e10e5b7f88d3be6146",
    "scenes/data/formats_d/crop_rlcp.j2k":
        "a7c653284d0564e7a53bd9e7eab1d92546a0350a66aa1e3ab8dd20f7c12e960c",
    "scenes/data/formats_d/crop_rpcl.jp2":
        "d11978a475ad419d42cf6bf56405f8c81079f6fcc5e8bfbd02f8963892053c10",
    "scenes/data/formats_d/grid_anim_lossless.webp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_d/grid_jp2.icns":
        "70842a5dae3a8d8f3733e512cb2d0355219a52c90484e9a530c56cc9f557fef1",
    "scenes/data/formats_d/grid_tiles_rpcl.j2k":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_d/logo_anim_lossy.webp":
        "60e6a2131de7be3b407f416f65121c3d088514cc28cd33343776114207075ddb",
    "scenes/data/formats_d/logo_grey16.jp2":
        "f25f028176b10ec7bb91486872f37225e5aeb087daa3f15911c22effcb511dde",
    "scenes/data/formats_d/logo_la.jp2":
        "7425b5387a9549f4e0a940a766156a42b7be62143b0b21e07df28a32ab0f0379",
    "scenes/data/formats_d/logo_rgba_lossless.jp2":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_d/texture_2048.jp2":
        "a014be28b63695fce9d6d732fc537c1567ccfecf68184666ef20e7347154043c",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_D_DIGESTS))
def test_committed_image_formats_d_decode_to_their_digests(cuda_device,
                                                           path):
    """The JPEG 2000 and animated WebP decoders on the card's machine,
    which has no PIL (the tier-1 of JPEG 2000 built there by g++): every
    committed file of scenes/data/formats_d decodes to the digest of
    PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_D_DIGESTS[path]


# chip_smoke.py phase 38's frames, in the textured scene's three MayaFile
# slots (the grid, the logo, the inverted logo)
FORMAT_D_FRAMES = {
    "I": ("formats_d/texture_2048.jp2", "formats_d/logo_rgba_lossless.jp2",
          "formats_d/logo_anim_lossy.webp"),
    "J": ("formats_d/crop_palette.jp2", "formats_d/grid_tiles_rpcl.j2k",
          "formats_d/grid_anim_lossless.webp"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_D_FRAMES))
def test_format_d_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """chip_smoke.py phase 38's frame (scenes/textured_disk.ass with a
    2048x2048 9/7 JP2, a lossless RGBA JP2 and an animated lossy WebP, or
    a palette JP2, a tiled J2K and an animated lossless WebP in its
    texture slots) at 8x8 and its own AA 3 and GI samples: through both
    kernels on the card, held to the CPU render with chip_smoke.py's
    tolerance."""
    _frame_matches_the_cpu(cuda_device, FORMAT_D_FRAMES[tag])


def _frame_matches_the_cpu(cuda_device, images):
    """The textured scene with `images` in its three MayaFile slots at 8x8
    on the card (both kernels launched) and the CPU, held together."""
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build_text

    with open("scenes/textured_disk.ass") as f:
        src = f.read()
    for old, new in zip(('"data/grid.png"', '"data/logo.png"',
                         '"data/logo.png"'), images):
        src = src.replace(old, f'"data/{new}"', 1)
    out = {}
    for dev in (cuda_device, "cpu"):
        scene = build_text(src, device=dev, base_dir="scenes")
        assert scene.textures.n_levels.shape == (3,)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out[str(dev)] = wavefront.render(scene, trace.build(scene.geometry),
                                         seed=0, xres=8, yres=8)
        if dev != "cpu":
            assert all(n > 0 for n in kernels.LAUNCHES.values())
    for name in ("RGBA", "direct_diffuse", "indirect_diffuse",
                 "indirect_specular"):
        a, b = out["cuda"][name].cpu().numpy(), out["cpu"][name].numpy()
        assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert float(out["cuda"]["direct_diffuse"].mean()) > 0.0
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]


FORMAT_E_DIGESTS = {
    "scenes/data/formats_e/gradient_q5_speed0.avif":
        "a65dfe44180ed4d5158089ca582b9f192dfbf46a187f8a3a0c8c4ff95d1b0c5b",
    "scenes/data/formats_e/grid_lossless_444.avif":
        "9927901a567a92477ea7dbab1bf36de9a766f2dac7f81699245b5224e3801964",
    "scenes/data/formats_e/grid_mirrored.avif":
        "3058ca2c12802b89b74121d47cb77bfd4eed67b0aea3ac6c40fd3fe0ea148a93",
    "scenes/data/formats_e/grid_q50.avif":
        "ad7980f1eb83fd37879d56a2069acfd5a9af12abef273e6f46d8ac1600ce87fb",
    "scenes/data/formats_e/grid_speed0.avif":
        "6a29efe6998ae66201cae83baf00d14f911c67ab12fdf4e83d9b646470fdbb73",
    "scenes/data/formats_e/logo_grey_400.avif":
        "ab4446635cd496cfa7a2c79898d822b09c77ef0c63426e1f36201878179ff0bc",
    "scenes/data/formats_e/logo_icc_exif_xmp.avif":
        "b72cfc58763ceb21e1d1e6b7315349afbb55afd10b340ad38fa073de99ad67ca",
    "scenes/data/formats_e/logo_limited_422.avif":
        "92ccd65b7b5b354b164693712b0d3d5dd6b549e7472fef9574b731a5c0269699",
    "scenes/data/formats_e/logo_premultiplied.avif":
        "8951e7ac20430acf1716b39d8be1395057c9eb658b0b5232eb33370b61f1f207",
    "scenes/data/formats_e/logo_rgba.avif":
        "b72cfc58763ceb21e1d1e6b7315349afbb55afd10b340ad38fa073de99ad67ca",
    "scenes/data/formats_e/odd_17x33.avif":
        "14660b5b38e6d59a3c7cf4c66f28d048f66952e2643e2301db05b5d30543c231",
    "scenes/data/formats_e/odd_17x33_rgba.avif":
        "1b0c27fee17fe01c5e186a9b6fc8eb73912f9d3e58f5c04a1a1671b0c5a6936d",
    "scenes/data/formats_e/photo_420_q0.avif":
        "d1ac0b77e996fe974010a48ce7a45f537cae758150dc4aff975682ca0af9fe95",
    "scenes/data/formats_e/photo_422_q50.avif":
        "2f1dfa7a4004d7b123d4f4c1bff910f48e456d3e83de995eb300e20c16ea7692",
    "scenes/data/formats_e/photo_444_limited.avif":
        "300ada87c0de466103e8c44529b1be69d52de2739ecaed6dd4910bdacf752a4c",
    "scenes/data/formats_e/photo_cdef.avif":
        "aec5a13c3deb61e3a89ac7be969ece00cda50fbd211bf6dfe51fea748301f893",
    "scenes/data/formats_e/photo_deltaq_lf.avif":
        "2554931d1db0c95153fcd417123dcacc8befc4224c976dfcaf2f018ee5635e6c",
    "scenes/data/formats_e/photo_lossless.avif":
        "51e2b527262cea421fb4bb663d45f3de2c0d2296090737792a4c4f1f20ec94fb",
    "scenes/data/formats_e/photo_restoration.avif":
        "3a882b2c72bf1c6b84ecd263f81f4bc45d9673c3bb15cc62b613e24ba7d4eba6",
    "scenes/data/formats_e/photo_speed0.avif":
        "515f89fb1a77c6f1d3d750fd8ab5a7adafa29444c326d58c851808932bab6bd7",
    "scenes/data/formats_e/photo_tiles.avif":
        "b22954c607b3ec2f73025ce383c45f1b6acce61eb747d4c1b79eb7acc24358cc",
    "scenes/data/formats_e/px_1x1.avif":
        "c08134ad48cdadc7fa6e9e810e6588cf28f84b996b45ddc95205986f0372539e",
    "scenes/data/formats_e/texture_2048.avif":
        "210b19f6374af4dd11eca0f429689d9d126e0f832e27e135cb15376fc8e12662",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_E_DIGESTS))
def test_committed_image_formats_e_decode_to_their_digests(cuda_device,
                                                           path):
    """The AVIF decoder on the card's machine, which has no PIL (its AV1
    tile decoder built there by g++): every committed file of
    scenes/data/formats_e decodes to the digest of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_E_DIGESTS[path]


# chip_smoke.py phase 40's frames, in the textured scene's three MayaFile
# slots (the grid, the logo, the inverted logo)
FORMAT_E_FRAMES = {
    "K": ("formats_e/texture_2048.avif", "formats_e/logo_rgba.avif",
          "formats_e/logo_premultiplied.avif"),
    "L": ("formats_e/grid_lossless_444.avif", "formats_e/logo_grey_400.avif",
          "formats_e/logo_limited_422.avif"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_E_FRAMES))
def test_format_e_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """chip_smoke.py phase 40's frame (scenes/textured_disk.ass with a
    2048x2048 AVIF, an RGBA AVIF and a premultiplied one, or a lossless
    4:4:4 AVIF, a 4:0:0 AVIF with alpha and a limited-range 4:2:2 AVIF in
    its texture slots) at 8x8 and its own AA 3 and GI samples: through
    both kernels on the card, held to the CPU render with chip_smoke.py's
    tolerance."""
    _frame_matches_the_cpu(cuda_device, FORMAT_E_FRAMES[tag])


FORMAT_F_DIGESTS = {
    "scenes/data/formats_f/grid_1x2.avif":
        "4cda93acb42cca558449a6fc48354f5f8116ff3135b506cd57ed5aa12abb47ab",
    "scenes/data/formats_f/grid_2x1.avif":
        "33be1b6896c0ba723780ef918bc0fd6906abd772aabbdfd7becffb8f5f18e828",
    "scenes/data/formats_f/grid_2x2_cropped.avif":
        "6886ca3db68212615dd3962a209014a7b372786c312099329f06590376071c8a",
    "scenes/data/formats_f/grid_3x3_odd_444.avif":
        "4e176f242aa7944d1e7ec0ebde359ec14ed2440db9834935bc3a546800da4532",
    "scenes/data/formats_f/grid_rgba.avif":
        "4cda93acb42cca558449a6fc48354f5f8116ff3135b506cd57ed5aa12abb47ab",
    "scenes/data/formats_f/logo_odd_grain_csfl.avif":
        "481ba2dcd2d831403f7ec90cc655ab9c1344f474f13f1b5deecde01bcb20a4cc",
    "scenes/data/formats_f/logo_qm.avif":
        "32508286ffaa50cb15b23ac6f60c9ba5deebf3372e4a0e62ab02b843cd790b7c",
    "scenes/data/formats_f/logo_qm_444_rgba.avif":
        "eee4402423d3b47289070e9175b13d8b8496c7c349ff3d43d269140fd4ed6cb4",
    "scenes/data/formats_f/logo_sequence_rgba.avif":
        "999d40dd536917ae5514b6e157c3edf3aa973eea80463efd9c91e2aeea744616",
    "scenes/data/formats_f/odd_grain_rgba.avif":
        "6b0bd06bf8cc777e93b9eb55e2ef8321e61913bf73c262de83a155563b60381c",
    "scenes/data/formats_f/odd_sequence_444.avif":
        "c749309b8426ef3236c01a449931919acde463ea68e2603fa60277af02ac19ca",
    "scenes/data/formats_f/photo_grain_400.avif":
        "713d8a3993c086cd37bfe70b17ae26b088065ec7d745a8ea77948de936668214",
    "scenes/data/formats_f/photo_grain_422.avif":
        "512e87ac6776b2a52918c0efa21cd9fd830ec0056e476abe1ec7bf17675513f8",
    "scenes/data/formats_f/photo_grain_444.avif":
        "b21119363ded0beeeaef21ec44763b9c04cef1053ab89428a3f3f8d2cd6034ce",
    "scenes/data/formats_f/photo_grain_clip.avif":
        "f36071a2c800bb077cb1b2c68b66517dbec9721fb9fdc926fc057811c3a2c364",
    "scenes/data/formats_f/photo_qm_400.avif":
        "808e69ebf7d9224847e0182314141bc3597b9967ac8c64163edb961aa54c4615",
    "scenes/data/formats_f/photo_qm_420.avif":
        "bcc0ae35ed3733be5684af866a85f0241f66cf943085cd969585948b708cd3bd",
    "scenes/data/formats_f/photo_qm_422.avif":
        "cd7758235b1acb21eb2a745a9d469c34887e2f266b754ee0960a1dada8cb5d3d",
    "scenes/data/formats_f/photo_sequence.avif":
        "0ec148a6755f03fd8bfe2d47bdb6be9fa88d9c1dead0bd3ea140f81961484e53",
    "scenes/data/formats_f/px_1x1_grain.avif":
        "80a028b2c605ce3d66961dd721d658e3bddee02cf044551efcaa22f75114a3b0",
    "scenes/data/formats_f/texture_2048_grain.avif":
        "af4a350fae10b0ce0e1103989a02869359e853e7e0fb4b40be4e77aa7dcf874c",
    "scenes/data/formats_f/texture_2048_grid.avif":
        "3bd3102b7f03bb1098a67c9e9deba700bedf05c81cde670d133137e19d41fb54",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_F_DIGESTS))
def test_committed_image_formats_f_decode_to_their_digests(cuda_device,
                                                           path):
    """The AVIF decoder on the card's machine, which has no PIL: every
    committed file of scenes/data/formats_f (quantizer matrices, film
    grain, image sequences, grids) decodes to the digest of PIL's
    decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_F_DIGESTS[path]


# chip_smoke.py phase 42's frames, in the textured scene's three MayaFile
# slots (the grid, the logo, the inverted logo)
FORMAT_F_FRAMES = {
    "M": ("formats_f/texture_2048_grain.avif",
          "formats_f/logo_sequence_rgba.avif", "formats_f/logo_qm.avif"),
    "N": ("formats_f/texture_2048_grid.avif",
          "formats_f/logo_qm_444_rgba.avif",
          "formats_f/logo_odd_grain_csfl.avif"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_F_FRAMES))
def test_format_f_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """chip_smoke.py phase 42's frame (scenes/textured_disk.ass with a
    2048x2048 film-grain AVIF, an RGBA image sequence and a
    quantizer-matrix AVIF, or a 2048x2048 grid, a 4:4:4 quantizer-matrix
    AVIF with alpha and an odd-size film-grain AVIF in its texture slots)
    at 8x8 and its own AA 3 and GI samples: through both kernels on the
    card, held to the CPU render with chip_smoke.py's tolerance."""
    _frame_matches_the_cpu(cuda_device, FORMAT_F_FRAMES[tag])


FORMAT_G_DIGESTS = {
    "scenes/data/formats_g/grid_scaled_tiles.avif":
        "aab366a351ef92721b655498aea72e4c0bdf824a20fdfaa4629795407d15a8c5",
    "scenes/data/formats_g/grid_ycbcr_2x2_lzw.tif":
        "d551ef075e9db8da02f7b203d0e2bc0938277792a73bb5c2c52c01a0ce8349eb",
    "scenes/data/formats_g/height_1024_float_pred3.tif":
        "8d2bb00f108b8f7d22ae973b3c2d408ec4dccc14c7672fd122468c910b5d12a2",
    "scenes/data/formats_g/logo_int16_signed.tif":
        "8161cec1d4d28cd5584b69f5d196470401b75e179d8d1cc021d40badf91b7c02",
    "scenes/data/formats_g/logo_rgb_rle_layers.psd":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_g/logo_scaled_ispe.avif":
        "9ff7f421a1b5dfc5bf8f2bd4e197b0b91dac60ea501c5c6e3028edecf74617eb",
    "scenes/data/formats_g/logo_sycc.jp2":
        "598a8be5ad1c0024dd367b60c5d948059f52b250962af1ae362b8a7bdd03e825",
    "scenes/data/formats_g/odd_bitmap.psd":
        "14d9ce0209c20f421ac95252bfa82a19493c67f61d95eb6f05f06fdf5531f73c",
    "scenes/data/formats_g/odd_cmyk5_raw.psd":
        "91df149e0c473e662d4d55b679033daed272b34fa3b28f50257621e7efc104b8",
    "scenes/data/formats_g/odd_duotone_layers.psd":
        "8546f1639dffc80b91862f4d9bace0a575b117562b3dbfaf73be2e4a15d3a4cd",
    "scenes/data/formats_g/odd_float_minwhite_raw.tif":
        "33bf392a5b5dd619c7835bb8f57a80fd77ef3d846150815b36e3580f0879bf84",
    "scenes/data/formats_g/odd_float_mm_raw_planar.tif":
        "e316916794f52b41ef97892d95b40e999ffb212cb3e6f17bfadb45aa57eae4aa",
    "scenes/data/formats_g/odd_float_mm_tiles_lzw_pred3.tif":
        "07fb8807f0c98238845551898d3113fb0786f7dcdaef0e9a1edf45af34c0e63a",
    "scenes/data/formats_g/odd_grey_rle.psd":
        "8546f1639dffc80b91862f4d9bace0a575b117562b3dbfaf73be2e4a15d3a4cd",
    "scenes/data/formats_g/odd_indexed.psd":
        "7f0b7a2904c517ec3fe186dca51472c4f065629eb93029d5562c7391772a5f7d",
    "scenes/data/formats_g/odd_int16_signed_mm_deflate.tif":
        "c84f3f9d6a421abd122970b36ecb29c8f3306260c925cd287bbf7221c7b9862c",
    "scenes/data/formats_g/odd_int32_signed_packbits.tif":
        "c84f3f9d6a421abd122970b36ecb29c8f3306260c925cd287bbf7221c7b9862c",
    "scenes/data/formats_g/odd_int8_signed.tif":
        "a04e12bfd70c23c93e91f039e491839c94a565239f2a6921c8eca5b353090526",
    "scenes/data/formats_g/odd_multichannel_spill.psd":
        "1ee8cdc9f87f385cc4467d674913cc34869974457614b40a4bcd7131f36325f9",
    "scenes/data/formats_g/odd_rgba_rle.psd":
        "91df149e0c473e662d4d55b679033daed272b34fa3b28f50257621e7efc104b8",
    "scenes/data/formats_g/odd_scaled_420_rgba.avif":
        "a81079dd57df00f51f8b0a55092c155404adc20ae9d3fbb0485928f5237a1d8f",
    "scenes/data/formats_g/odd_sycc.j2k":
        "ab2c2a95386ae01011b06473d336cd4415a4aff0082033d515db4cf41c291f1c",
    "scenes/data/formats_g/odd_sycc_rgba.jp2":
        "0eb666ce778530f995de5f80bac1f3043d6d9f11561bd62d29843b8acb6d5ee7",
    "scenes/data/formats_g/odd_uint32_lzw_pred2.tif":
        "29a5ed34335c82d05e7169d18fdce8150a7706bc04d2163c0bb45c5010fba81a",
    "scenes/data/formats_g/odd_ycbcr_1x2_lzw.tif":
        "9e807dff915dc27f6999e0bc5448a7cb5260b6f0e45f20d683bfcbe51370daa3",
    "scenes/data/formats_g/odd_ycbcr_2x1_mm_pred2.tif":
        "06e2aea1dc4bb6a181f318be2352fa105a4eef299afb279deac47fc9c184cf6e",
    "scenes/data/formats_g/odd_ycbcr_4x2_bt709_studio.tif":
        "e7bacaa80d514f9d4efe2dfcddd17a24ec789c2cdf18618f6a2fb38f24dbdcf6",
    "scenes/data/formats_g/odd_ycbcr_4x4_tiles_deflate.tif":
        "3c03327176f922d0903eaf36317b0f6eaf632a18276c33bb2c1adf33374defd6",
    "scenes/data/formats_g/odd_ycbcr_default_2x2.tif":
        "722b056613ad38649b91f3a1bced3bbab452b56f354a85c729c69574f2ada5de",
    "scenes/data/formats_g/odd_ycbcr_pil_packbits.tif":
        "e2fc7f66a916af36f43b7879508e4c6f016dcccee4b889a6d548cc655b75c700",
    "scenes/data/formats_g/photo_cmyk_rle.psd":
        "69194ec3da9e830ffd79b8408548fab7d16514f2b7011a6c7a350de4ca600e1f",
    "scenes/data/formats_g/photo_scaled_down34.avif":
        "25e567d1d4cb61844b066097b9a8b26c4af67a68b6395e13c758e1e929ee8af9",
    "scenes/data/formats_g/sequence_scaled.avif":
        "afe4db386d3d87a113f44b25ee1a5579e657f08a9d8d6c74d662f7a123ffd234",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_G_DIGESTS))
def test_committed_image_formats_g_decode_to_their_digests(cuda_device,
                                                           path):
    """The decoders on the card's machine, which has no PIL: every
    committed file of scenes/data/formats_g (float and signed TIFF, YCbCr
    TIFF, sYCC JPEG 2000, PSD, AVIF frames libavif scales) decodes to the
    digest of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_G_DIGESTS[path]


# chip_smoke.py phase 44's frames, in the textured scene's three MayaFile
# slots (the grid, the logo, the inverted logo)
FORMAT_G_FRAMES = {
    "O": ("formats_g/height_1024_float_pred3.tif",
          "formats_g/logo_int16_signed.tif",
          "formats_g/logo_rgb_rle_layers.psd"),
    "P": ("formats_g/grid_ycbcr_2x2_lzw.tif", "formats_g/logo_sycc.jp2",
          "formats_g/logo_scaled_ispe.avif"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_G_FRAMES))
def test_format_g_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """chip_smoke.py phase 44's frame (scenes/textured_disk.ass with a
    1024x1024 float height map, a 16-bit signed TIFF and an RLE RGB PSD,
    or a subsampled YCbCr TIFF, an sYCC JP2 and an AVIF libavif scales,
    in its texture slots) at 8x8 and its own AA 3 and GI samples: through
    both kernels on the card, held to the CPU render with chip_smoke.py's
    tolerance."""
    _frame_matches_the_cpu(cuda_device, FORMAT_G_FRAMES[tag])


FORMAT_H_DIGESTS = {
    "scenes/data/formats_h/grid.xpm":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_h/logo_dxt1.ftex":
        "e6eb01bd1e8a05a45104aeffb554e32da4f6c1a35a33ed959c749730f8ace3e6",
    "scenes/data/formats_h/logo_lab_rle.psd":
        "aaa8db6a2eed862bbb8dc071d151a515823ab55bc6384117393d0a846a6c6952",
    "scenes/data/formats_h/logo_rle24.ras":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_h/odd.imt":
        "bb97b8e787ef025674c8f898b54f19ff31c020f8c1ae04e3a0440b26614dff31",
    "scenes/data/formats_h/odd.pixar":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd.xvthumb":
        "a1df4c45ac91c67b62679b56b1c821faceffeedfc0fad8177f3e5e2e985fd5ef",
    "scenes/data/formats_h/odd_16bit.mcidas":
        "d19978fd6926d907ca658b97337520209ae9c8e9c4b14c934c363d68f85f4e3c",
    "scenes/data/formats_h/odd_32bit.mcidas":
        "8bea24d20ef5c1bc042888885a1c9a744d3e5141ab33d47cc9ec2c038d51030b",
    "scenes/data/formats_h/odd_8bit.mcidas":
        "bb97b8e787ef025674c8f898b54f19ff31c020f8c1ae04e3a0440b26614dff31",
    "scenes/data/formats_h/odd_bgr32_rle.ras":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_bilevel.ras":
        "12297ef5b93f14b082049f303c8a2a697a538e29e569b532217656f11e4588cb",
    "scenes/data/formats_h/odd_bilevel_rle.ras":
        "04873d81115c2e1b9f877dda673e1a321dbb4442e0aa39b0f2996291e0621cdc",
    "scenes/data/formats_h/odd_grey4.ras":
        "414afd8a17fa6095c8f324b5a35c41b0b722b051329012bbd292f106590e2430",
    "scenes/data/formats_h/odd_grey4_pal.ras":
        "a1f8f5ceb8da9308bad11c92d2a1ec42c2ebdb03ffe6ebd2b638e6843cb63f58",
    "scenes/data/formats_h/odd_grey8.ras":
        "bb97b8e787ef025674c8f898b54f19ff31c020f8c1ae04e3a0440b26614dff31",
    "scenes/data/formats_h/odd_grey8_pal_rle.ras":
        "d07856adc5c2cd374efccdb74f80d1e815c2ebf135bbd94e273a0f1bfdd1c62f",
    "scenes/data/formats_h/odd_lab_jpeg.tif":
        "67df6576ca494df6ae1cfd0f3e0eed89f6ce0fb16bf62298e4ed1599f47adb23",
    "scenes/data/formats_h/odd_lab_lzw_mm.tif":
        "3338ed9e4f69d95a2c3d8d3f771846ebb2474413b0267b0c4204a1e7ca3e04ac",
    "scenes/data/formats_h/odd_lab_packbits_tiles.tif":
        "3338ed9e4f69d95a2c3d8d3f771846ebb2474413b0267b0c4204a1e7ca3e04ac",
    "scenes/data/formats_h/odd_lab_raw.psd":
        "3338ed9e4f69d95a2c3d8d3f771846ebb2474413b0267b0c4204a1e7ca3e04ac",
    "scenes/data/formats_h/odd_many_2chars.xpm":
        "42b01fa8b5b81ce66b1befd56ee50158dc3c62d1967a0b38d28024d9aae62439",
    "scenes/data/formats_h/odd_pages.dcx":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_rgb.ftex":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_rgb32_rgb_order.ras":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_v1_grey.gbr":
        "bb97b8e787ef025674c8f898b54f19ff31c020f8c1ae04e3a0440b26614dff31",
    "scenes/data/formats_h/odd_v2_rgba.gbr":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_zstd_grey16_size.tif":
        "8bea24d20ef5c1bc042888885a1c9a744d3e5141ab33d47cc9ec2c038d51030b",
    "scenes/data/formats_h/odd_zstd_mm_float_pred3.tif":
        "a70e25e811d699bbc050a13853fb21fbb15798d252b7bb052949ee18871d0d4b",
    "scenes/data/formats_h/photo_512_zstd_tiles_pred2.tif":
        "5f1e5247503101cd046b8df73ec3b287f37690d74cca35571c217e606591540e",
    "scenes/data/formats_h/texture_1024_lab_zstd.tif":
        "a224c154faad8a39f9105048b7409be3ce930931017a5ea11f53a65dc77990c5",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_H_DIGESTS))
def test_committed_image_formats_h_decode_to_their_digests(cuda_device,
                                                           path):
    """On the machine with the card (no PIL there): every committed file
    of scenes/data/formats_h (ZSTD and LAB TIFF, LAB PSD, Sun raster, XPM,
    FTEX, DCX, GBR, IMT, McIdas, PIXAR, XV thumbnail) decodes to the
    digest of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_H_DIGESTS[path]


FORMAT_I_DIGESTS = {
    "scenes/data/formats_i/grey_restart_resync.jpg":
        "9efbe8668ffa17180c95ce1804c2ecb155dbed6e7530200c196e762d0c415e88",
    "scenes/data/formats_i/grid_bad_code.jpg":
        "271c40617cd9861173998400b8b84ee786bd275b2bdd557eaa77726d33cc197e",
    "scenes/data/formats_i/grid_brun.flc":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_i/grid_eoi_lost.jpg":
        "95c6e193d2be4e9f04f28f29048cfc0acf2ac85fc03479fa7c978f919caa9603",
    "scenes/data/formats_i/grid_jpeg_rgb.iptc":
        "95c6e193d2be4e9f04f28f29048cfc0acf2ac85fc03479fa7c978f919caa9603",
    "scenes/data/formats_i/grid_marker_hit.jpg":
        "e90d480e11be770ebd5fa27b69749b504c5120d033bf49538e80f65e28dedf95",
    "scenes/data/formats_i/grid_simd_idct.jpg":
        "bfdba60e64efd2c7f5faab18da669686aae317d18926f3502d6f3dd88aa0d5d3",
    "scenes/data/formats_i/height_512_16bit_gzip.fits":
        "b1928e3847cee529bc77fbec4d212096d9028942dc10871e2ebea9ab4b114557",
    "scenes/data/formats_i/idct_extremes.jpg":
        "8fa941d8d953e73101a28026ad4b6931f9153452a6526101b6ef62fbf9bb1eac",
    "scenes/data/formats_i/logo_color64_lc.fli":
        "9235ce5548639131ac5263a311c9dbe788c51fc212c274ebf86365af314d5d2e",
    "scenes/data/formats_i/logo_progressive_damaged.jpg":
        "d0c63af717edb1452e204262ae2b269ae12b28be3f586ae53700f8057fab93ef",
    "scenes/data/formats_i/logo_progressive_refine_damaged.jpg":
        "f9f7fdbb609ab7250d937707b7a84177e0feb4f3816e25bb5718b7e311fed600",
    "scenes/data/formats_i/logo_progressive_smoothed.jpg":
        "0c8b53f71072fd528afd6388b87170923925747eb9610810d304908e5c6a2ec2",
    "scenes/data/formats_i/logo_raw_rgb_band.iptc":
        "a48a51cfb18fb128bac5abcae1c3cec84171ddf1db242099c1c8d9062eb5fe03",
    "scenes/data/formats_i/odd_16bit.fits":
        "b893342bd21033ebd2982643f04756d8be6f19547f2aacdd222b54244df77fbe",
    "scenes/data/formats_i/odd_32bit.fits":
        "a11dc20a06020aa1e412cfda48637db9efa22a6bfdf36fd81d8e41838b733ac7",
    "scenes/data/formats_i/odd_8bit.fits":
        "263a356d19ff7d7804b61a25b5bdc5435b50a0ec4fe8b04a9a26a2feafeb547b",
    "scenes/data/formats_i/odd_copy_ss2.flc":
        "f0ee3cebc30e3928bc2bc52b335a0914845144a03024b832c13bcc97a3f2b516",
    "scenes/data/formats_i/odd_float32.fits":
        "ef7ea9e7d344b663215acb5e12a85f99243cf09b2bbb6616e5968111b623508e",
    "scenes/data/formats_i/odd_float64.fits":
        "1f1880d3314bb461c938b0a2cbad86082fc5feef741794749c450b4a1f5e68fc",
    "scenes/data/formats_i/odd_gzip_tiles.fits":
        "45ae504ffcff808acc26af288699f1ad4e4f3e3adbf9db052f1d7e85b27f3065",
    "scenes/data/formats_i/odd_jpeg_grey.iptc":
        "acd0ef9d34a327a5979eee7e7db3f6b3b4c4b56c807f3f1ac2bd76e8fb7e9243",
    "scenes/data/formats_i/odd_lab_jpeg_damaged.tif":
        "b09b55ea3ee94fb5214e56c49fa5a57b9176480a11404468fc9fb6329ae9fd8d",
    "scenes/data/formats_i/odd_naxis1.fits":
        "ccf503c4464a74530639b1bdfd14ebb9561e2d1e5314429a87fce9e574a5656f",
    "scenes/data/formats_i/odd_naxis3.fits":
        "263a356d19ff7d7804b61a25b5bdc5435b50a0ec4fe8b04a9a26a2feafeb547b",
    "scenes/data/formats_i/odd_raw_cmyk_band.iptc":
        "3404e61a251e9bddb20bd9c875a24d522f0a1cd8b6e03ccdbd1c1312d766d2f1",
    "scenes/data/formats_i/odd_raw_grey.iptc":
        "263a356d19ff7d7804b61a25b5bdc5435b50a0ec4fe8b04a9a26a2feafeb547b",
    "scenes/data/formats_i/photo_768.pcd":
        "e56fd6ea8f88312ed29f9267c12541bdc699184cdf28571afc2453a4b6b21bbd",
    "scenes/data/formats_i/photo_768_turn270.pcd":
        "a9171b99c0b982b0f2bdcc0d4b867316022b4d52f7d945ce0c9baa98b0d8cd2d",
    "scenes/data/formats_i/photo_768_turn90.pcd":
        "cf9fdc7d9b858fba9c7bf99a076662bc79b6c9013eb6a9eb737c02f4528a425c",
    "scenes/data/formats_i/texture_640_brun.flc":
        "94c5cb97c0388e22a49a0be2f9debbdcaf9e2376b4fd2526b7540c19d8fcf420",
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FORMAT_I_DIGESTS))
def test_committed_image_formats_i_decode_to_their_digests(cuda_device,
                                                           path):
    """On the machine with the card (no PIL there): every committed file
    of scenes/data/formats_i (FLI and FLC, PhotoCD, FITS, IPTC and damaged
    JPEGs) decodes to the digest of PIL's decode."""
    import hashlib

    from rlshaders_tpu_torch.scene.texture import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    assert hashlib.sha256(px.tobytes()).hexdigest() == FORMAT_I_DIGESTS[path]


# chip_smoke.py phase 46's frames, in the textured scene's three MayaFile
# slots (the grid, the logo, the inverted logo)
FORMAT_H_FRAMES = {
    "Q": ("formats_h/texture_1024_lab_zstd.tif",
          "formats_h/photo_512_zstd_tiles_pred2.tif",
          "formats_h/logo_rle24.ras"),
    "R": ("formats_h/logo_lab_rle.psd", "formats_h/grid.xpm",
          "formats_h/logo_dxt1.ftex"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_H_FRAMES))
def test_format_h_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """Frames Q and R (the textured scene with a 1024x1024 LAB ZSTD TIFF,
    a 512x512 tiled ZSTD TIFF and an RLE Sun raster, or an RLE LAB PSD,
    an XPM and a DXT1 FTEX, in its texture slots) at 8x8 and its own AA 3
    and GI samples: through both kernels on the card, held to the CPU
    render with chip_smoke.py's tolerance."""
    _frame_matches_the_cpu(cuda_device, FORMAT_H_FRAMES[tag])


# chip_smoke.py phase 48's frames, in the same three slots
FORMAT_I_FRAMES = {
    "S": ("formats_i/texture_640_brun.flc", "formats_i/photo_768.pcd",
          "formats_i/logo_progressive_smoothed.jpg"),
    "T": ("formats_i/height_512_16bit_gzip.fits",
          "formats_i/logo_raw_rgb_band.iptc",
          "formats_i/grid_simd_idct.jpg"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(FORMAT_I_FRAMES))
def test_format_i_frames_on_the_card_match_the_cpu(cuda_device, tag):
    """Frames S and T (the textured scene with a 640x480 FLC, a PhotoCD
    and a block-smoothed cut progressive JPEG, or a 512x512 16-bit GZIP_1
    FITS, an RGB IPTC band and a damaged baseline JPEG whose samples
    follow the SIMD IDCT, in its texture slots) at 8x8 and its own AA 3
    and GI samples: through both kernels on the card, held to the CPU
    render with chip_smoke.py's tolerance."""
    _frame_matches_the_cpu(cuda_device, FORMAT_I_FRAMES[tag])


# ---------------------------------------------------------------------------
# The random draws' kernels (ops/rng.py)
# ---------------------------------------------------------------------------

# a frame512 tile's lanes: 512 x 512 pixels at AA 3
TILE_LANES = 512 * 512 * 9


def _draws(device, n):
    """Every public draw of core/rng.py at n lanes on `device`, purposes as
    ints and as a tensor; lanes int32 as the renderer keeps them, and
    int64."""
    from rlshaders_tpu_torch.core import rng

    key = rng.fold(rng.PRNGKey(2**31 + 12345), 1000, 3)
    s = 2 if n > 2**21 else 3
    lane = torch.arange(n, dtype=torch.int64, device=device)
    pix = (lane * 7919 % 786_432 - (lane % 97 == 0).long()).to(torch.int32)
    aa = (lane % 9).to(torch.int32)
    idx = (lane * 2654435761 + 2**16 - 3) & 0xFFFFFFFF
    purposes = torch.tensor([0, 5, 2**32 - 1], dtype=torch.int64,
                            device=device)
    salt = 0xC0FFEE42
    return {
        "bits": rng.bits(key, (n,), device),
        "uniform": rng.uniform(key, (n,), device),
        "uniform2": rng.uniform2(key, (n,), device),
        "stratified2": rng.stratified2(key, (n,), s, device),
        "stratified2_flat": rng.stratified2_flat(key, n, s, device),
        "sobol2": rng.sobol2(idx, lane * 40503),
        "sobol2_flat": rng.sobol2_flat(pix, aa, 4, 101 << 8, salt),
        "sobol2_flat_64": rng.sobol2_flat(pix.long(), aa.long(), 1, 7, 0),
        "sobol2_rep": rng.sobol2_rep(pix, aa, s * s, 601 << 8, 2**32 - 1),
        "sobol2_at": rng.sobol2_at(pix, idx, 203, salt),
        "sobol2_at_cols": rng.sobol2_at(pix, idx, purposes, salt),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 7, 2**20 + 3, TILE_LANES])
def test_cuda_draws_equal_cpu_draws(cuda_device, n):
    """Every draw on the card goes to its kernel, one launch each (none for
    an empty draw), and equals the CPU draw bit for bit."""
    from rlshaders_tpu_torch.ops import rng as kernels

    before = sum(kernels.LAUNCHES.values())
    card = _draws(cuda_device, n)
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES.values()) - before == (len(card) if n else 0)
    cpu = _draws("cpu", n)
    for name, want in cpu.items():
        got = card[name]
        assert got.device.type == "cuda", name
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if want.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got.cpu(), want), name


def _grid_tile(device, xres=512, tile_pixels=16384, ti=7,
               path="portbench/configs/disney_grid.ass"):
    """Tile `ti` of the disney_grid frame (or of the scene at `path`) at
    AA 3, through wavefront._tile: (rgb, aovs) of its lanes, no splat."""
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.integrator import camera, wavefront
    from rlshaders_tpu_torch.scene.build import build

    scene = build(path, device=str(device))
    accel = trace.build(scene.geometry)
    key = rng.stream(scene.options.aa_seed + 2**31 + 77)
    rays = camera.generate(scene.camera, rng.fold(key, 77), 3, xres, xres)
    tr = wavefront.TileRenderer(scene, accel, 3, xres=xres)
    tile_rays = tile_pixels * 9
    return tr.render_tile_at(rays, ti * tile_rays, tile_rays,
                             rng.fold(key, 1000 + ti))


@pytest.mark.gpu
def test_cuda_tile_equals_plain_draws_tile(cuda_device, monkeypatch):
    """One tile of the disney_grid frame on the card with the kernels'
    draws and with core/rng.py's plain tensor code forced in: the same
    rgb and AOVs, bit for bit."""
    from rlshaders_tpu_torch.core import rng

    rgb, aovs = _grid_tile(cuda_device)
    with monkeypatch.context() as m:
        m.setattr(rng, "_on_card", lambda device: False)
        rgb_p, aovs_p = _grid_tile(cuda_device)
    assert float(rgb.abs().sum()) > 0.0
    assert torch.equal(rgb.view(torch.int32), rgb_p.view(torch.int32))
    for name, plane in aovs.items():
        assert torch.equal(plane.view(torch.int32),
                           aovs_p[name].view(torch.int32)), name


@pytest.mark.gpu
def test_rng_counters_on_card_and_cpu_tiles(cuda_device):
    """The kernels draw every value of a CUDA tile and none of a CPU one."""
    from rlshaders_tpu_torch.core import tracer

    shares = {}
    for dev, xres, tile in ((cuda_device, 512, 16384), ("cpu", 16, 64)):
        tracer.take()
        with tracer.enabled(counters=True):
            _grid_tile(dev, xres=xres, tile_pixels=tile, ti=1)
            _, counters = tracer.take()
        assert counters["rng_values"] > 0
        shares[str(dev)] = (counters["rng_kernel_values"]
                            / counters["rng_values"])
    assert shares == {"cuda": 1.0, "cpu": 0.0}


@pytest.mark.gpu
def test_rng_wrappers_refuse_bad_lanes(cuda_device):
    from rlshaders_tpu_torch.ops import rng as kernels

    pix = torch.arange(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.sobol_stream(pix, pix.cpu(), 2, False, 0)
    with pytest.raises(ValueError):
        kernels.sobol_stream(pix, pix[:7], 2, False, 0)
    with pytest.raises(ValueError):
        kernels.sobol_at(pix.reshape(2, 4), pix.reshape(2, 4), 0)
    with pytest.raises(ValueError):
        kernels.threefry(0, 1, 8, kernels.UNIFORM, "cpu")
    # other integer lanes are read as int64, non-contiguous ones copied
    aa = torch.arange(16, dtype=torch.int32, device=cuda_device)[::2]
    got = kernels.sobol_stream(pix.to(torch.int16), aa, 2, True, 5)
    want = kernels.sobol_stream(pix, aa.contiguous().long(), 2, True, 5)
    assert torch.equal(got, want)


LOBES = ("eval_diffuse", "sample_diffuse", "eval_specular",
         "sample_specular", "sample_refract")
# the share of a call's lanes whose outputs may be far (4 ulps and 1e-4
# relative) from the eager code's on the card: where the kernel reaches
# libdevice's expf, logf, sinf, cosf, tanf or acosf built with
# -fmad=false, a last bit may differ and a gate flip on it; the rest is
# the same float32 arithmetic. Lanes that differ at all are logged.
LOBE_FAR_SHARE = 0.002


def _ordered(x: torch.Tensor) -> torch.Tensor:
    i = x.view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def _lobe_diff(got, want) -> tuple:
    """(lanes whose outputs differ, their largest ulp distance, lanes
    apart by more than 4 ulps and 1e-4 of max(1, |eager value|)) of a lobe
    call's outputs on the kernel and the eager path (-0 equals +0, NaN
    equals NaN)."""
    def rows(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for a in x for t in rows(a)]

    g, w = torch.stack(rows(got)), torch.stack(rows(want))
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    ulps = torch.where(same, 0, (_ordered(g) - _ordered(w)).abs())
    far = ((ulps > 4) & ((g - w).abs()
                         > 1e-4 * torch.clamp_min(w.abs(), 1.0))).any(0)
    ulps = ulps.amax(0)
    if ulps.numel() == 0:
        return 0, 0, 0
    return int((ulps > 0).sum()), int(ulps.max()), int(far.sum())


@contextlib.contextmanager
def _held_lobes():
    """Inside the block every lobe call of models/dispatch.py runs its
    kernel and then the eager code on the same inputs; yields the list of
    (entry, lanes, differing lanes, largest ulp distance, far lanes,
    launches)."""
    from rlshaders_tpu_torch.models import dispatch
    from rlshaders_tpu_torch.ops import bsdf as kernels

    calls, reals = [], {n: getattr(dispatch, n) for n in LOBES}
    on_card = dispatch._on_card

    def held(name):
        def call(*args):
            key = f"rls_bsdf_{name}"
            before = kernels.LAUNCHES[key]
            got = reals[name](*args)
            made = kernels.LAUNCHES[key] - before
            dispatch._on_card = lambda wo: False
            try:
                want = reals[name](*args)
            finally:
                dispatch._on_card = on_card
            calls.append((name, args[1].x.shape[0], *_lobe_diff(got, want),
                          made))
            return got
        return call

    try:
        for n in LOBES:
            setattr(dispatch, n, held(n))
        yield calls
    finally:
        for n, f in reals.items():
            setattr(dispatch, n, f)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["disney_grid", "glass", "skin"])
def test_lobe_kernels_equal_eager_lobes(cuda_device, scene):
    """Every lobe call of a tile on the card: one launch of its kernel, and
    its lanes equal to the eager code's on the same inputs, or a logged
    count of differing lanes with their largest ulp distance, of which at
    most LOBE_FAR_SHARE far."""
    path = {"disney_grid": "portbench/configs/disney_grid.ass",
            "glass": "scenes/glass_sphere.ass",
            "skin": "scenes/skin_closeup.ass"}[scene]
    with _held_lobes() as calls:
        _grid_tile(cuda_device, xres=64, tile_pixels=1024, ti=1, path=path)
    torch.cuda.synchronize()
    entries = {c[0] for c in calls}
    assert entries >= set(LOBES) - ({"sample_refract"}
                                    if scene != "glass" else set())
    for name, lanes, differ, ulps, far, made in calls:
        print(f"{scene} {name}: {lanes} lanes, {differ} differ from the "
              f"eager lobes, at most {ulps} ulps apart, {far} far")
        assert made == (1 if lanes else 0), name
        assert far <= LOBE_FAR_SHARE * lanes, (name, differ, ulps, far)


@pytest.mark.gpu
def test_bsdf_counters_on_card_and_cpu_tiles(cuda_device):
    """The kernels handle every lobe lane of a CUDA tile and none of a CPU
    one."""
    from rlshaders_tpu_torch.core import tracer

    shares = {}
    for dev, xres, tile in ((cuda_device, 512, 16384), ("cpu", 16, 64)):
        tracer.take()
        with tracer.enabled(counters=True):
            _grid_tile(dev, xres=xres, tile_pixels=tile, ti=1)
            _, counters = tracer.take()
        assert counters["bsdf_lanes"] > 0
        shares[str(dev)] = (counters["bsdf_kernel_lanes"]
                            / counters["bsdf_lanes"])
    assert shares == {"cuda": 1.0, "cpu": 0.0}


@pytest.mark.gpu
def test_lobe_wrappers_refuse_bad_fields(cuda_device):
    from rlshaders_tpu_torch.core.vec3 import V3
    from rlshaders_tpu_torch.models import dispatch
    from rlshaders_tpu_torch.ops import bsdf as kernels
    from rlshaders_tpu_torch.scene.build import build

    scene = build("portbench/configs/disney_grid.ass", device="cuda")
    n = 1000
    ids = torch.arange(n, device=cuda_device, dtype=torch.int32) % int(
        scene.materials.mtype.shape[0])
    m = dispatch.gather(scene.materials, ids,
                        torch.ones(n, dtype=torch.bool, device=cuda_device),
                        has_skin=False, has_disney=True)
    z = torch.zeros(n, device=cuda_device)
    wo = V3(z, z, z + 1.0)
    with pytest.raises(ValueError):
        kernels.eval_specular(m, V3(*(c.cpu() for c in wo)), wo)
    with pytest.raises(TypeError):
        kernels.eval_specular(m._replace(spec_ksn=m.spec_ksn.double()), wo,
                              wo)
    with pytest.raises(ValueError):
        kernels.eval_diffuse(m, wo, V3(z[:7], z, z))
    f, pdf = kernels.eval_specular(m, wo, wo)
    torch.cuda.synchronize()
    assert f.x.shape == (n,) and bool(torch.isfinite(pdf).all())
