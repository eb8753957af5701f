"""The port's parallel/mesh.py on the CPU: ranks spawned by `launch` over
gloo, each a process with its own torch (no jax in the children), against
the JAX package's parallel/mesh.py on the 8-device CPU mesh of conftest.py
and against the port's own single-process `render`.

Measured (torch 2.13 CPU, jax 0.9 CPU):

* `render_sharded` at world size 4 (demo_scene(skin=False), 16x16, AA 2,
  tile_pixels 64: one tile a rank) against the JAX package's
  `render_sharded(make_mesh(4))`: every pixel of every plane within
  1.3e-7; held to JAX_ATOL.
* the port's sharded frames against its own `render` (the skin blob at
  world size 2, two tiles a rank; 18x18, AA 1, tile_pixels 100 at world
  size 3: 4 tiles padded to 6): equal bit for bit here, held to
  SELF_ATOL (the ranks' partial framebuffers add up in another order than
  render's running sum, which may move the last bit); the summed ray
  counts of the ranks equal the single process's plus those of the
  padding tiles, exactly.
* `shade_step` and `sharded_shade_step` on the (4,) and (2, 2) meshes
  against the JAX package's at demo_batch(64), spp 8: within 5.4e-7 (of
  estimates up to 0.89); held to SHADE_ATOL. The batches themselves differ
  by up to 2.4e-7: XLA rewrites jnp.linspace's float32 arithmetic (a
  product by the reciprocal, folded constants, multiply-adds fused as its
  CPU compiler decides), which the port's `demo_batch` does not imitate.

Every launch has a time limit (TIMEOUT_S), so a hung rank fails one test.
"""
import functools
import math
import operator
import os
import pickle
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rlshaders_tpu.core import rng as jrng
from rlshaders_tpu.parallel import mesh as jmesh
from rlshaders_tpu_torch.core import cpu_math, rng
from rlshaders_tpu_torch.integrator import camera as tcamera
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.parallel import mesh as tmesh

cpu_math.settle()

TIMEOUT_S = 240
PLANES = ("RGBA", "direct_diffuse", "direct_specular", "indirect_diffuse",
          "indirect_specular", "refraction", "sss")
JAX_KW = dict(tile_pixels=64, aa_samples=2, xres=16, yres=16)
CASES = {
    # (world size, skin, render keywords)
    "skin": (2, True, dict(tile_pixels=64, aa_samples=2, xres=16, yres=16)),
    "uneven": (3, True, dict(tile_pixels=100, aa_samples=1, xres=18,
                             yres=18)),
}
JAX_ATOL = 1e-6
SELF_ATOL = 1e-6
SHADE_ATOL = 2e-6


def _launch(fn, world, *args):
    return tmesh.launch(fn, world, *args, device="cpu", timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def world4():
    port = _launch(tmesh.demo_render, 4, "cpu", False, JAX_KW)
    shade = _launch(tmesh.demo_shade, 4, "cpu", 64, (1, 2))
    scene, accel = jmesh.demo_scene(skin=False)
    ref = jmesh.render_sharded(scene, accel, jmesh.make_mesh(4), **JAX_KW)
    return port, shade, ref


@pytest.mark.parametrize("name", PLANES)
def test_render_sharded_matches_jax(world4, name):
    port, _, ref = world4
    a = port["planes"][name]
    b = np.asarray(ref[name])
    assert a.shape == b.shape == (16, 16, 3)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=JAX_ATOL)
    if name == "RGBA":
        assert a.max() > 0.0
    assert [s["tiles"] for s in port["stats"]] == [1, 1, 1, 1]


def _padding_stats(scene, accel, world: int, kw: dict) -> dict:
    """The ray counts of the tiles that pad the frame's tiles to a multiple
    of `world`, rendered alone at their global indices."""
    aa, xres, yres = kw["aa_samples"], kw["xres"], kw["yres"]
    n_rays = xres * yres * aa * aa
    tile_rays = min(kw["tile_pixels"] * aa * aa, n_rays)
    n_tiles = math.ceil(n_rays / tile_rays)
    n_tiles_p = math.ceil(n_tiles / world) * world
    key = rng.stream(scene.options.aa_seed)
    rays = tcamera.generate(scene.camera, rng.fold(key, 77), aa, xres, yres)
    rays = twave._pad_rays(rays, n_tiles_p * tile_rays - n_rays)
    tr = twave.TileRenderer(scene, accel, aa, xres=xres)
    for gt in range(n_tiles, n_tiles_p):
        tr.render_tile_at(rays, gt * tile_rays, tile_rays,
                          rng.fold(key, 1000 + gt))
    return tr.stats


@pytest.fixture(scope="module")
def sharded():
    out = {}
    for case, (world, skin, kw) in CASES.items():
        port = _launch(tmesh.demo_render, world, "cpu", skin, kw)
        scene, accel = tmesh.demo_scene(skin=skin, device="cpu")
        ref = twave.render(scene, accel, **kw)
        pad = _padding_stats(scene, accel, world, kw)
        out[case] = (port, ref, pad)
    return out


@pytest.mark.parametrize("name", PLANES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_render_sharded_matches_render(sharded, case, name):
    port, ref, _ = sharded[case]
    a = port["planes"][name]
    b = ref[name].numpy()
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=SELF_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_ray_counts(sharded, case):
    """Each rank counts its own rays; together they are the single
    process's rays and those of the padding tiles (the uneven case's
    tiles 4 and 5), which are traced and then dropped."""
    port, ref, pad = sharded[case]
    world = CASES[case][0]
    stats = port["stats"]
    assert len(stats) == world
    total = {k: sum(s[k] for s in stats) for k in stats[0]}
    single = ref["__stats__"]
    assert total == {k: single[k] + pad[k] for k in single}
    assert (pad["tiles"] > 0) == (case == "uneven")
    assert len({s["tiles"] for s in stats}) == 1


def test_shade_step_matches_jax():
    jp, jwo = jmesh.demo_batch(64)
    a = jmesh.shade_step(jp, jwo, jrng.stream(0), 8)
    tp, two = tmesh.demo_batch(64, "cpu")
    b = tmesh.shade_step(tp, two, rng.stream(0), 8)
    assert b.shape == (64, 3) and torch.isfinite(b).all()
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                               atol=SHADE_ATOL)


@pytest.mark.parametrize("sp", [1, 2])
def test_sharded_shade_step_matches_jax(world4, sp):
    """The (4,) mesh and the (2, 2) mesh with its mean over "sp"."""
    _, shade, _ = world4
    jp, jwo = jmesh.demo_batch(64)
    ref = jmesh.sharded_shade_step(jmesh.make_mesh(4, sp=sp), jp, jwo,
                                   jrng.stream(0), spp=8)
    ref = np.asarray(jax.block_until_ready(ref))
    assert shade[sp].shape == (64, 3)
    np.testing.assert_allclose(shade[sp], ref, rtol=0, atol=SHADE_ATOL)


def test_demo_batch_matches_jax():
    jp, jwo = jmesh.demo_batch(64)
    tp, two = tmesh.demo_batch(64, "cpu")
    np.testing.assert_allclose(two.numpy(), np.asarray(jwo), rtol=0,
                               atol=3e-7)
    for field, a in zip(tp._fields, tp):
        a = a.aos() if isinstance(a, tmesh.V3) else a
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(jp, field)),
                                   rtol=0, atol=3e-7, err_msg=field)


@pytest.fixture
def world1(tmp_path):
    """A process group of one gloo rank in this process."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_make_mesh_raises(world1):
    assert tmesh.make_mesh().mesh_dim_names == ("dp",)
    with pytest.raises(RuntimeError, match="launch"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="not divisible by sp 2"):
        tmesh.make_mesh(1, sp=2)


def test_render_sharded_at_world_size_one_is_render(world1):
    """One rank renders every tile in render's order, and the all-reduce
    of one rank leaves the framebuffer as it is: the frame is render's,
    bit for bit, and so are its counts."""
    scene, accel = tmesh.demo_scene(skin=False, device="cpu")
    kw = dict(tile_pixels=64, aa_samples=1, xres=12, yres=12)
    out = tmesh.render_sharded(scene, accel, tmesh.make_mesh(), **kw)
    ref = twave.render(scene, accel, **kw)
    assert out["__stats__"] == ref["__stats__"]
    for name in PLANES:
        assert torch.equal(out[name], ref[name]), name


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()


def test_a_failing_rank_fails_the_launch():
    """Rank 0 divides by zero; rank 1 returns. The call raises with rank
    0's traceback instead of waiting."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed") as err:
        tmesh.launch(functools.partial(operator.truediv, 1), 2,
                     device="cpu", timeout_s=TIMEOUT_S)
    assert "ZeroDivisionError" in str(err.value)
    assert time.monotonic() - t0 < TIMEOUT_S


class _StubProcess:
    """A rank whose exit code is read from a script: each read of
    `exitcode` takes the next value and the last one stays. Rank 0 of a
    script that starts with exit code 0 has written its result."""

    def __init__(self, codes, target, args):
        self.codes = list(codes)
        self.tmp = args[3]
        self.rank = args[1]
        self.sentinel = None

    def start(self):
        if self.rank == 0 and self.codes[0] == 0:
            with open(os.path.join(self.tmp, "result"), "wb") as f:
                pickle.dump("rank 0's result", f)

    @property
    def exitcode(self):
        return self.codes.pop(0) if len(self.codes) > 1 else self.codes[0]

    def is_alive(self):
        return False


@pytest.mark.parametrize("scripts,failing", [
    (((None, 1), (0,)), 0),     # rank 0 fails between two reads
    (((0,), (None, 1)), 1),     # rank 0 returned; rank 1 fails then
])
def test_a_rank_failing_between_two_reads_fails_the_launch(
        monkeypatch, scripts, failing):
    """The wait loop decides `failed` and `alive` from one read of every
    exit code: a rank whose exit code turns non-zero between two reads
    fails the call (and no result file that was never written is
    opened, nor rank 0's result returned)."""
    it = iter(scripts)

    class Ctx:
        def Process(self, target, args):
            return _StubProcess(next(it), target, args)

    monkeypatch.setattr(tmesh.multiprocessing, "get_context",
                        lambda method: Ctx())
    monkeypatch.setattr(tmesh.multiprocessing.connection, "wait",
                        lambda objs, timeout=None: [])
    with pytest.raises(RuntimeError, match=f"rank {failing} of 2 failed"):
        tmesh.launch(operator.neg, 2, device="cpu", timeout_s=TIMEOUT_S)
