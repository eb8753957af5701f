"""Multi-GPU tile sharding over torch.distributed.

Counterpart of rlshaders_tpu/parallel/mesh.py. Where JAX sees N devices in
one process and shard_maps the render over a ("dp",) mesh, PyTorch runs
one process a device (a rank): `launch` spawns them and joins them in a
process group, `make_mesh` lays the group out as a DeviceMesh, and every
rank runs `render_sharded` itself: the whole frame's camera rays, its own
block of the tiles through the full wavefront pipeline
(`wavefront.render_tiles`; the ray-query kernels on a CUDA device), its
partial framebuffer splatted on its device, and one all-reduce of the
framebuffer over "dp", the `psum` of the JAX module.

Determinism: a tile's key is folded from its GLOBAL index and its rays
start at their global offset (the Sobol AA index of a lane is its position
in the frame), as in `wavefront.render`, so the sharded frame equals the
single-process frame up to the order of the framebuffer's float sums.
Tiles are padded to a multiple of the "dp" size with padding rays (pixel
-1), which are traced and then dropped by the splat, as in the JAX module.

`shade_step` and `sharded_shade_step` are the flagship Disney BSDF step
over a ("dp", "sp") mesh with a mean over "sp" (the JAX module's `pmean`),
and `demo_render` and `demo_shade` are `launch` targets on the demo scene
and batch. `demo_scene` and `DEMO_SCENE_ASS` live in scene/demo.py and are
re-exported here, where the JAX package keeps them.
"""
from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..bsdf import disney
from ..core import rng, vec3
from ..core.vec3 import V3
from ..integrator import wavefront
from ..scene.demo import DEMO_SCENE_ASS, demo_scene  # noqa: F401

# torch threads of a CPU rank: a few ranks share the host's cores
CPU_THREADS = 2


# ---------------------------------------------------------------------------
# Processes and the mesh
# ---------------------------------------------------------------------------

def _child(fn, rank: int, world_size: int, tmp: str, backend: str,
           device: str, same_device: bool, timeout_s: float, args) -> None:
    """One rank: select the device, join the group, run fn, leave the
    group; rank 0 pickles its result into `tmp`. An exception is written
    to `tmp` for the parent and re-raised (the process exits with 1)."""
    try:
        if device == "cpu":
            torch.set_num_threads(CPU_THREADS)
        else:
            torch.cuda.set_device(0 if same_device else rank)
            torch.cuda.init()
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"),
                                          world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, *args)
        dist.destroy_process_group()
        if rank == 0:
            path = os.path.join(tmp, "result")
            with open(path + ".part", "wb") as f:
                pickle.dump(out, f)
            os.replace(path + ".part", path)
    except BaseException:
        with open(os.path.join(tmp, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(fn, world_size: int, *args, backend: str | None = None,
           device: str = "cuda", same_device: bool = False,
           timeout_s: float = 900.0):
    """Run fn(rank, *args) in `world_size` spawned processes joined in one
    default process group, and return rank 0's return value: the PyTorch
    counterpart of JAX seeing N devices in one process.

    Each rank joins through a FileStore in a fresh temporary directory
    (no port to find), with `timeout_s` as the group's timeout. The backend
    is "nccl" on "cuda" and "gloo" on "cpu" unless named. Rank r runs on
    cuda:r, or on cuda:0 for every rank with `same_device` (several ranks
    on one card need gloo: NCCL refuses two ranks on one GPU); a CPU rank
    keeps to CPU_THREADS torch threads. `fn` and `args` must pickle (a
    function of an importable module; the child imports it afresh), and so
    must rank 0's result (numpy arrays or CPU tensors). A rank that raises
    fails the call with RuntimeError carrying its traceback; ranks still
    running after `timeout_s` fail it with TimeoutError. Either way every
    rank is ended before the call returns."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rls_launch_")
    procs = [ctx.Process(target=_child, args=(
        fn, rank, world_size, tmp, backend, device, same_device, timeout_s,
        args)) for rank in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            # one read of every exit code a pass: a rank that ends between
            # two reads would be counted neither failed nor alive
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if failed:
                r, code = failed[0]
                tb = ""
                if os.path.exists(os.path.join(tmp, f"error.{r}")):
                    with open(os.path.join(tmp, f"error.{r}")) as f:
                        tb = f.read()
                raise RuntimeError(f"rank {r} of {world_size} failed (exit "
                                   f"code {code}):\n{tb}")
            alive = [p for p, c in zip(procs, codes) if c is None]
            if not alive:
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"launch: {len(alive)} of {world_size} ranks still "
                    f"running after {timeout_s} s")
            multiprocessing.connection.wait([p.sentinel for p in alive],
                                            timeout=left)
        with open(os.path.join(tmp, "result"), "rb") as f:
            return pickle.load(f)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def make_mesh(n_devices: int | None = None, sp: int = 1) -> DeviceMesh:
    """A DeviceMesh over the initialised default process group: ("dp",)
    when sp == 1, else ("dp", "sp") of shape (n // sp, sp), rank
    dp_index * sp + sp_index as JAX orders its devices. Built with
    `init_device_mesh` on the rank's device type (cuda once the process
    has selected a CUDA device, as `launch` does; else cpu).

    The unit is a process, not a device: `n_devices` defaults to the world
    size, and a mesh larger than the world raises RuntimeError (start that
    many ranks with `launch`). No caller needs a mesh smaller than the
    world, so that raises RuntimeError too. `n % sp != 0` raises
    ValueError."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "run under launch(...)")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise RuntimeError(f"make_mesh({n}) but the process group has "
                           f"{world} ranks; start {n} with launch(fn, {n})")
    if n < world:
        raise RuntimeError(f"make_mesh({n}) on a process group of {world} "
                           f"ranks: a mesh spans the whole group")
    if n % sp:
        raise ValueError(f"n_devices {n} not divisible by sp {sp}")
    device_type = "cuda" if torch.cuda.is_initialized() else "cpu"
    if sp <= 1:
        return init_device_mesh(device_type, (n,), mesh_dim_names=("dp",))
    return init_device_mesh(device_type, (n // sp, sp),
                            mesh_dim_names=("dp", "sp"))


def _axis(mesh: DeviceMesh, name: str):
    """(size, this rank's index, process group) of a mesh axis; an absent
    "sp" axis is (1, 0, None)."""
    if name not in (mesh.mesh_dim_names or ()):
        if name == "sp":
            return 1, 0, None
        raise ValueError(f"mesh has no {name!r} axis")
    group = mesh.get_group(name)
    return dist.get_world_size(group), mesh.get_local_rank(name), group


# ---------------------------------------------------------------------------
# The sharded render
# ---------------------------------------------------------------------------

def render_sharded(scene, accel, mesh: DeviceMesh, seed: int = 0,
                   tile_pixels: int = 16384, aa_samples: int | None = None,
                   xres: int | None = None, yres: int | None = None) -> dict:
    """Render the frame with tiles data-parallel over mesh axis "dp"
    (replicated over "sp"), on the scene's device: this rank's block of
    the tiles (`wavefront.render_tiles` with the "dp" size and index) and
    the all-reduce of the framebuffer over "dp". Every rank returns what
    `wavefront.render` returns, {"RGBA": (H, W, 3), aov: ..., "__stats__":
    dict}, the planes as float32 tensors on its device; `__stats__` counts
    this rank's rays."""
    dp, di, dp_group = _axis(mesh, "dp")
    fb = wavefront.render_tiles(scene, accel, seed=seed,
                                tile_pixels=tile_pixels,
                                aa_samples=aa_samples, xres=xres, yres=yres,
                                parts=dp, part=di)
    # framebuffer assembly: the ranks' partial framebuffers -> the frame
    dist.all_reduce(fb.image, group=dp_group)
    dist.all_reduce(fb.wsum, group=dp_group)
    return fb.planes()


# ---------------------------------------------------------------------------
# Flagship-BSDF step over a ("dp", "sp") mesh
# ---------------------------------------------------------------------------

def shade_step(params: disney.DisneyParams, wo: torch.Tensor, key,
               spp: int) -> torch.Tensor:
    """One Disney shading step over a pixel batch: the specular and diffuse
    MIS estimate of `spp` samples a pixel (`rng.uniform` draws, bit for
    bit `jax.random.uniform`'s), averaged over the samples. `params` holds
    (n,) fields, `wo` is (n, 3); returns (n, 3)."""
    n = wo.shape[0]
    u = rng.uniform(key, (n, spp, 4), wo.device)
    pb = disney.expand_sample_axis(params)
    wo_b = vec3.v3(wo[:, None, :])

    wi_s = disney.sample_specular(pb, wo_b, u[..., 0], u[..., 1])
    f_s = disney.eval_specular_cos(pb, wo_b, wi_s)
    p_s = disney.pdf_specular(pb, wo_b, wi_s)
    p_sd = disney.pdf_diffuse(pb, wo_b, wi_s)
    w_s = p_s / torch.clamp_min(p_s + p_sd, 1e-9)

    wi_d = disney.sample_diffuse(pb, wo_b, u[..., 2], u[..., 3])
    f_d = disney.eval_diffuse_cos(pb, wo_b, wi_d)
    p_d = disney.pdf_diffuse(pb, wo_b, wi_d)
    p_ds = disney.pdf_specular(pb, wo_b, wi_d)
    w_d = p_d / torch.clamp_min(p_d + p_ds, 1e-9)

    est = (f_s * (w_s / torch.clamp_min(p_s, 1e-9))
           + f_d * (w_d / torch.clamp_min(p_d, 1e-9)))
    return est.aos().mean(dim=1)


def _rows(params: disney.DisneyParams, rows: slice) -> disney.DisneyParams:
    """The rows of every batched field (scalar fields pass through)."""
    def f(a):
        return a if a.ndim == 0 else a[rows]

    return disney.DisneyParams(*(V3(*map(f, a)) if isinstance(a, V3)
                                 else f(a) for a in params))


def sharded_shade_step(mesh: DeviceMesh, params: disney.DisneyParams,
                       wo: torch.Tensor, key, spp: int = 8) -> torch.Tensor:
    """`shade_step` with the pixels split over "dp" and the samples over
    "sp": each rank takes its "dp" rows; without "sp" it draws with `key`
    over its own rows (as JAX's `key[0]` under shard_map does, so the draws
    differ from the unsharded step's); with "sp", rank i of the axis draws
    spp // sp samples with fold_in(key, i) and the axis averages them.
    Every rank returns the (n, 3) result, its "dp" slices gathered."""
    dp, di, dp_group = _axis(mesh, "dp")
    sp, si, sp_group = _axis(mesh, "sp")
    n = wo.shape[0]
    if n % dp:
        raise ValueError(f"batch {n} not divisible by dp {dp}")
    rows = slice(di * n // dp, (di + 1) * n // dp)
    spp_local = max(spp // sp, 1)
    if sp == 1:
        part = shade_step(_rows(params, rows), wo[rows], key, spp_local)
    else:
        part = shade_step(_rows(params, rows), wo[rows],
                          rng.fold_in(key, si), spp_local)
        dist.all_reduce(part, group=sp_group)
        part = part / sp
    parts = [torch.empty_like(part) for _ in range(dp)]
    dist.all_gather(parts, part, group=dp_group)
    return torch.cat(parts)


def demo_batch(n: int, device="cuda"):
    """A Disney material batch of n points for smoke and dry runs: (params
    with (n,) fields, wo (n, 3)), the JAX module's values (its linspace
    arithmetic in float32)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    step = i / torch.full_like(i, max(n - 1, 1))
    x = 0.05 * (1 - step) + 0.95 * step
    if n > 1:
        x[-1] = 0.95
    params = disney.make_params(
        base_color=V3(0.8 * torch.ones_like(x), 0.5 + 0.3 * x,
                      torch.full_like(x, 0.3)),
        roughness=x, metallic=0.5 * x, specular=0.8, sheen=0.3,
        subsurface=0.1)
    t = 0.4 + 0.5 * x
    st = torch.sqrt(1.0 - t * t)
    wo = torch.stack([st, torch.zeros_like(t), t], -1)
    return params, wo


# ---------------------------------------------------------------------------
# launch targets
# ---------------------------------------------------------------------------

def _rank_device(device: str) -> torch.device:
    """The device `launch` selected for this rank of a `device` launch."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def demo_render(rank: int, device: str, skin: bool = True,
                render_kw: dict | None = None) -> dict:
    """A `launch` target: `render_sharded` of `demo_scene(skin)` on this
    rank's device over `make_mesh()`. Returns {"planes": the planes as
    numpy, "stats": every rank's `__stats__`, by rank}."""
    scene, accel = demo_scene(skin=skin, device=_rank_device(device))
    out = render_sharded(scene, accel, make_mesh(), **(render_kw or {}))
    stats = [None] * dist.get_world_size()
    dist.all_gather_object(stats, out.pop("__stats__"))
    return {"planes": {k: v.cpu().numpy() for k, v in out.items()},
            "stats": stats}


def demo_shade(rank: int, device: str, n: int, sps=(1,), spp: int = 8,
               seed: int = 0) -> dict:
    """A `launch` target: `sharded_shade_step` of `demo_batch(n)` over
    `make_mesh(sp=sp)` for each sp of `sps`, key `rng.stream(seed)`.
    Returns {sp: (n, 3) numpy}."""
    params, wo = demo_batch(n, _rank_device(device))
    return {sp: sharded_shade_step(make_mesh(sp=sp), params, wo,
                                   rng.stream(seed), spp).cpu().numpy()
            for sp in sps}
