"""CUDA ray-query kernels: packed tables, build, bind and launch.

`nearest` and `occluded` launch `rls_nearest` / `rls_occluded` from
`csrc/intersect.cu`, the counterparts of the TPU kernels `_nearest_kernel`
and `_occluded_kernel` of rlshaders_tpu/ops/intersect_pallas.py. Their plain
versions are `accel.bvh.intersect` / `accel.bvh.occluded`.

The kernels read the tree and the triangles as packed records (`pack`),
built and checked once per `Accel` (accel/trace.py::from_arrays): a node is
32 bytes, (bbox_min.xyz, code) and (bbox_max.xyz, miss), where code is -1
for an inner node and `first << 3 | count` for a leaf; a triangle slot is
48 bytes, (v0.xyz, id), (e1.xyz, vis), (e2.xyz, opaque). Floats are kept
by their bits in int32 words. Beside them, the roots of up to 32 subtrees
that partition the tree (`subtree_cut`), over which the any-hit kernel
splits a ray's walk among idle lanes. Where the tables are kept during a
launch (`table_path`) follows from their size: in shared memory where both
fit ("shared"), else in global memory ("global"). Each launch checks only
the ray tensors.

The source is compiled by nvcc into a shared library with a plain C
interface at first use, into `rlshaders_tpu_torch/build/` (named by a hash
of the sources, so an edited source is rebuilt), and bound with ctypes.
The same library holds the random draws' kernels (`csrc/rng.cu`, bound by
ops/rng.py) and the lobes' (`csrc/bsdf.cu`, bound by ops/bsdf.py), so one
build serves all three. A failed build raises, and so does
a launch whose CUDA error is not 0.
Kernels run on the current torch stream (also inside CUDA graph capture)
and do not synchronise.

`LAUNCHES` counts launches per kernel and `PATH_LAUNCHES` per table path;
nothing else changes them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

from ..accel.bvh import BVH, LEAF_SIZE, Hit, Tris

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "intersect.cu")
# the library's sources and the headers they include
SOURCES = (SOURCE, os.path.join(_HERE, "csrc", "rng.cu"),
           os.path.join(_HERE, "csrc", "bsdf.cu"))
HEADERS = (os.path.join(_HERE, "csrc", "rng.cuh"),
           os.path.join(_HERE, "csrc", "bsdf.cuh"))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

NODE_WORDS = 8    # 32 B per node
TRI_WORDS = 12    # 48 B per triangle slot
# Dynamic shared memory a block may opt in to on an H100 (227 KB), less
# 1 KB for the static shared memory: the room for the tables. This is the
# one place that decides whether they fit; the kernel opts in to the
# device's largest room and a launch that asks for more fails.
SMEM_OPTIN_BYTES = 232_448
TABLE_ROOM = SMEM_OPTIN_BYTES - 1_024
CUT_PARTS = 32    # subtrees of the cut: one per lane of a warp
PATHS = {"global": 0, "shared": 1}  # intersect.cu's Path codes

LAUNCHES = {"rls_nearest": 0, "rls_occluded": 0}
PATH_LAUNCHES = dict.fromkeys(PATHS, 0)

_lib = None
_lock = threading.Lock()


class Packed(NamedTuple):
    """The kernels' tables, on the scene's device."""

    nodes: torch.Tensor  # (N, 8) int32
    tris: torch.Tensor   # (T, 12) int32
    cut: torch.Tensor    # (C,) int32 subtree roots, C <= CUT_PARTS
    path: str            # a key of PATHS


def table_path(n_nodes: int, n_tris: int) -> str:
    """Where the kernels keep tables of this size during a launch."""
    if n_nodes * 4 * NODE_WORDS + n_tris * 4 * TRI_WORDS <= TABLE_ROOM:
        return "shared"
    return "global"


def subtree_cut(first, miss) -> list[int]:
    """Roots of at most CUT_PARTS subtrees whose node ranges [r, miss[r])
    hold every leaf once, in DFS order: the whole tree, split at its
    largest inner subtree (into the children r + 1 and miss[r + 1]) until
    there are CUT_PARTS or only leaves. The inner nodes left out need no
    test: a child's box lies inside its parent's."""
    first, miss = list(first), list(miss)
    roots = [0] if first else []
    while len(roots) < CUT_PARTS:
        inner = [r for r in roots if first[r] < 0]
        if not inner:
            break
        r = max(inner, key=lambda n: miss[n] - n)
        roots.remove(r)
        roots += [r + 1, miss[r + 1]]
    return sorted(roots)


def pack(tree: BVH, tris: Tris) -> Packed:
    """The packed records of a tree and its triangle slots, checked once
    here so that a launch need not."""
    dev = tree.first.device
    n, t = tree.first.shape[0], tris.v0.shape[0]
    for name, x, dt, shape in (
        ("bbox_min", tree.bbox_min, torch.float32, (n, 3)),
        ("bbox_max", tree.bbox_max, torch.float32, (n, 3)),
        ("first", tree.first, torch.int32, (n,)),
        ("count", tree.count, torch.int32, (n,)),
        ("miss", tree.miss, torch.int32, (n,)),
        ("tri_order", tree.tri_order, torch.int32, (t,)),
        ("v0", tris.v0, torch.float32, (t, 3)),
        ("e1", tris.e1, torch.float32, (t, 3)),
        ("e2", tris.e2, torch.float32, (t, 3)),
        ("vis", tris.vis, torch.int32, (t,)),
        ("opaque", tris.opaque, torch.bool, (t,)),
    ):
        _check(name, x, dt, shape, dev)
    leaf = tree.first >= 0
    if bool((leaf & ((tree.count < 0) | (tree.count > LEAF_SIZE))).any()):
        raise ValueError(f"a leaf holds more than {LEAF_SIZE} triangles")
    i32 = torch.int32
    code = torch.where(leaf, (tree.first << 3) | tree.count, -1)
    nodes = torch.cat([tree.bbox_min.view(i32), code[:, None],
                       tree.bbox_max.view(i32), tree.miss[:, None]], 1)
    slots = torch.cat([tris.v0.view(i32), tree.tri_order[:, None],
                       tris.e1.view(i32), tris.vis[:, None],
                       tris.e2.view(i32), tris.opaque.to(i32)[:, None]], 1)
    for x in (nodes, slots):
        if x.data_ptr() % 16:
            raise ValueError("packed tables must be 16-byte aligned")
    cut = torch.tensor(subtree_cut(tree.first.tolist(), tree.miss.tolist()),
                       dtype=i32, device=dev)
    return Packed(nodes=nodes, tris=slots, cut=cut, path=table_path(n, t))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "ray-query kernels cannot be built")
    return found


def build() -> str:
    """Compile the kernels if the library for these sources is missing;
    returns the library's path."""
    digest = hashlib.sha256()
    for path in SOURCES + HEADERS:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"librls_cuda_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCES}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            args = [p, p, p, i, i, i, i, p, p, p, p, i, i, f, p, p]
            lib.rls_nearest.argtypes = args
            lib.rls_nearest.restype = i
            lib.rls_occluded.argtypes = args
            lib.rls_occluded.restype = i
            _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(name: str, packed: Packed, o, d, t_max, exclude_tri, vis_mask,
            t_eps, out: torch.Tensor) -> None:
    dev = packed.nodes.device
    if dev.type != "cuda":
        raise ValueError(
            f"the CUDA ray queries need CUDA tensors, got {dev}")
    r = o.shape[0]
    for arg, x, dt, shape in (
        ("o", o, torch.float32, (r, 3)),
        ("d", d, torch.float32, (r, 3)),
        ("t_max", t_max, torch.float32, (r,)),
        ("exclude_tri", exclude_tri, torch.int32, (r,)),
    ):
        _check(arg, x, dt, shape, dev)
    lib = _lib or _load()
    err = getattr(lib, name)(
        packed.nodes.data_ptr(), packed.tris.data_ptr(), packed.cut.data_ptr(),
        packed.nodes.shape[0], packed.tris.shape[0], packed.cut.shape[0],
        PATHS[packed.path],
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), exclude_tri.data_ptr(),
        r, int(vis_mask), t_eps, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} (path "
                           f"{packed.path})")
    LAUNCHES[name] += 1
    PATH_LAUNCHES[packed.path] += 1


def nearest(packed: Packed, o: torch.Tensor, d: torch.Tensor,
            t_max: torch.Tensor, exclude_tri: torch.Tensor, vis_mask: int,
            t_eps: float = 1e-4) -> Hit:
    """Closest hit on the GPU; the semantics of accel.bvh.intersect. The
    four outputs are rows of one (4, R) tensor."""
    out = torch.empty((4, o.shape[0]), dtype=torch.float32, device=o.device)
    _launch("rls_nearest", packed, o, d, t_max, exclude_tri, vis_mask, t_eps,
            out)
    return Hit(t=out[0], tri=out[1].view(torch.int32), u=out[2], v=out[3])


def occluded(packed: Packed, o: torch.Tensor, d: torch.Tensor,
             t_max: torch.Tensor, exclude_tri: torch.Tensor, vis_mask: int,
             t_eps: float = 1e-4) -> torch.Tensor:
    """Any-hit shadow test on the GPU; the semantics of accel.bvh.occluded."""
    blocked = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    _launch("rls_occluded", packed, o, d, t_max, exclude_tri, vis_mask, t_eps,
            blocked)
    return blocked
