"""CUDA ray-query kernels: build, bind and launch.

`nearest` and `occluded` launch `rls_nearest` / `rls_occluded` from
`csrc/intersect.cu`, the counterparts of the TPU kernels `_nearest_kernel`
and `_occluded_kernel` of rlshaders_tpu/ops/intersect_pallas.py. Their plain
versions are `accel.bvh.intersect` / `accel.bvh.occluded`.

The source is compiled by nvcc into a shared library with a plain C
interface at first use, into `rlshaders_tpu_torch/build/` (named by a hash
of the source, so an edited source is rebuilt), and bound with ctypes. A
failed build raises, and so does a launch whose cudaGetLastError is not 0.
Kernels run on the current torch stream and do not synchronise.

`LAUNCHES` counts launches per kernel; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..accel.bvh import BVH, Hit, Tris

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "intersect.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"rls_nearest": 0, "rls_occluded": 0}

_lib = None
_lock = threading.Lock()


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
    """Compile the kernels if the library for this source is missing;
    returns the library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR,
                       f"librls_intersect_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            tree = [p] * 11 + [i]
            lib.rls_nearest.argtypes = tree + [p, p, p, p, i, i, f,
                                               p, p, p, p, p]
            lib.rls_nearest.restype = i
            lib.rls_occluded.argtypes = tree + [p, p, p, p, i, i, f, p, p]
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


def _args(tree: BVH, tris: Tris, o, d, t_max, exclude_tri):
    if o.device.type != "cuda":
        raise ValueError(
            f"the CUDA ray queries need CUDA tensors, got {o.device}")
    dev = o.device
    r = o.shape[0]
    n = tree.first.shape[0]
    t = tris.v0.shape[0]
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
        ("o", o, torch.float32, (r, 3)),
        ("d", d, torch.float32, (r, 3)),
        ("t_max", t_max, torch.float32, (r,)),
        ("exclude_tri", exclude_tri, torch.int32, (r,)),
    ):
        _check(name, x, dt, shape, dev)
    ptrs = [x.data_ptr() for x in (
        tree.bbox_min, tree.bbox_max, tree.first, tree.count, tree.miss,
        tree.tri_order, tris.v0, tris.e1, tris.e2, tris.vis, tris.opaque)]
    return ptrs + [n], [o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
                        exclude_tri.data_ptr(), r]


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def nearest(tree: BVH, tris: Tris, o: torch.Tensor, d: torch.Tensor,
            t_max: torch.Tensor, exclude_tri: torch.Tensor, vis_mask: int,
            t_eps: float = 1e-4) -> Hit:
    """Closest hit on the GPU; the semantics of accel.bvh.intersect."""
    lib = _load()
    tree_args, ray_args = _args(tree, tris, o, d, t_max, exclude_tri)
    r = o.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=o.device)
    tri = torch.empty(r, dtype=torch.int32, device=o.device)
    u = torch.empty(r, dtype=torch.float32, device=o.device)
    v = torch.empty(r, dtype=torch.float32, device=o.device)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    err = lib.rls_nearest(*tree_args, *ray_args, int(vis_mask), t_eps,
                          t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                          v.data_ptr(), stream)
    _raise_on("rls_nearest", err)
    LAUNCHES["rls_nearest"] += 1
    return Hit(t=t, tri=tri, u=u, v=v)


def occluded(tree: BVH, tris: Tris, o: torch.Tensor, d: torch.Tensor,
             t_max: torch.Tensor, exclude_tri: torch.Tensor, vis_mask: int,
             t_eps: float = 1e-4) -> torch.Tensor:
    """Any-hit shadow test on the GPU; the semantics of accel.bvh.occluded."""
    lib = _load()
    tree_args, ray_args = _args(tree, tris, o, d, t_max, exclude_tri)
    blocked = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    err = lib.rls_occluded(*tree_args, *ray_args, int(vis_mask), t_eps,
                           blocked.data_ptr(), stream)
    _raise_on("rls_occluded", err)
    LAUNCHES["rls_occluded"] += 1
    return blocked
