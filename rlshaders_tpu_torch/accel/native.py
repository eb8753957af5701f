"""The native binned-SAH BVH builder: `csrc/accel.cpp`, compiled by g++ at
first use and bound with ctypes.

Counterpart of rlshaders_tpu/accel/native.py, and the builder of every
port BVH (accel/trace.py::build). The JAX package uses this builder
wherever g++ exists, and the flags are its module's exactly, so the
port's trees equal the JAX package's, all six arrays.

`accel.bvh.build_arrays` is its plain version, and equals it node for
node when both round alike: compiled with `EXACT_FLAGS` (no fused
multiply-adds), the two give the same five node arrays and every leaf
the same set of triangles; the order inside a leaf differs, because the
C++ split is `std::partition`, which is not stable. With `CXX_FLAGS` on a
CPU that has FMA, g++ fuses the SAH cost `la * nl + ra * nr` (GCC's
default `-ffp-contract=fast`), which moves a split where two costs nearly
tie, as on a finely tessellated sphere.

`-march=native` ties a library to the host's CPU, so its file in
`rlshaders_tpu_torch/build/` is named by a digest of the source, the
flags and the compiler's reading of `-march=native` here. It is written to
a file of this process and renamed into place, so that processes building
at once do not race.

There is no fallback: a missing compiler, a failed compile or a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .bvh import LEAF_SIZE, N_BINS

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "accel.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
EXACT_FLAGS = CXX_FLAGS + ("-ffp-contract=off",)

_libs: dict = {}   # flags -> the loaded library
_lock = threading.Lock()


def _compiler() -> str:
    path = shutil.which(CXX)
    if path is None:
        raise RuntimeError(f"{CXX} not found on PATH: the native code "
                           f"cannot be built")
    return path


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc


def build(flags: tuple = CXX_FLAGS, source: str | None = None,
          stem: str = "librls_accel", headers: tuple = ()) -> str:
    """Compile `source` (SOURCE, the builder, unless another is named) if
    the library for this source, the `headers` it includes, these flags
    and this host is missing; returns the library's path, `stem` and a
    digest of them."""
    cxx = _compiler()
    source = source or SOURCE
    key = hashlib.sha256()
    for path in (source, *headers):
        with open(path, "rb") as f:
            key.update(f.read())
    key.update(" ".join(flags).encode())
    # the compiler's version and the flags -march=native expands to here
    key.update(_run([cxx, "-march=native", "-E", "-v", "-x", "c++",
                     os.devnull]).stderr.encode())
    lib = os.path.join(BUILD_DIR, f"{stem}_{key.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    _run([cxx, *flags, "-o", tmp, source])
    os.replace(tmp, lib)
    return lib


def _load(flags: tuple):
    with _lock:
        if flags not in _libs:
            lib = ctypes.CDLL(build(flags))
            fp, ip, i = (ctypes.POINTER(ctypes.c_float),
                         ctypes.POINTER(ctypes.c_int), ctypes.c_int)
            lib.rls_build_bvh.restype = i
            lib.rls_build_bvh.argtypes = [fp, fp, fp, i, i, i, fp, fp, ip,
                                          ip, ip, ip, i]
            _libs[flags] = lib
    return _libs[flags]


def build_arrays(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                 flags: tuple = CXX_FLAGS):
    """Binned-SAH build over triangles (v0, v0+e1, v0+e2); returns the
    numpy arrays (bbox_min, bbox_max, first, count, miss, order), as
    `accel.bvh.build_arrays` does. `flags` picks the library; every tree
    of the port uses CXX_FLAGS, and EXACT_FLAGS serves the checks that
    hold the plain builder to this one."""
    v0, e1, e2 = (np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    t = v0.shape[0]
    for name, a in (("v0", v0), ("e1", e1), ("e2", e2)):
        if a.shape != (t, 3):
            raise ValueError(f"{name} has shape {a.shape}, expected {(t, 3)}")
    lib = _libs.get(flags) or _load(flags)
    max_nodes = 2 * t + 2
    bbox_min = np.empty((max_nodes, 3), np.float32)
    bbox_max = np.empty((max_nodes, 3), np.float32)
    first, count, miss = (np.empty(max_nodes, np.int32) for _ in range(3))
    order = np.empty(t, np.int32)
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    n_nodes = lib.rls_build_bvh(
        v0.ctypes.data_as(fp), e1.ctypes.data_as(fp), e2.ctypes.data_as(fp),
        t, LEAF_SIZE, N_BINS,
        bbox_min.ctypes.data_as(fp), bbox_max.ctypes.data_as(fp),
        first.ctypes.data_as(ip), count.ctypes.data_as(ip),
        miss.ctypes.data_as(ip), order.ctypes.data_as(ip), max_nodes)
    if n_nodes <= 0:
        raise RuntimeError(f"the native BVH builder returned {n_nodes} "
                           f"nodes for {t} triangles")
    return (bbox_min[:n_nodes], bbox_max[:n_nodes], first[:n_nodes],
            count[:n_nodes], miss[:n_nodes], order)
