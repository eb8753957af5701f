"""CUDA kernels of the random draws: bind and launch.

`threefry`, `sobol_stream` and `sobol_at` launch `rls_rng_threefry`,
`rls_rng_sobol_stream` and `rls_rng_sobol_at` from `csrc/rng.cu`, whose
arithmetic is `csrc/rng.cuh`. core/rng.py calls them for every draw on a
CUDA device; its int64 tensor code is their plain version, and every
element equals it bit for bit. They replace no TPU kernel (the JAX package
leaves its draws to XLA).

The kernels are in the library of the ray-query kernels (ops/intersect.py
builds it), bound here with ctypes. They run on the current torch stream
and do not synchronise; an empty draw makes no launch; a launch whose CUDA
error is not 0 raises. `LAUNCHES` counts launches per kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import intersect

# rng.cuh's Mode: int64 words, uniform floats, stratified2's batch-major
# and stratified2_flat's sample-major layouts
BITS, UNIFORM, STRAT_BATCH, STRAT_FLAT = 0, 1, 2, 3

LAUNCHES = {"rls_rng_threefry": 0, "rls_rng_sobol_stream": 0,
            "rls_rng_sobol_at": 0}

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(intersect.build())
            p, i, u32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                              ctypes.c_int64)
            lib.rls_rng_threefry.argtypes = [u32, u32, i64, i, i, i64, p, p]
            lib.rls_rng_sobol_stream.argtypes = [p, i, p, i, i64, i, i, u32,
                                                 p, p]
            lib.rls_rng_sobol_at.argtypes = [p, i, p, i, p, i64, i, u32, i,
                                             p, p]
            for name in LAUNCHES:
                getattr(lib, name).restype = i
            _lib = lib
    return _lib


def _launch(name: str, out: torch.Tensor, *args) -> torch.Tensor:
    if out.numel() == 0:
        return out
    lib = _lib or _load()
    err = getattr(lib, name)(
        *args, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(out.device.index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def _lanes(name: str, x: torch.Tensor, device: torch.device):
    """A lane tensor as the kernels read it: one dimension, int32 or int64,
    contiguous, on `device`; returns (tensor, is64)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dim() != 1:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected one "
                         f"dimension")
    if x.dtype not in (torch.int32, torch.int64):
        x = x.to(torch.int64)
    return x.contiguous(), int(x.dtype == torch.int64)


def threefry(k0: int, k1: int, n: int, mode: int, device, s: int = 1,
             lanes: int = 1) -> torch.Tensor:
    """n elements of a threefry draw under the key words (k0, k1): uint32
    words in int64 (BITS) or float32 values (UNIFORM, STRAT_BATCH with s
    strata a side, STRAT_FLAT with s and `lanes`)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA draws need a CUDA device, got {device}")
    out = torch.empty(n, dtype=torch.int64 if mode == BITS else torch.float32,
                      device=device)
    return _launch("rls_rng_threefry", out, k0, k1, n, mode, s, lanes)


def sobol_stream(pix: torch.Tensor, aa: torch.Tensor, s: int,
                 lane_major: bool, key: int) -> torch.Tensor:
    """(N*s, 2) Owen-Sobol rows: sobol2_rep's lane-major layout or
    sobol2_flat's column-major one; key = lowbias32(purpose) ^ salt."""
    device = pix.device
    pix, pix64 = _lanes("pix", pix, device)
    aa, aa64 = _lanes("aa", aa, device)
    n = pix.shape[0]
    if aa.shape != (n,):
        raise ValueError(f"aa has shape {tuple(aa.shape)}, expected ({n},)")
    out = torch.empty((n * s, 2), dtype=torch.float32, device=device)
    return _launch("rls_rng_sobol_stream", out, pix.data_ptr(), pix64,
                   aa.data_ptr(), aa64, n, s, int(lane_major), key)


def sobol_at(pix: torch.Tensor, idx: torch.Tensor, key: int,
             purposes: torch.Tensor | None = None,
             seeded: bool = False) -> torch.Tensor:
    """(N*K, 2) Owen-Sobol rows, row i*K + j lane i's sample at index
    idx[i] in the stream of pixel pix[i] and purpose purposes[j] (key =
    salt), or with no purposes (K = 1) of key = lowbias32(purpose) ^ salt;
    `seeded`: pix holds the scramble seeds (core/rng.py's sobol2)."""
    device = pix.device
    pix, pix64 = _lanes("pix", pix, device)
    idx, idx64 = _lanes("idx", idx, device)
    n = pix.shape[0]
    if idx.shape != (n,):
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected ({n},)")
    k, pptr = 1, None
    if purposes is not None:
        purposes = _lanes("purposes", purposes.to(torch.int64), device)[0]
        k, pptr = purposes.shape[0], purposes.data_ptr()
    out = torch.empty((n * k, 2), dtype=torch.float32, device=device)
    return _launch("rls_rng_sobol_at", out, pix.data_ptr(), pix64,
                   idx.data_ptr(), idx64, pptr, n, k, key, int(seeded))
