"""CUDA kernels of the lobes: bind and launch.

`eval_diffuse`, `sample_diffuse`, `eval_specular`, `sample_specular` and
`sample_refract` launch `rls_bsdf_<entry>` from `csrc/bsdf.cu`, whose
arithmetic is `csrc/bsdf.cuh`: one launch an entry-point call of
models/dispatch.py on a CUDA device, one thread a lane, which evaluates
only its own material's model in registers. The eager torch code of
models/dispatch.py is their plain version. They replace no TPU kernel (the
JAX package leaves its lobes to XLA).

A launch reads the lanes' inputs through a table of (pointer, stride)
pairs in bsdf.cuh's `Field` order (`FIELDS`): the directions or random
numbers, and the parts of the gathered material (`MatG`) the entry point
reads; a part the table lacks (`ggx2`, `dsy` None) is a null pointer, and
a 0-dim field is read with stride 0. Floats must be float32, the masks
bool and the integer fields int32, as `dispatch.gather` makes them. The
outputs are rows of one float32 tensor, returned as views.

The kernels are in the library of the ray-query kernels (ops/intersect.py
builds it), bound here with ctypes. They run on the current torch stream
and do not synchronise; an empty call makes no launch; a launch whose CUDA
error is not 0 raises. `LAUNCHES` counts launches per kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..core.vec3 import V3
from . import intersect

# bsdf.cuh's Field order: (MatG part or lane input, fields, dtype)
_F32, _I32, _B = torch.float32, torch.int32, torch.bool
GROUPS = (
    ("wo", 3, _F32), ("wi", 3, _F32), ("u", 2, _F32),
    ("mtype", 1, _I32), ("spec_fresnel_mode", 1, _I32), ("spec_dist", 1, _I32),
    ("has_diffuse", 1, _B), ("has_spec", 1, _B), ("has_refract", 1, _B),
    ("diffuse_color", 3, _F32), ("diffuse_roughness", 1, _F32),
    ("spec_weight", 3, _F32), ("spec_ksn", 1, _F32),
    ("ggx", 5, _F32), ("ggx2", 5, _F32),
    ("spec2_weight", 3, _F32), ("sheen_layer", 1, _F32),
    ("dsy", 17, _F32),
    ("kt_color", 3, _F32),
)
FIELDS = sum(n for _, n, _ in GROUPS)  # bsdf.cuh's kFields

# the parts each entry point reads, and its output rows
READS = {
    "eval_diffuse": ("wo", "wi", "mtype", "has_diffuse", "diffuse_color",
                     "diffuse_roughness", "dsy"),
    "sample_diffuse": ("u",),
    "eval_specular": ("wo", "wi", "mtype", "spec_fresnel_mode", "spec_dist",
                      "has_spec", "spec_weight", "spec_ksn", "ggx", "ggx2",
                      "spec2_weight", "sheen_layer", "dsy"),
    "sample_specular": ("wo", "u", "mtype", "spec_dist", "ggx", "ggx2",
                        "spec2_weight", "dsy"),
    "sample_refract": ("wo", "u", "has_refract", "ggx", "kt_color"),
}
ROWS = {"eval_diffuse": 4, "sample_diffuse": 3, "eval_specular": 4,
        "sample_specular": 3, "sample_refract": 6}

LAUNCHES = {f"rls_bsdf_{e}": 0 for e in READS}

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(intersect.build())
            p = ctypes.c_void_p
            for name in LAUNCHES:
                fn = getattr(lib, name)
                fn.argtypes = [p, ctypes.c_int64, p, p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _flat(x) -> tuple:
    """A V3, a NamedTuple of tensors and V3s, or a tensor, as its tensors."""
    if isinstance(x, torch.Tensor):
        return (x,)
    return tuple(t for a in x for t in _flat(a))


def table(entry: str, m, wo: V3 | None, wi: V3 | None, rx, ry, n: int,
          device: torch.device):
    """The ctypes table of (pointer, stride) pairs of `entry`'s inputs,
    checked."""
    lanes = {"wo": wo, "wi": wi, "u": (rx, ry)}
    vals = []
    for name, size, dtype in GROUPS:
        part = None
        if name in READS[entry]:
            part = lanes[name] if name in lanes else getattr(m, name)
        if part is None:
            vals += [0, 0] * size
            continue
        parts = _flat(part)
        if len(parts) != size:
            raise ValueError(f"{name} has {len(parts)} fields, expected "
                             f"{size}")
        for x in parts:
            if x.device != device:
                raise ValueError(f"{name} is on {x.device}, expected "
                                 f"{device}")
            if x.dtype != dtype:
                raise TypeError(f"{name} has dtype {x.dtype}, expected "
                                f"{dtype}")
            if x.dim() == 0:
                stride = 0
            elif x.shape == (n,):
                stride = x.stride(0)
            else:
                raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                                 f"expected () or ({n},)")
            vals += [x.data_ptr(), stride]
    return (ctypes.c_int64 * (2 * FIELDS))(*vals)


def run(lib, entry: str, m, wo: V3 | None = None, wi: V3 | None = None,
        rx=None, ry=None, stream: int | None = None) -> torch.Tensor:
    """`entry`'s output rows, (ROWS[entry], n) float32, from `lib`'s
    rls_bsdf_<entry> (the kernels with the CUDA stream, or the host loops
    of bsdf_host.cpp without one); n is the lanes of wo (of rx for
    sample_diffuse)."""
    lead = rx if wo is None else wo.x
    device, n = lead.device, lead.shape[0]
    out = torch.empty((ROWS[entry], n), dtype=torch.float32, device=device)
    if n == 0:
        return out
    args = table(entry, m, wo, wi, rx, ry, n, device)
    name = f"rls_bsdf_{entry}"
    tail = () if stream is None else (stream,)
    err = getattr(lib, name)(args, n, out.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def _launch(entry: str, m, wo=None, wi=None, rx=None, ry=None):
    lead = rx if wo is None else wo.x
    if lead.device.type != "cuda":
        raise ValueError(f"the CUDA lobes need CUDA tensors, got "
                         f"{lead.device}")
    out = run(_lib or _load(), entry, m, wo, wi, rx, ry,
              torch._C._cuda_getCurrentRawStream(lead.device.index))
    if out.shape[1]:
        LAUNCHES[f"rls_bsdf_{entry}"] += 1
    return out


def eval_diffuse(m, wo: V3, wi: V3):
    """(f*cos V3, pdf) of dispatch.eval_diffuse."""
    out = _launch("eval_diffuse", m, wo, wi)
    return V3(out[0], out[1], out[2]), out[3]


def sample_diffuse(rx: torch.Tensor, ry: torch.Tensor) -> V3:
    """wi of dispatch.sample_diffuse."""
    out = _launch("sample_diffuse", None, rx=rx, ry=ry)
    return V3(out[0], out[1], out[2])


def eval_specular(m, wo: V3, wi: V3):
    """(f*cos V3, pdf) of dispatch.eval_specular."""
    out = _launch("eval_specular", m, wo, wi)
    return V3(out[0], out[1], out[2]), out[3]


def sample_specular(m, wo: V3, rx: torch.Tensor, ry: torch.Tensor) -> V3:
    """wi of dispatch.sample_specular."""
    out = _launch("sample_specular", m, wo, rx=rx, ry=ry)
    return V3(out[0], out[1], out[2])


def sample_refract(m, wo: V3, rx: torch.Tensor, ry: torch.Tensor):
    """(wi V3, weight V3) of dispatch.sample_refract."""
    out = _launch("sample_refract", m, wo, rx=rx, ry=ry)
    return V3(out[0], out[1], out[2]), V3(out[3], out[4], out[5])
