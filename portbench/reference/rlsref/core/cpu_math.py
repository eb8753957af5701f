"""One set-up of the CPU build's vector math, once per process.

torch's float unary functions on CPU tensors (sqrt, exp, log, sin, ...)
go through the build's vector math library and are split over OpenMP
threads above 2,048 elements. When the first such call of a process is
split over threads, one thread's share has come back with about 12 correct
bits (torch.sqrt of ones read 1 - 2**-12 on 8,192 of 65,536 lanes, a few
times in a hundred fresh processes under load). One call on a single
element first sets the library up on one thread; after it no such call has
come back wrong. The port's CPU entry points call `settle` before any
arithmetic, so every CPU render and every CPU parity test meets it.
"""
from __future__ import annotations

import torch

# the functions the shading code calls on float tensors
_UNARY = (torch.sqrt, torch.rsqrt, torch.exp, torch.log, torch.log2,
          torch.sin, torch.cos, torch.tan, torch.acos)
_BINARY = (torch.atan2, torch.pow)
_settled = False


def settle() -> None:
    """Call each function once on one element, then once on 65,536 (every
    worker thread); later calls do nothing."""
    global _settled
    if _settled:
        return
    for n in (1, 1 << 16):
        x = torch.full((n,), 0.5)
        for fn in _UNARY:
            fn(x)
        for fn in _BINARY:
            fn(x, x)
    _settled = True
