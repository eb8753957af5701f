"""The control's arithmetic: every float32 result rounded to bfloat16.

`Bfloat16Results` is a torch function mode. Inside it, each torch function,
method or operator that returns a float32 tensor returns it rounded to
bfloat16 (and held in float32 again), so a chain of operations keeps about
8 bits of mantissa after every step, as arithmetic in bfloat16 would.
Integer and boolean results are left as they are. It serves the control of
the output check: the reference, computed so, in the program's place.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_round(v) for v in x)
    if isinstance(x, list):
        return [_round(v) for v in x]
    return x


class Bfloat16Results(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.Tensor.to, torch.Tensor.__setitem__):
            return out
        if getattr(func, "__name__", "").endswith("_"):
            # in-place: round the tensor written, keep its identity
            if (isinstance(out, torch.Tensor)
                    and out.dtype == torch.float32):
                with torch.no_grad():
                    out.copy_(out.to(torch.bfloat16).to(torch.float32))
            return out
        with torch._C.DisableTorchFunction():
            return _round(out)
