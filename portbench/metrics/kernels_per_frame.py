"""CUDA kernels of the generation tree a frame: every kernel of the traced
window (the profiler's raw events, card activity only) but the two ray
queries and the window's marker, copies and fills left out, over the
window's frames."""
from portbench import roofline

LAYER = "generation tree"
UNIT = "kernels/frame"
SOURCE = "device_trace"
MOVES = "frame_s"
NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    ks = ctx.res.get("kernels")
    if not ks:
        return None
    n = sum(c for name, (_, c) in ks.items()
            if not name.startswith(NOT_KERNELS)
            and not roofline.is_query(name))
    return n / ctx.res["frames"]
