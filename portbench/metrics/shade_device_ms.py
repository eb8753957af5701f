"""Device milliseconds a frame of every kernel but the two ray queries
(`rls_nearest`, `rls_occluded`, launching `nearest_kernel` and
`occluded_kernel`): the generation tree's eager kernels, the SSS stage's
and the splat's, from the traced window's raw events."""
from portbench.roofline import is_query

LAYER = "generation tree"
UNIT = "ms/frame"
SOURCE = "device_trace"
MOVES = "frame_s"
NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    ks = ctx.res.get("kernels")
    if not ks:
        return None
    ms = sum(m for name, (m, _) in ks.items()
             if not is_query(name) and not name.startswith(NOT_KERNELS))
    return ms / ctx.res["frames"]
