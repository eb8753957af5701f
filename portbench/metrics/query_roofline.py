"""The ray-query kernels' share of their roofline: the bound of a frame's
queries (`portbench/roofline.py`) over the two kernels' device ms a frame
in the traced window. The card's power limit is printed beside it."""
import sys

from portbench import roofline

LAYER = "ray queries"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_s"


def read(ctx):
    ks = ctx.res.get("kernels")
    q = ctx.res.get("queries")
    if not ks or not q:
        return None
    ms = sum(m for name, (m, _) in ks.items()
             if roofline.is_query(name)) / ctx.res["frames"]
    if ms <= 0.0:
        return None
    bound = sum(roofline.bound_ms(k, q[k]) for k in roofline.OUT_BYTES)
    print(f"query_roofline: bound {bound!r} ms over {ms!r} ms a frame on "
          f"{ctx.card}", file=sys.stderr)
    return 100.0 * bound / ms
