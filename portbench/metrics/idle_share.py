"""Per cent of the traced window in which the card ran nothing:
1 - (the union of the intervals of its activity, from the profiler's raw
events) / (the window's wall time), averaged over the cards."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_s"


def read(ctx):
    res = ctx.res
    if "busy_s" not in res:
        return None
    rows = res.get("rank_rows") or [res]
    busy = sum(r["busy_s"] for r in rows) / len(rows)
    return 100.0 * (1.0 - busy / res["trace_window_s"])
