"""GiB the allocator held at most during the window
(`torch.cuda.max_memory_allocated()` after `reset_peak_memory_stats()`
at its start), on the fullest card."""
LAYER = "device"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "frame_s"


def read(ctx):
    rows = ctx.res.get("rank_rows") or [ctx.res]
    peak = max(r["mem_window"] for r in rows)
    return peak / 2 ** 30 if peak else None
