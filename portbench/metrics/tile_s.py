"""Seconds a tile of the window: `TileRenderer(profile=True)`'s "tile"
stage, host clock between two synchronizations, over its calls."""
LAYER = "frame driver"
UNIT = "s"
SOURCE = "program_span"
MOVES = "frame_s"


def read(ctx):
    st = ctx.res.get("stages") or {}
    if not st.get("n_tile"):
        return None
    return st["t_tile"] / st["n_tile"]
