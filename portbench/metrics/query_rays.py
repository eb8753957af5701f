"""Rays handed to the two ray queries a frame (`TileRenderer.stats`:
nearest_rays + shadow_rays, dead lanes included), over the window's
frames: a count that repeats exactly for a seed."""
LAYER = "ray queries"
UNIT = "rays/frame"
SOURCE = "program_counter"
MOVES = "frame_s"


def read(ctx):
    rows = ctx.res["stats"]
    return sum(r["nearest_rays"] + r["shadow_rays"] for r in rows) / len(rows)
