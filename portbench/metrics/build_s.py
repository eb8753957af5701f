"""Seconds of the scene build in set-up: `scene/build.py::build` and
`accel/trace.py::build` (the native BVH, the packed tables) on the card,
host clock, ending in a synchronize."""
LAYER = "scene build"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(ctx):
    return ctx.res["build_s"]
