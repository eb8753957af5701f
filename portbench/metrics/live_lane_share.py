"""Per cent of the generation tree's lanes that hit a surface: 100 x the
program's counter `live_lanes` over `lanes`, counted in `_gen_shade_t`
over every generation of one frame rendered after the window
(`portbench/stages.py`). The rest are shaded densely, misses to the dome
included."""
from portbench import stages

LAYER = "generation tree"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "frame_s"


def read(ctx):
    cap = stages.capture(ctx)
    if cap is None or not cap["lanes"]:
        return None
    return 100.0 * cap["live_lanes"] / cap["lanes"]
