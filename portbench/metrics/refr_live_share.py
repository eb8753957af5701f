"""Per cent of the refraction chain's lanes that still carry weight: 100 x
the program's counter `refr_live_lanes` over `refr_lanes`, counted in
`wavefront._refr_t` over every refraction spawn of one frame rendered
after the window (`portbench/counters.py`). A lane is dead where its
origin missed, its surface does not refract, or roulette killed it."""
from portbench import counters

LAYER = "generation tree"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "frame_s"


def read(ctx):
    counts = counters.capture(ctx)
    if not counts or not counts.get("refr_lanes"):
        return None
    return 100.0 * counts["refr_live_lanes"] / counts["refr_lanes"]
