"""Device ms a frame of the kernels (copies and fills too) whose innermost
program span at their launch is `rng`: the RNG's device draws (Owen-
Sobol, threefry; `core/rng.py`). From the program's spans over frames
rendered after the window (`portbench/stages.py`)."""
from portbench import stages

LAYER = "generation tree"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "frame_s"


def read(ctx):
    return stages.device_ms(ctx, "rng")
