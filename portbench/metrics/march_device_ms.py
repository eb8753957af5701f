"""Device ms a frame of the kernels (copies and fills too) whose innermost
program span at their launch is `march`: the shadow march through
non-opaque surfaces (`wavefront._shadow_transmission` in a scene with
one), its hits' transmission, steps and origins (its nearest queries are
`query`'s). From the program's spans over frames rendered after the
window (`portbench/stages.py`); nothing where the program has no such
span."""
from portbench import stages

LAYER = "generation tree"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "frame_s"


def read(ctx):
    cap = stages.capture(ctx)
    if cap is None or not cap.get("device_ms"):
        return None
    return cap["device_ms"].get("march")
