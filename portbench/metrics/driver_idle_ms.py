"""Idle ms a frame of the card's gaps that a launch in a program span
outside every `tile` and `sss` span ended: `render`'s own time (the
frame's set-up and its synchronizations, the work between tiles),
`camera` and `splat`, and the key folds between tiles. Gaps ended by the
harness's own launches, or by a launch made before the gap began
(`queued`), are left out. From the program's spans over frames rendered
after the window (`portbench/stages.py`)."""
from portbench import stages

LAYER = "frame driver"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "frame_s"


def read(ctx):
    cap = stages.capture(ctx)
    if cap is None or cap.get("device_ms") is None:
        return None
    return cap["driver_idle_ms"]
