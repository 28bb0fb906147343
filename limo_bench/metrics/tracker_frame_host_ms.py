"""Host ms per frame of the port's span `tracker.frame`:
`tracker/frontend.track_frame` whole (the root: pyramid, LK passes and
gate, detection, lane allocation).  The median over the window's frames,
from the port's own record (`obs/timing.frame_spans`)."""

from ..program_spans import host_ms

NAME = "tracker.frame.host_ms"
UNIT = "ms"
LAYER = "tracker"
MOVES = "frames_per_s"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("tracker.frame")
