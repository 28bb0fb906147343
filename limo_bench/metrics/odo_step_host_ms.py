"""Host ms per frame of the port's span `odo.step`:
`vo/pipeline.odometry_step` whole (the root: the depth association, pose
Gauss-Newton, the step's host sync and the window BA).  The median over
the window's frames, from the port's own record
(`obs/timing.frame_spans`)."""

from ..program_spans import host_ms

NAME = "odo.step.host_ms"
UNIT = "ms"
LAYER = "odometry"
MOVES = "frames_per_s"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("odo.step")
