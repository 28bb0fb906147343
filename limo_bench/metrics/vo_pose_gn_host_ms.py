"""Host ms per frame of the port's span `vo.pose_gn`: the first pose
Gauss-Newton of `odometry_step`, from the last accepted motion (its
launches; the step waits for it in `vo.branch_sync`).  The median over
the window's frames, from the port's own record."""

from ..program_spans import host_ms

NAME = "vo.pose_gn.host_ms"
UNIT = "ms"
LAYER = "odometry"
MOVES = "frames_per_s"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("vo.pose_gn")
