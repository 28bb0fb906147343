"""Host ms per frame of the port's span `vo.ba`: the window's observations,
the landmarks' initialisation and `vo/ba.run_ba`.  The median over the
window's frames, from the port's own record."""

from ..program_spans import host_ms

NAME = "vo.ba.host_ms"
UNIT = "ms"
LAYER = "odometry"
MOVES = "frames_per_s"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("vo.ba")
