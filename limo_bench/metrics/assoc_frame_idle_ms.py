"""Device-idle ms per profiled frame while the host is inside the port's
span `assoc.frame`: the association's own launch gaps."""

from ..program_spans import idle_ms

NAME = "assoc.frame.idle_ms"
UNIT = "ms"
LAYER = "device"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return idle_ms(r, inside=True)
