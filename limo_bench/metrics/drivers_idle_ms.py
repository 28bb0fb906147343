"""Device-idle ms per profiled frame while the host is outside the port's
span `assoc.frame`: the stream's upload, read-back and loop."""

from ..program_spans import idle_ms

NAME = "drivers.idle_ms"
UNIT = "ms"
LAYER = "drivers"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return idle_ms(r, inside=False)
