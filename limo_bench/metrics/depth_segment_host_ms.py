"""Host ms per frame of the port's span `depth.segment`: the depth
cascade's primary path (`_depth_cascade`: the histogram, the max-
spanning triangle, the planarity check and their code selects). The
median over the window's frames, from the port's own record
(`obs/timing.frame_spans`)."""

from ..program_spans import host_ms

NAME = "depth.segment.host_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frame_ms_p95"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("depth.segment")
