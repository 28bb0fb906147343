"""Host ms per frame of the port's span `assoc.ground_plane`: the
frame's ground plane in `process_frame` (`_frame_ground_plane`: the
semantic plane, or RANSAC). The median over the window's frames, from
the port's own record (`obs/timing.frame_spans`)."""

from ..program_spans import host_ms

NAME = "assoc.ground_plane.host_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frame_ms_p95"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("assoc.ground_plane")
