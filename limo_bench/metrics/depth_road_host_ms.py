"""Host ms per frame of the port's span `depth.road`: the depth
cascade's road pass (`_depth_cascade`: `_road_pass`, the M-estimator
planes). The median over the window's frames, from the port's own record
(`obs/timing.frame_spans`)."""

from ..program_spans import host_ms

NAME = "depth.road.host_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frame_ms_p95"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("depth.road")
