"""Device ms per profiled frame of the activities that the launch calls
inside the port's span `depth.road` enqueued: the depth cascade's road
pass (`_depth_cascade`: `_road_pass`, the M-estimator planes)."""

from ..program_spans import device_ms

NAME = "depth.road.device_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return device_ms(r, "depth.road")
