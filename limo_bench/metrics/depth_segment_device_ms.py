"""Device ms per profiled frame of the activities that the launch calls
inside the port's span `depth.segment` enqueued: the depth cascade's
primary path (`_depth_cascade`: the histogram, the max-spanning
triangle, the planarity check and their code selects)."""

from ..program_spans import device_ms

NAME = "depth.segment.device_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return device_ms(r, "depth.segment")
