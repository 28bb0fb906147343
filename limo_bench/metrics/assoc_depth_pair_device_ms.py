"""Device ms per profiled frame of the activities that the launch calls
inside the port's span `assoc.depth_pair` enqueued:
`core/depth_estimator.estimate_depths_pair` in `process_frame`: the
neighbor gather, the depth cascade, the counters."""

from ..program_spans import device_ms

NAME = "assoc.depth_pair.device_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return device_ms(r, "assoc.depth_pair")
