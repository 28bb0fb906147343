"""Device ms per profiled frame of the activities that the launch calls
inside the port's span `assoc.frame` enqueued:
`tracks/pipeline.process_frame` whole: the depth association of one
frame (the root span)."""

from ..program_spans import device_ms

NAME = "assoc.frame.device_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return device_ms(r, "assoc.frame")
