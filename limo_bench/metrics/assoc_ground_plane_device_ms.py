"""Device ms per profiled frame of the activities that the launch calls
inside the port's span `assoc.ground_plane` enqueued: the frame's ground
plane in `process_frame` (`_frame_ground_plane`: the semantic plane, or
RANSAC)."""

from ..program_spans import device_ms

NAME = "assoc.ground_plane.device_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return device_ms(r, "assoc.ground_plane")
