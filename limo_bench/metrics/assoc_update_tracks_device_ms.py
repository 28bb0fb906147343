"""Device ms per profiled frame of the activities that the launch calls
inside the port's span `assoc.update_tracks` enqueued:
`tracks/table.update_tracks` in `process_frame`."""

from ..program_spans import device_ms

NAME = "assoc.update_tracks.device_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return device_ms(r, "assoc.update_tracks")
