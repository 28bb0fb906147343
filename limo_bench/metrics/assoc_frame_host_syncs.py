"""Host calls that wait for the card (a stream, event or device
synchronize, or a copy that is not asynchronous) inside the port's span
`assoc.frame`, per profiled frame."""

from ..program_spans import host_syncs

NAME = "assoc.frame.host_syncs"
UNIT = "syncs/frame"
LAYER = "association"
MOVES = "frame_ms_p95"
SOURCE = "device_trace"
SPANS = []


def read(r):
    return host_syncs(r)
