"""Device time of the depth association per frame: every activity
between the markers around `tracks/pipeline.process_frame`."""

from .assoc_host_ms import SPANS  # noqa: F401  (the same span)

NAME = "assoc.device_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(r):
    return r.device_ms("assoc")
