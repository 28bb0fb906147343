"""Host ms per frame of the port's span `assoc.frame`:
`tracks/pipeline.process_frame` whole: the depth association of one
frame (the root span). The median over the window's frames, from the
port's own record (`obs/timing.frame_spans`)."""

from ..program_spans import host_ms

NAME = "assoc.frame.host_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frame_ms_p95"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("assoc.frame")
