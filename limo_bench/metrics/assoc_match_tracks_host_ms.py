"""Host ms per frame of the port's span `assoc.match_tracks`:
`tracks/table.match_tracks` in `process_frame`. The median over the
window's frames, from the port's own record (`obs/timing.frame_spans`)."""

from ..program_spans import host_ms

NAME = "assoc.match_tracks.host_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frame_ms_p95"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("assoc.match_tracks")
