"""Host ms per frame of the port's span `assoc.depth_pair`:
`core/depth_estimator.estimate_depths_pair` in `process_frame`: the
neighbor gather, the depth cascade, the counters. The median over the
window's frames, from the port's own record (`obs/timing.frame_spans`)."""

from ..program_spans import host_ms

NAME = "assoc.depth_pair.host_ms"
UNIT = "ms"
LAYER = "association"
MOVES = "frame_ms_p95"
SOURCE = "program_span"
SPANS = []


def read(r):
    return host_ms("assoc.depth_pair")
