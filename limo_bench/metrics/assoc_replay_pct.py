"""Share of the window's frames in which `tracks/pipeline.process_frame`
replayed its CUDA graphs: 100 x the frames that entered the port's span
`assoc.replay` over those that entered its root `assoc.frame`, in the
port's record of the last 1,024 window frames (`obs/timing.frame_spans`).
None against a port without the span."""

import importlib

from .. import program_spans

NAME = "assoc.replay_pct"
UNIT = "%"
LAYER = "association"
MOVES = "frames_per_s"
SOURCE = "program_span"
SPANS = []
REPLAY = "assoc.replay"


def read(r):
    timing = importlib.import_module(program_spans.PORT_TIMING)
    frame_spans = getattr(timing, "frame_spans", None)
    spans = frame_spans() if frame_spans is not None else {}
    if REPLAY not in spans or program_spans.FRAME not in spans:
        return None
    return (100.0 * spans[REPLAY]["frames"]
            / spans[program_spans.FRAME]["frames"])
