"""Share of the window's odometry frames in which `vo/ba.run_ba` replayed
its CUDA graph (the window's bundle adjustment): 100 x the frames that
entered the port's span `vo.ba.replay` over those that entered its root
`odo.step`, in the port's record of its last frames
(`obs/timing.frame_spans`).  None against a port without the span."""

import importlib

from .. import program_spans

NAME = "vo.ba.replay_pct"
UNIT = "%"
LAYER = "odometry"
MOVES = "frames_per_s"
SOURCE = "program_span"
SPANS = []
ROOT = "odo.step"
REPLAY = "vo.ba.replay"


def read(r):
    timing = importlib.import_module(program_spans.PORT_TIMING)
    frame_spans = getattr(timing, "frame_spans", None)
    spans = frame_spans() if frame_spans is not None else {}
    if REPLAY not in spans or ROOT not in spans:
        return None
    return 100.0 * spans[REPLAY]["frames"] / spans[ROOT]["frames"]
