"""Share of the window's frames in which `odometry_step` ran its pose
retry from identity: 100 x the frames that entered the port's span
`vo.pose_retry` over those that entered its root `odo.step`, in the
port's record of its last frames (`obs/timing.frame_spans`); 0 when no
frame retried.  None against a port without the root span."""

import importlib

from .. import program_spans

NAME = "vo.retry_pct"
UNIT = "%"
LAYER = "odometry"
MOVES = "frames_per_s"
SOURCE = "program_span"
SPANS = []
ROOT = "odo.step"
RETRY = "vo.pose_retry"


def read(r):
    timing = importlib.import_module(program_spans.PORT_TIMING)
    frame_spans = getattr(timing, "frame_spans", None)
    spans = frame_spans() if frame_spans is not None else {}
    if ROOT not in spans:
        return None
    retried = spans[RETRY]["frames"] if RETRY in spans else 0
    return 100.0 * retried / spans[ROOT]["frames"]
