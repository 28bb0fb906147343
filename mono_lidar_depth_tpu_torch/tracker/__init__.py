"""Feature detection + tracking (counterpart of tracker/): Shi-Tomasi
detection, pyramidal KLT and the stateful frontend that feeds the
tracklet-depth pipeline."""

from .harris import detect_features, shi_tomasi_response
from .klt import build_pyramid, track_features
from .frontend import (TrackerOutput, TrackerState, init_tracker,
                       track_frame)

__all__ = ["detect_features", "shi_tomasi_response", "build_pyramid",
           "track_features", "TrackerState", "TrackerOutput", "init_tracker",
           "track_frame"]
