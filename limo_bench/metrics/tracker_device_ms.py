"""Device time of the tracker per frame: every activity between the
markers around `track_frame` as the cell calls it (the package's
attribute): the pyramid, both LK passes and the gate, detection and
lane allocation."""

NAME = "tracker.device_ms"
UNIT = "ms"
LAYER = "tracker"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = [("mono_lidar_depth_tpu_torch", "track_frame", "tracker", None)]


def read(r):
    return r.device_ms("tracker")
