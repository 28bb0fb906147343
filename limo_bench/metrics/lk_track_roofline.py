"""Share of its roofline that `tracker/klt._track_passes` (both LK passes,
the `lk_track` kernel on a card) reaches: the least time of its work at
the H100's published peaks over the device time between its markers,
summed over the profiled calls."""

from ..roofline_tracker import lk_track_work

NAME = "lk_track_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = [("mono_lidar_depth_tpu_torch.tracker.klt", "_track_passes",
          "lk_track", lk_track_work)]


def read(r):
    return r.roofline_pct("lk_track")
