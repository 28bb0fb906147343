"""Share of its roofline that `core/neighbors.gather_neighbors_frames`
reaches: the least time of its work at the H100's published peaks over
the device time between its markers, summed over the profiled calls."""

from ..roofline import gather_neighbors_frames_work

NAME = "gather_neighbors_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = [("mono_lidar_depth_tpu_torch.core.depth_estimator",
          "gather_neighbors_frames", "gather_neighbors",
          gather_neighbors_frames_work)]


def read(r):
    return r.roofline_pct("gather_neighbors")
