"""Share of its roofline that `tracker/klt._track_gate` (the acceptance
gate, the `zncc_gate` kernel on a card) reaches: the least time of its
work at the H100's published peaks over the device time between its
markers, summed over the profiled calls."""

from ..roofline_tracker import zncc_gate_work

NAME = "zncc_gate_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = [("mono_lidar_depth_tpu_torch.tracker.klt", "_track_gate",
          "zncc_gate", zncc_gate_work)]


def read(r):
    return r.roofline_pct("zncc_gate")
