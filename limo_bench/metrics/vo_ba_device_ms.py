"""Device time of the window bundle adjustment per frame: every activity
between the markers around `run_ba` as `vo/pipeline` calls it."""

NAME = "vo.ba.device_ms"
UNIT = "ms"
LAYER = "odometry"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = [("mono_lidar_depth_tpu_torch.vo.pipeline", "run_ba", "ba", None)]


def read(r):
    return r.device_ms("ba")
