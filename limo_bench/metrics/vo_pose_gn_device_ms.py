"""Device time of the pose Gauss-Newton per frame: every activity between
the markers around `estimate_pose_gn` as `vo/pipeline` calls it (both
calls in a frame whose retry runs)."""

NAME = "vo.pose_gn.device_ms"
UNIT = "ms"
LAYER = "odometry"
MOVES = "frames_per_s"
SOURCE = "device_trace"
SPANS = [("mono_lidar_depth_tpu_torch.vo.pipeline", "estimate_pose_gn",
          "pose_gn", None)]


def read(r):
    return r.device_ms("pose_gn")
