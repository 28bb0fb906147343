"""Sequence evaluators: depth-association statistics and visual odometry."""

from .kitti_eval import (eval_depth_sequence, eval_vo_sequence,
                         measure_depth_device_time)

__all__ = ["eval_depth_sequence", "eval_vo_sequence",
           "measure_depth_device_time"]
