"""Sequence evaluators (depth-association statistics, visual odometry) and
the loop-closure backend's entry points, under the reference's names."""

from .kitti_eval import (eval_depth_sequence, eval_vo_sequence,
                         measure_depth_device_time, propose_loop_closures,
                         propose_loop_closures_appearance,
                         run_pose_graph_backend, union_closure_candidates)

__all__ = ["eval_depth_sequence", "eval_vo_sequence",
           "measure_depth_device_time", "propose_loop_closures",
           "propose_loop_closures_appearance", "run_pose_graph_backend",
           "union_closure_candidates"]
