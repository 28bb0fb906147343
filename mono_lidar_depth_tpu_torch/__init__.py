"""mono_lidar_depth_tpu_torch — the PyTorch/CUDA port of mono_lidar_depth_tpu.

The JAX package beside it stays the reference; each module here mirrors
the module of the same path there, and the parity tests in
tests/test_torch_*.py hold one against the other.  Plain tensor code is
PyTorch; the one TPU kernel of the JAX package (window extraction) is
hand-written CUDA: the literal crop (csrc/windows.cu) and one fused form
per caller: the neighbor gather of the depth path
(csrc/gather_neighbors.cu), the Lucas-Kanade passes over every pyramid
level (csrc/lk_track.cu) and the acceptance gate (csrc/zncc_gate.cu) of
the tracker.  Entry paths:
`odometry_step` on given feature tracks, and the sequence evaluators
`eval_vo_sequence` / `eval_depth_sequence` (or the per-frame
`frame_inputs`) from grey images and lidar scans; the loop-closure
backend (config 4) is in `vo/closures.py` and `vo/pose_graph.py`,
re-exported through `eval`.  Tensors live on `default_device()` (CUDA
device 0) unless the caller passes a device.  Importing the package turns
TF32 off (precision.py).
"""

from . import precision
from .config import DepthEstimatorConfig, TrackletConfig
from .core.depth_estimator import (DepthEstimate, estimate_depths,
                                   estimate_depths_from_frame,
                                   estimate_depths_pair, no_ground_plane,
                                   rasterize_cloud)
from .core.geometry import SE3, PinholeCamera
from .core.ransac import (GroundPlane, fit_ground_plane_ransac,
                          fit_ground_plane_semantic)
from .core.result_types import DepthResultType
from .device import default_device
from .eval.kitti_eval import _frame_inputs as frame_inputs
from .eval.kitti_eval import (eval_depth_sequence, eval_vo_sequence,
                              measure_depth_device_time)
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.kitti import KittiSequence
from .io.synthetic_dataset import (SyntheticSequence, SyntheticSpec,
                                   render_sequence)
from .tracker import (TrackerOutput, TrackerState, build_pyramid,
                      detect_features, init_tracker, shi_tomasi_response,
                      track_features, track_frame)
from .tracks.pipeline import (FrameInput, TrackletDepthState, prime_state,
                              process_frame, process_sequence)
from .vo.pipeline import (OdometryConfig, OdometryState, odometry_step,
                          run_odometry)

precision.enforce_fp32()

__all__ = [
    "DepthEstimatorConfig", "TrackletConfig", "DepthEstimate",
    "estimate_depths", "estimate_depths_from_frame", "estimate_depths_pair",
    "no_ground_plane", "rasterize_cloud", "SE3", "PinholeCamera",
    "GroundPlane", "fit_ground_plane_ransac", "fit_ground_plane_semantic",
    "DepthResultType", "FrameInput", "TrackletDepthState", "prime_state",
    "process_frame", "process_sequence",
    "OdometryConfig", "OdometryState", "odometry_step", "run_odometry",
    "default_device", "frame_inputs", "eval_vo_sequence",
    "eval_depth_sequence", "measure_depth_device_time", "KittiSequence",
    "load_checkpoint", "save_checkpoint",
    "SyntheticSequence", "SyntheticSpec", "render_sequence",
    "TrackerOutput", "TrackerState", "build_pyramid", "detect_features",
    "init_tracker", "shi_tomasi_response", "track_features", "track_frame",
]
