"""mono_lidar_depth_tpu_torch — the PyTorch/CUDA port of mono_lidar_depth_tpu.

The JAX package beside it stays the reference; each module here mirrors
the module of the same path there, and the parity tests in
tests/test_torch_*.py hold one against the other.  Plain tensor code is
PyTorch; the one TPU kernel on the main path (window extraction) is a
hand-written CUDA kernel (csrc/windows.cu).  Importing the package turns
TF32 off (precision.py).
"""

from . import precision
from .config import DepthEstimatorConfig, TrackletConfig
from .core.depth_estimator import (DepthEstimate, estimate_depths,
                                   estimate_depths_from_frame,
                                   estimate_depths_pair, no_ground_plane,
                                   rasterize_cloud)
from .core.geometry import SE3, PinholeCamera
from .core.ransac import GroundPlane, fit_ground_plane_ransac
from .core.result_types import DepthResultType
from .tracks.pipeline import (FrameInput, TrackletDepthState, prime_state,
                              process_frame)
from .vo.pipeline import (OdometryConfig, OdometryState, odometry_step,
                          run_odometry)

precision.enforce_fp32()

__all__ = [
    "DepthEstimatorConfig", "TrackletConfig", "DepthEstimate",
    "estimate_depths", "estimate_depths_from_frame", "estimate_depths_pair",
    "no_ground_plane", "rasterize_cloud", "SE3", "PinholeCamera",
    "GroundPlane", "fit_ground_plane_ransac", "DepthResultType",
    "FrameInput", "TrackletDepthState", "prime_state", "process_frame",
    "OdometryConfig", "OdometryState", "odometry_step", "run_odometry",
]
