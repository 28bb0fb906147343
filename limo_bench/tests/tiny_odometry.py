"""The odometry configuration small enough for the CPU tests: its sizes
cut down as `tiny.tiny_config` cuts the node's, its structure kept."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
NAME = "kitti_hdl64_limo"
CELL = f"{NAME}.online"


def tiny_config() -> dict:
    with open(BENCH / "configs" / f"{NAME}.json") as fh:
        cfg = copy.deepcopy(json.load(fh))
    # denser lidar than the node's tiny scene, so that enough tracks get a
    # depth for a pose Gauss-Newton that is well posed; the sampled frames
    # lie on the lap's first straight
    cfg["camera"] = {"width": 256, "height": 128, "focal": 120.0,
                     "cx": 128.3, "cy": 63.7}
    cfg["lidar"].update(rows=48, cols=1000)
    cfg["depth_estimator"].update(
        max_points=48000, max_features=192, image_width=256,
        image_height=128, ransac_num_hypotheses=64,
        ransac_subsample_points=512)
    cfg["tracker"].update(max_features=192, pyramid_levels=3)
    cfg["max_tracks"] = 384
    cfg["motion"]["lap_frames"] = 40
    return cfg
