"""A configuration small enough for the CPU tests: every configuration's
sizes cut down, its structure kept."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def tiny_config(name: str) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as fh:
        cfg = json.load(fh)
    cfg = copy.deepcopy(cfg)
    cfg["camera"] = {"width": 192, "height": 96, "focal": 110.0,
                     "cx": 96.3, "cy": 47.7}
    cfg["lidar"].update(rows=12, cols=240)
    cfg["depth_estimator"].update(
        max_points=4096, max_features=96, image_width=208, image_height=112,
        ransac_num_hypotheses=64, ransac_subsample_points=512)
    cfg["tracks"].update(pool=64)
    cfg["max_tracks"] = 192
    cfg["motion"]["lap_frames"] = 40
    return cfg


def tiny_traffic() -> dict:
    with open(BENCH / "traffic" / "online.json") as fh:
        traffic = json.load(fh)
    traffic.update(warmup_frames=2, check_every=2, check_frames=3)
    return traffic
