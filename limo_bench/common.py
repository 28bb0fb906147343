"""What a configuration's pipeline needs from its file: the port's
configuration objects, the lap rendered on the card and kept in pinned
host memory with its RANSAC draws, and the frames a check samples."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import scene


def depth_config(mod, cfg: dict):
    """`DepthEstimatorConfig` of the port `mod` from the configuration's
    `depth_estimator` section, which states every parameter."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["depth_estimator"].items()}
    return mod.DepthEstimatorConfig(**kw)


def camera(mod, cfg: dict):
    cam = cfg["camera"]
    return mod.PinholeCamera(width=cam["width"], height=cam["height"],
                             focal_length=float(cam["focal"]),
                             cx=float(cam["cx"]), cy=float(cam["cy"]))


def lidar_to_cam(mod, device):
    return mod.SE3(torch.tensor(scene.R_CL, dtype=torch.float32,
                                device=device),
                   torch.tensor(scene.T_CL, dtype=torch.float32,
                                device=device))


class Lap(NamedTuple):
    """One lap of sensor data in pinned host memory, and its RANSAC draws
    on the card (one set per lap frame)."""

    labels: torch.Tensor  # [F, H, W] uint8
    clouds: torch.Tensor  # [F, P, 3] float32, padded
    valid: torch.Tensor  # [F, P] bool
    sub_idx: torch.Tensor  # [F, S_sub] int64, on the card
    picks: torch.Tensor  # [F, S, 3] int64, on the card
    returns: list  # lidar returns per frame


def make_lap(cfg: dict, seed: int, device) -> Lap:
    """Render the lap on `device`, pad its clouds to `max_points`, draw
    the RANSAC subsample and picks of every frame, and move the sensor
    data to pinned host memory."""
    dcfg = cfg["depth_estimator"]
    P = dcfg["max_points"]
    frames = scene.render_lap(cfg, seed, device)
    F = len(frames)
    clouds = torch.zeros((F, P, 3), dtype=torch.float32, device=device)
    valid = torch.zeros((F, P), dtype=torch.bool, device=device)
    returns = []
    for k, fr in enumerate(frames):
        n = min(fr.points.shape[0], P)
        clouds[k, :n] = fr.points[:n]
        valid[k, :n] = True
        returns.append(int(fr.points.shape[0]))
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, 4]).generate_state(1)[0]))
    S_sub, S = dcfg["ransac_subsample_points"], dcfg["ransac_num_hypotheses"]
    n = valid.sum(1).clamp(min=1)
    u = torch.rand((F, S_sub), generator=gen, device=device)
    sub_idx = torch.minimum((u * n[:, None]).long(), n[:, None] - 1)
    picks = torch.randint(0, S_sub, (F, S, 3), generator=gen, device=device)
    pin = device.type == "cuda" if isinstance(device, torch.device) else False

    def host(x):
        """x in host memory, pinned on a card: one copy."""
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=pin).copy_(x)

    return Lap(labels=host(torch.stack([f.label for f in frames])),
               clouds=host(clouds), valid=host(valid), sub_idx=sub_idx,
               picks=picks, returns=returns)


def sample_frames(seed: int, every: int, count: int) -> set:
    """The window frames whose answers are checked: every `every`-th
    frame from an offset drawn from the seed, `count` of them."""
    off = int(np.random.SeedSequence([seed, 5]).generate_state(1)[0]) % every
    return {off + every * i for i in range(count)}
