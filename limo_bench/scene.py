"""The benchmark's scene: the port's analytic synthetic scene (ground
plane, two side walls, a front and a back wall, a world-anchored
procedural texture), frozen here and rendered in PyTorch on the card.

`hash2`, `texture`, `cast`, `trajectory` and `calibration` are
`io/synthetic_dataset.py`'s `_hash2`, `_texture`, `_cast`, `_trajectory`
and `calibration` as they stood when the benchmark was defined, with
two changes that the configurations need: the camera's principal
point is the configuration's (the port's renderer puts it at the image
centre), and the lidar's rays cover the configuration's elevations and
azimuths (the port's renderer covers 84 degrees in azimuth).  The seed
draws the lidar's range noise; the geometry and the images are the same
for every seed, so that every seed gives the program the same work.
The numpy renderer renders a frame in about half a second on one CPU
core; this one renders the whole lap on the card during set-up.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

GROUND_Y = 1.5
WALL_X = 9.0
FRONT_Z_OFFSET = 90.0
WALL_Y_TOP = -4.5
LABEL_ROAD = 7
LABEL_WALL = 11
LABEL_SKY = 23
R_CL = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float64)
T_CL = np.array([0.0, 0.08, 0.27], dtype=np.float64)


def hash2(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-random value in [0, 1) per integer cell."""
    h = ix.to(torch.int64) * 374761393 + iy.to(torch.int64) * 668265263
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float64) / 65536.0


def texture(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """World-anchored 2-octave blocky value texture in [0, 1]."""
    t = 0.55 * hash2(torch.floor(u * 2.0), torch.floor(v * 2.0))
    t = t + 0.3 * hash2(torch.floor(u * 0.5) + 1000, torch.floor(v * 0.5))
    t = t + 0.15 * hash2(torch.floor(u * 8.0) + 7000, torch.floor(v * 8.0))
    return t


def cast(o: torch.Tensor, d: torch.Tensor, z_end: float
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ray-cast the scene: (t_hit [R], inf where no hit; shade [R] in
    [0, 1]; label [R] uint8).  `o` [R, 3] or [3], `d` [R, 3], float64,
    world frame."""
    R = d.shape[0]
    o = o.expand_as(d)
    dev = d.device
    best_t = torch.full((R,), math.inf, dtype=torch.float64, device=dev)
    shade = torch.zeros(R, dtype=torch.float64, device=dev)
    label = torch.full((R,), LABEL_SKY, dtype=torch.uint8, device=dev)

    def consider(t, cond, u, v, salt, lab):
        nonlocal best_t, shade, label
        ok = cond & (t > 0.25) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        shade = torch.where(ok, texture(u + salt, v), shade)
        label = torch.where(ok, torch.tensor(lab, dtype=torch.uint8,
                                             device=dev), label)

    front_z = z_end + FRONT_Z_OFFSET
    t = (GROUND_Y - o[:, 1]) / d[:, 1]
    p = o + t[:, None] * d
    consider(t, (d[:, 1] != 0) & (p[:, 0].abs() <= WALL_X)
             & (p[:, 2] < front_z), p[:, 0], p[:, 2], 0.0, LABEL_ROAD)
    for sx, salt in ((-WALL_X, 300.0), (WALL_X, 600.0)):
        t = (sx - o[:, 0]) / d[:, 0]
        p = o + t[:, None] * d
        consider(t, (d[:, 0] != 0) & (p[:, 1] >= WALL_Y_TOP)
                 & (p[:, 1] <= GROUND_Y) & (p[:, 2] < front_z),
                 p[:, 2], p[:, 1], salt, LABEL_WALL)
    for fz, salt in ((front_z, 900.0), (-20.0, 1200.0)):
        t = (fz - o[:, 2]) / d[:, 2]
        p = o + t[:, None] * d
        consider(t, (d[:, 2] != 0) & (p[:, 0].abs() <= WALL_X)
                 & (p[:, 1] >= WALL_Y_TOP) & (p[:, 1] <= GROUND_Y),
                 p[:, 0], p[:, 1], salt, LABEL_WALL)
    return best_t, shade, label


def trajectory(lap_frames: int, step: float) -> list:
    """world<-cam poses (R_wc, c) of one lap of the multi-lap loop
    (`SyntheticSpec(loop=True, lap_frames=lap_frames)`): straight, U-turn,
    straight, U-turn; the lap closes exactly, so it can be replayed."""
    turn = max(10, lap_frames // 4)
    straight = max(1, (lap_frames - 2 * turn) // 2)
    cycle = ([0.0] * straight + [np.pi / turn] * turn
             + [0.0] * straight + [np.pi / turn] * turn)
    yaw_plan = (cycle * (lap_frames // len(cycle) + 1))[:lap_frames]
    poses, R_wc, c = [], np.eye(3), np.zeros(3)
    for yaw in yaw_plan:
        poses.append((R_wc.copy(), c.copy()))
        dR = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        R_wc = R_wc @ dR
        c = c + R_wc @ np.array([0.0, 0.0, step])
    return poses


def calibration(cam: dict) -> tuple[np.ndarray, np.ndarray]:
    """(P0 [3, 4] projection, Tr [3, 4] lidar->cam0) of the camera."""
    P0 = np.zeros((3, 4))
    P0[0, 0] = P0[1, 1] = cam["focal"]
    P0[0, 2], P0[1, 2], P0[2, 2] = cam["cx"], cam["cy"], 1.0
    return P0, np.concatenate([R_CL, T_CL[:, None]], axis=1)


def lidar_rays(lidar: dict, device) -> torch.Tensor:
    """Unit rays [rows * cols, 3] in the lidar frame (x forward, y left,
    z up), row by row from the top beam down, each row sweeping azimuth
    from left to right."""
    elev = torch.linspace(math.radians(lidar["elev_max_deg"]),
                          math.radians(lidar["elev_min_deg"]),
                          lidar["rows"], dtype=torch.float64, device=device)
    half = math.radians(lidar["azim_span_deg"]) / 2
    cols = lidar["cols"]
    if lidar["azim_span_deg"] >= 360.0:  # a full turn: no repeated column
        azim = half - torch.arange(cols, dtype=torch.float64,
                                   device=device) * (2 * half / cols)
    else:
        azim = torch.linspace(half, -half, cols, dtype=torch.float64,
                              device=device)
    E, A = torch.meshgrid(elev, azim, indexing="ij")
    return torch.stack([torch.cos(E) * torch.cos(A),
                        torch.cos(E) * torch.sin(A), torch.sin(E)],
                       dim=-1).reshape(-1, 3)


class Frame(NamedTuple):
    image: torch.Tensor  # [H, W] uint8
    label: torch.Tensor  # [H, W] uint8
    points: torch.Tensor  # [n, 3] float32 lidar frame (hits only)


def render_frame(cfg: dict, pose, d_cam: torch.Tensor, d_lid: torch.Tensor,
                 z_end: float, generator) -> Frame:
    """One frame on the rays' device: grey image, labels, lidar hits
    with the configuration's range noise."""
    cam, lidar = cfg["camera"], cfg["lidar"]
    dev = d_cam.device
    R_wc = torch.as_tensor(pose[0], dtype=torch.float64, device=dev)
    c = torch.as_tensor(pose[1], dtype=torch.float64, device=dev)
    t, shade, label = cast(c, d_cam @ R_wc.T, z_end)
    img = torch.where(torch.isfinite(t), shade, 0.08)
    img = (img.clamp(0, 1) * 255).to(torch.uint8).reshape(cam["height"],
                                                          cam["width"])
    R_wl = R_wc @ torch.as_tensor(R_CL, dtype=torch.float64, device=dev)
    o_l = c + R_wc @ torch.as_tensor(T_CL, dtype=torch.float64, device=dev)
    t_l, _, _ = cast(o_l, d_lid @ R_wl.T, z_end)
    hit = torch.isfinite(t_l) & (t_l < lidar["max_range_m"])
    pts = d_lid * torch.where(hit, t_l, 0.0)[:, None]
    noise = torch.randn(pts.shape, dtype=torch.float64, device=dev,
                        generator=generator) * lidar["noise_m"]
    return Frame(img, label.reshape(cam["height"], cam["width"]),
                 (pts + noise)[hit].to(torch.float32))


def pixel_rays(cam: dict, device) -> torch.Tensor:
    """Camera rays [H * W, 3] through the pixel centres, z = 1."""
    W, H, f = cam["width"], cam["height"], cam["focal"]
    vv, uu = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=device) + 0.5,
        torch.arange(W, dtype=torch.float64, device=device) + 0.5,
        indexing="ij")
    return torch.stack([(uu.reshape(-1) - cam["cx"]) / f,
                        (vv.reshape(-1) - cam["cy"]) / f,
                        torch.ones(W * H, dtype=torch.float64,
                                   device=device)], dim=1)


def render_lap(cfg: dict, seed: int, device) -> list[Frame]:
    """Every frame of one lap, on `device`, from the seed."""
    motion = cfg["motion"]
    lap = motion["lap_frames"]
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, 2]).generate_state(1)[0]))
    d_cam = pixel_rays(cfg["camera"], device)
    d_lid = lidar_rays(cfg["lidar"], device)
    return [render_frame(cfg, pose, d_cam, d_lid, lap * motion["step_m"],
                         gen)
            for pose in trajectory(lap, motion["step_m"])]
