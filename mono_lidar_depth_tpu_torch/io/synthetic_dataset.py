"""Synthetic KITTI-odometry-format sequence generator (counterpart of
io/synthetic_dataset.py; numpy only).

An ANALYTIC scene — ground plane + wall faces ray-cast exactly, with a
world-anchored procedural texture — rendered as grayscale camera images,
azimuth-ordered lidar scans and exact ground-truth poses, so that KLT
tracks correspond to real surface points and the whole stack (tracker →
depth association → VO → metrics) runs end to end with no dataset.

`SyntheticSpec`, `_hash2`, `_texture` and `_cast` are the JAX package's,
unchanged.  Its `generate_kitti_sequence` is split in two here:

  * `render_sequence`: the frames in memory (`SyntheticSequence`), which
    offers what the evaluators of `eval.kitti_eval` read of a sequence;
  * `generate_kitti_sequence`: the disk writer (PNG images, velodyne
    .bin scans, calib.txt, times.txt, poses), which renders through the
    same code and imports PIL only when called.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..core.geometry import SE3, PinholeCamera
from ..device import Device, default_device

# Scene layout (world frame == frame-0 camera frame: x right, y down,
# z forward).  Camera height 1.5 m above ground.
GROUND_Y = 1.5
WALL_X = 9.0
FRONT_Z_OFFSET = 90.0  # front wall placed this far past the trajectory end
WALL_Y_TOP = -4.5  # walls span y in [WALL_Y_TOP, GROUND_Y]


def _hash2(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Deterministic pseudo-random value in [0,1) per integer cell."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return ((h & 0xFFFF).astype(np.float64)) / 65536.0


def _texture(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """World-anchored 2-octave blocky value texture in [0,1]."""
    t = 0.55 * _hash2(np.floor(u * 2.0), np.floor(v * 2.0))
    t += 0.3 * _hash2(np.floor(u * 0.5) + 1000, np.floor(v * 0.5))
    t += 0.15 * _hash2(np.floor(u * 8.0) + 7000, np.floor(v * 8.0))
    return t


# Semantic label ids (matching the reference's road-class convention:
# ground-plane labels are {6, 7, 8, 9}, RansacPlane.h:217 /
# tracklet_depth_module.cpp:280).
LABEL_ROAD = 7
LABEL_WALL = 11  # "building" — not a ground class
LABEL_SKY = 23


def _cast(origins: np.ndarray, dirs: np.ndarray, z_end: float,
          road_texture: float = 1.0
          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ray-cast the analytic scene.

    Args: origins [R, 3], dirs [R, 3] (world frame, not necessarily unit).
    Returns (t_hit [R] — inf where no hit, shade [R] in [0,1],
             label [R] uint8 semantic class — LABEL_SKY where no hit).
    """
    R = origins.shape[0]
    best_t = np.full(R, np.inf)
    shade = np.zeros(R)
    label = np.full(R, LABEL_SKY, dtype=np.uint8)

    def consider(t, cond, u, v, salt, lab):
        nonlocal best_t, shade, label
        ok = cond & (t > 0.25) & (t < best_t)
        if ok.any():
            best_t = np.where(ok, t, best_t)
            s = _texture(u + salt, v)
            if lab == LABEL_ROAD and road_texture < 1.0:
                s = 0.5 + road_texture * (s - 0.5)
            shade = np.where(ok, s, shade)
            label = np.where(ok, np.uint8(lab), label)

    o, d = origins, dirs
    front_z = z_end + FRONT_Z_OFFSET
    with np.errstate(divide="ignore", invalid="ignore"):
        # ground: y = GROUND_Y
        t = (GROUND_Y - o[:, 1]) / d[:, 1]
        p = o + t[:, None] * d
        consider(t, (d[:, 1] != 0) & (np.abs(p[:, 0]) <= WALL_X)
                 & (p[:, 2] < front_z), p[:, 0], p[:, 2], 0.0, LABEL_ROAD)
        # side walls: x = ±WALL_X
        for sx, salt in ((-WALL_X, 300.0), (WALL_X, 600.0)):
            t = (sx - o[:, 0]) / d[:, 0]
            p = o + t[:, None] * d
            consider(t, (d[:, 0] != 0) & (p[:, 1] >= WALL_Y_TOP)
                     & (p[:, 1] <= GROUND_Y) & (p[:, 2] < front_z),
                     p[:, 2], p[:, 1], salt, LABEL_WALL)
        # front wall: z = front_z; back wall: z = -20 (for loop
        # trajectories looking backward down the corridor)
        for fz, salt in ((front_z, 900.0), (-20.0, 1200.0)):
            t = (fz - o[:, 2]) / d[:, 2]
            p = o + t[:, None] * d
            consider(t, (d[:, 2] != 0) & (np.abs(p[:, 0]) <= WALL_X)
                     & (p[:, 1] >= WALL_Y_TOP) & (p[:, 1] <= GROUND_Y),
                     p[:, 0], p[:, 1], salt, LABEL_WALL)
    return best_t, shade, label


@dataclass
class SyntheticSpec:
    frames: int = 10
    image_width: int = 1226
    image_height: int = 370
    focal: float = 707.0
    step: float = 0.8  # metres per frame
    yaw_rate: float = 0.004  # rad per frame
    lidar_rows: int = 32
    lidar_cols: int = 900
    elev_min: float = np.radians(-18.0)
    elev_max: float = np.radians(3.0)
    azim_half: float = np.radians(42.0)
    # "loop" trajectory: drive forward, U-turn, drive back, U-turn —
    # ends revisiting the start with the same heading (closure-able).
    loop: bool = False
    # Multi-lap: build the loop for `lap_frames` and TILE it to
    # `frames` — the 4-segment cycle (straight, U-turn, straight,
    # U-turn) closes exactly, so the trajectory retraces the same
    # circuit every lap (a revisit per lap, bounded extent).  Without
    # this, the single-lap geometry SCALES with `frames`: at 2000+
    # frames the U-turn radius grows to ~90 m and the trajectory
    # leaves the corridor scene entirely (measured: VO ATE 155 m on a
    # 2048-frame single lap vs 2-3 m at the 220-frame scale).
    lap_frames: int | None = None
    # Road texture contrast in [0, 1].  1.0 = fully textured ground
    # (trackable everywhere — the DEFAULT scene, which plants features
    # on far oblique ground and drives the TriangleNotPlanar residual,
    # DESIGN.md success-rate reconciliation).  Small values render the
    # road near-uniform,like real asphalt: the tracker then avoids it and
    # the feature distribution matches the reference's real-KITTI runs.
    road_texture: float = 1.0


# KITTI-style cam←lidar: lidar x forward, y left, z up.
R_CL = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float64)
T_CL = np.array([0.0, 0.08, 0.27], dtype=np.float64)



def _trajectory(spec: SyntheticSpec) -> list:
    """world←cam poses (R_wc, c) of every frame."""
    lap = spec.lap_frames or spec.frames
    poses = []
    R_wc = np.eye(3)
    c = np.zeros(3)
    if spec.loop and spec.lap_frames is not None:
        # multi-lap circuit: the 4-segment cycle closes exactly, so
        # tiling retraces the same positions with the same heading
        # every `lap` frames.
        turn = max(10, lap // 4)
        straight = max(1, (lap - 2 * turn) // 2)
        cycle = ([0.0] * straight + [np.pi / turn] * turn
                 + [0.0] * straight + [np.pi / turn] * turn)
        reps = spec.frames // len(cycle) + 1
        yaw_plan = (cycle * reps)[:spec.frames]
    elif spec.loop:
        # out-and-back: straight, U-turn, straight back (offset one
        # lane), U-turn, then a straight TAIL retracing the first leg
        # with the same heading — same-viewpoint revisits for loop
        # closure.
        turn = max(10, spec.frames // 4)
        tail = max(6, spec.frames // 6)
        straight = max(1, (spec.frames - 2 * turn - tail) // 2)
        yaw_plan = ([0.0] * straight + [np.pi / turn] * turn
                    + [0.0] * straight + [np.pi / turn] * turn)
        yaw_plan += [0.0] * (spec.frames - len(yaw_plan))
    else:
        yaw_plan = [spec.yaw_rate] * spec.frames
    for k in range(spec.frames):
        poses.append((R_wc.copy(), c.copy()))
        yaw = yaw_plan[k]
        dR = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        R_wc = R_wc @ dR
        c = c + R_wc @ np.array([0.0, 0.0, spec.step])
    return poses


class SyntheticFrame(NamedTuple):
    image: np.ndarray  # [H, W] uint8 grayscale
    label: np.ndarray  # [H, W] uint8 ground-truth semantic class
    scan: np.ndarray  # [n, 4] float32 lidar-frame x, y, z, intensity
    pose: np.ndarray  # [3, 4] float64 world←cam
    stamp: float  # seconds


def render_frames(spec: SyntheticSpec = SyntheticSpec(), seed: int = 0
                  ) -> Iterator[SyntheticFrame]:
    """Render the sequence frame by frame (images, labels, scans, poses)."""
    rng = np.random.default_rng(seed)
    W, H, f = spec.image_width, spec.image_height, spec.focal
    cx, cy = W / 2.0, H / 2.0
    lap = spec.lap_frames or spec.frames
    z_end = lap * spec.step

    # pixel rays (camera frame), unit-free
    uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    d_cam = np.stack([(uu.ravel() - cx) / f, (vv.ravel() - cy) / f,
                      np.ones(W * H)], axis=1)

    # lidar ray grid in lidar frame (x fwd, y left, z up), azimuth
    # sweeping left→right per row so image-x DECREASES within a row
    # (Velodyne convention the row segmenter expects).
    elev = np.linspace(spec.elev_max, spec.elev_min, spec.lidar_rows)
    azim = np.linspace(spec.azim_half, -spec.azim_half, spec.lidar_cols)
    E, A = np.meshgrid(elev, azim, indexing="ij")
    d_lid = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A),
                      np.sin(E)], axis=-1).reshape(-1, 3)

    for k, (R_wc_k, c_k) in enumerate(_trajectory(spec)):
        # ---- image + ground-truth semantics ---------------------------
        d_world = d_cam @ R_wc_k.T
        o = np.broadcast_to(c_k, d_world.shape)
        t, shade, label = _cast(o, d_world, z_end,
                                spec.road_texture)
        img = np.where(np.isfinite(t), shade, 0.08)
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8).reshape(H, W)

        # ---- lidar scan ---------------------------------------------
        # lidar pose: world←lidar = world←cam ∘ cam←lidar
        R_wl = R_wc_k @ R_CL
        o_l = c_k + R_wc_k @ T_CL
        d_world_l = d_lid @ R_wl.T
        o2 = np.broadcast_to(o_l, d_world_l.shape)
        t_l, _, _ = _cast(o2, d_world_l, z_end, spec.road_texture)
        hit = np.isfinite(t_l) & (t_l < 120.0)
        pts_l = d_lid * t_l[:, None]  # lidar-frame (rays are unit)
        noise = rng.normal(size=pts_l.shape) * 0.006
        pts_l = (pts_l + noise)[hit].astype(np.float32)
        intens = rng.uniform(0, 1, (len(pts_l), 1)).astype(np.float32)
        yield SyntheticFrame(
            image=img, label=label.reshape(H, W),
            scan=np.concatenate([pts_l, intens], axis=1),
            pose=np.concatenate([R_wc_k, c_k[:, None]], axis=1),
            stamp=k * 0.1)


def calibration(spec: SyntheticSpec) -> tuple[np.ndarray, np.ndarray]:
    """(P0 [3, 4] projection, Tr [3, 4] lidar→cam0) of the sequence."""
    W, H, f = spec.image_width, spec.image_height, spec.focal
    P0 = np.zeros((3, 4))
    P0[0, 0] = P0[1, 1] = f
    P0[0, 2] = W / 2.0
    P0[1, 2] = H / 2.0
    P0[2, 2] = 1.0
    Tr = np.concatenate([R_CL, T_CL[:, None]], axis=1)
    return P0, Tr


class SyntheticSequence:
    """A rendered sequence in memory, with what the evaluators and the
    closure verification read of a KITTI sequence: `len`,
    `scans(max_points)`, `scan(i, max_points)`, `image(i)`,
    `semantic(i)`, `times`, the camera and the lidar→camera transform,
    plus the ground-truth poses."""

    def __init__(self, frames: list, P0: np.ndarray, Tr: np.ndarray,
                 image_width: int, image_height: int):
        self.images = [f.image for f in frames]
        self.labels = [f.label for f in frames]
        self.raw_scans = [f.scan for f in frames]
        self.times = np.asarray([f.stamp for f in frames], np.float64)
        self.gt_poses = np.tile(np.eye(4), (len(frames), 1, 1))
        for k, f in enumerate(frames):
            self.gt_poses[k, :3, :] = f.pose
        self.P0, self.Tr = P0, Tr
        self.camera = PinholeCamera(
            width=image_width, height=image_height,
            focal_length=float(P0[0, 0]), cx=float(P0[0, 2]),
            cy=float(P0[1, 2]))

    def __len__(self) -> int:
        return len(self.images)

    def lidar_to_cam(self, device: Device = default_device()) -> SE3:
        return SE3(
            torch.tensor(self.Tr[:, :3], dtype=torch.float32, device=device),
            torch.tensor(self.Tr[:, 3], dtype=torch.float32, device=device))

    def scans(self, max_points: int) -> Iterator[tuple[np.ndarray, int]]:
        """Padded scans ([max_points, 4], count) in order."""
        for index in range(len(self)):
            yield self.scan(index, max_points)

    def scan(self, index: int, max_points: int) -> tuple[np.ndarray, int]:
        """Frame `index`'s padded scan ([max_points, 4], count)."""
        raw = self.raw_scans[index]
        out = np.zeros((max_points, 4), dtype=np.float32)
        n = min(len(raw), max_points)
        out[:n] = raw[:max_points]
        return out, n

    def image(self, index: int) -> Optional[np.ndarray]:
        """Grayscale image as [H, W] uint8, or None if absent."""
        return self.images[index] if 0 <= index < len(self) else None

    def semantic(self, index: int) -> Optional[np.ndarray]:
        """Semantic label image as [H, W] uint8, or None if absent."""
        return self.labels[index] if 0 <= index < len(self) else None


class VelodyneOrder:
    """A sequence whose scans run in Velodyne order: every padded scan's
    points reversed; everything else is the wrapped sequence's.

    The renderer sweeps every beam left to right, so image-x increases
    within a row and never jumps up, and `segment_rows` finds one or two
    rows in such a scan.  Reversed, a scan has what the segmenter expects
    of a Velodyne: image-x decreasing within a row and a jump up between
    rows.  Same points, same images, same poses.  Opt-in: the renderer's
    own order stays the JAX package's, byte for byte.  Wraps any sequence
    with `scans` (this package's or the JAX package's)."""

    def __init__(self, seq):
        self._seq = seq

    def __getattr__(self, name):
        return getattr(self._seq, name)

    def __len__(self) -> int:
        return len(self._seq)

    @staticmethod
    def _reversed(xyzi, n: int) -> np.ndarray:
        out = np.zeros_like(np.asarray(xyzi))
        out[:n] = np.asarray(xyzi)[:n][::-1]
        return out

    def scans(self, max_points: int) -> Iterator[tuple[np.ndarray, int]]:
        for xyzi, n in self._seq.scans(max_points):
            yield self._reversed(xyzi, n), n

    def scan(self, index: int, max_points: int) -> tuple[np.ndarray, int]:
        xyzi, n = self._seq.scan(index, max_points)
        return self._reversed(xyzi, n), n


def render_sequence(spec: SyntheticSpec = SyntheticSpec(), seed: int = 0
                    ) -> SyntheticSequence:
    """Render a whole sequence into memory."""
    P0, Tr = calibration(spec)
    return SyntheticSequence(list(render_frames(spec, seed)), P0, Tr,
                             spec.image_width, spec.image_height)


def generate_kitti_sequence(root: str, sequence: str = "99",
                            spec: SyntheticSpec = SyntheticSpec(),
                            seed: int = 0) -> None:
    """Write a synthetic KITTI-format sequence under `root`."""
    from PIL import Image

    seq_dir = Path(root) / "sequences" / sequence
    (seq_dir / "velodyne").mkdir(parents=True, exist_ok=True)
    (seq_dir / "image_0").mkdir(parents=True, exist_ok=True)
    (seq_dir / "semantic_0").mkdir(parents=True, exist_ok=True)
    (Path(root) / "poses").mkdir(parents=True, exist_ok=True)

    times = []
    gt_lines = []
    for k, frame in enumerate(render_frames(spec, seed)):
        Image.fromarray(frame.image, mode="L").save(
            seq_dir / "image_0" / f"{k:06d}.png")
        Image.fromarray(frame.label, mode="L").save(
            seq_dir / "semantic_0" / f"{k:06d}.png")
        frame.scan.tofile(seq_dir / "velodyne" / f"{k:06d}.bin")
        times.append(frame.stamp)
        gt_lines.append(" ".join(f"{x:.9e}" for x in frame.pose.ravel()))

    np.savetxt(seq_dir / "times.txt", np.asarray(times), fmt="%.6f")
    with open(Path(root) / "poses" / f"{sequence}.txt", "w") as fh:
        fh.write("\n".join(gt_lines) + "\n")

    # calib.txt: P0..P3 + Tr (lidar→cam0)
    P0, Tr = calibration(spec)
    with open(seq_dir / "calib.txt", "w") as fh:
        for name in ("P0", "P1", "P2", "P3"):
            fh.write(f"{name}: " + " ".join(
                f"{x:.12e}" for x in P0.ravel()) + "\n")
        fh.write("Tr: " + " ".join(f"{x:.12e}" for x in Tr.ravel()) + "\n")
