"""Synthetic KITTI-like scans and cloud padding (numpy only; copies of
`make_synthetic_scan` and `pad_cloud` in io/kitti.py, whose module
imports the JAX geometry).  The KITTI sequence loader is not ported yet.
"""

from __future__ import annotations

import numpy as np


def pad_cloud(xyzi: np.ndarray, n: int, max_points: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """([*, 4], count) → (padded [max_points, 3] xyz, valid mask)."""
    out = np.zeros((max_points, 3), dtype=np.float32)
    k = min(n, max_points)
    out[:k] = xyzi[:k, :3]
    valid = np.zeros(max_points, dtype=bool)
    valid[:k] = True
    return out, valid


def make_synthetic_scan(rng: np.random.Generator, n_points: int = 120000,
                        ) -> np.ndarray:
    """KITTI-like synthetic velodyne scan (lidar frame, z up): ground
    plane + walls + scattered structure.  Used by benchmarks and tests
    when the real dataset is absent."""
    n_ground = n_points // 2
    n_wall = n_points // 4
    n_clutter = n_points - n_ground - n_wall
    r = rng.uniform(2, 70, n_ground)
    th = rng.uniform(-np.pi / 3, np.pi / 3, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       -1.73 + 0.02 * rng.normal(size=n_ground)], 1)
    wx = rng.uniform(14.5, 15.5, n_wall)
    wy = rng.uniform(-12, 12, n_wall)
    wz = rng.uniform(-1.7, 2.5, n_wall)
    wall = np.stack([wx, wy, wz], 1)
    clutter = rng.uniform([2, -20, -1.7], [75, 20, 4], (n_clutter, 3))
    pts = np.concatenate([ground, wall, clutter]).astype(np.float32)
    intens = rng.uniform(0, 1, (n_points, 1)).astype(np.float32)
    return np.concatenate([pts, intens], axis=1)
