"""Trajectory evaluation: ATE / RPE against ground truth (copy of
vo/metrics.py, numpy only; the
BASELINE.json headline metric — KITTI odometry ATE RMSE)."""

from __future__ import annotations

import numpy as np


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False
                  ) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity alignment est→gt of [N, 3] point sets.
    Returns (R, t, s) with gt ≈ s R est + t."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after (optional) SE(3)/Sim(3)
    alignment, over [N, 3] camera positions."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    if align:
        R, t, s = umeyama_align(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_stats(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
              ) -> dict:
    """Relative pose error over [N, 4, 4] pose arrays (world←cam):
    translational RMSE (m) and rotational RMSE (deg) per `delta` frames."""
    est = np.asarray(est_poses, dtype=np.float64)
    gt = np.asarray(gt_poses, dtype=np.float64)
    n = len(est) - delta
    terr, rerr = [], []
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(cos)))
    return {
        "trans_rmse": float(np.sqrt(np.mean(np.square(terr)))),
        "rot_rmse_deg": float(np.sqrt(np.mean(np.square(rerr)))),
    }
