"""Gauss-Newton 3D->2D pose estimation with robust weights (counterpart of
vo/pose.py).

Huber-weighted GN over all observations, then a hard-outlier refit.
The iteration loops are Python loops; every step runs both stages
unconditionally and selects with `torch.where`, as the JAX version
does, so no step reads a value back to the host.  On a card the call
replays a CUDA graph of `_estimate_pose_gn_eager` (`graphs.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.geometry import PinholeCamera
from ..graphs import Graphed
from .lie import se3_exp
from .linalg6 import solve6_spd


class PoseEstimate(NamedTuple):
    rotation: torch.Tensor  # [3, 3] ref -> cur
    translation: torch.Tensor  # [3]
    inliers: torch.Tensor  # [N] bool
    mean_error: torch.Tensor  # [] px
    num_inliers: torch.Tensor  # [] int
    hessian: torch.Tensor  # [6, 6] final J^T W J


def _estimate_pose_gn_eager(
    camera: PinholeCamera,
    landmarks_ref: torch.Tensor,
    obs_uv: torch.Tensor,
    valid: torch.Tensor,
    R_init: Optional[torch.Tensor] = None,
    t_init: Optional[torch.Tensor] = None,
    iters: int = 10,
    huber_px: float = 3.0,
    outlier_px: float = 6.0,
    min_depth: float = 0.25,
) -> PoseEstimate:
    """`estimate_pose_gn`'s body, run eagerly."""
    dev = landmarks_ref.device
    f = camera.focal_length
    if R_init is None:
        R_init = torch.eye(3, device=dev)
    if t_init is None:
        t_init = torch.zeros(3, device=dev)
    X_t = landmarks_ref.T  # [3, N]
    eye6 = torch.eye(6, device=dev)

    def residuals_and_jac(R, t):
        p = R @ X_t + t[:, None]  # [3, N]
        inv_z = 1.0 / torch.clamp(p[2], min=min_depth)
        u = f * p[0] * inv_z + camera.cx
        v = f * p[1] * inv_z + camera.cy
        r = torch.stack([u - obs_uv[:, 0], v - obs_uv[:, 1]])  # [2, N]
        xiz, yiz = p[0] * inv_z, p[1] * inv_z
        fiz = f * inv_z
        zero = torch.zeros_like(fiz)
        # rows of Jp @ [I | -hat(p)] (left perturbation exp(xi) ∘ T)
        Ju = torch.stack([fiz, zero, -fiz * xiz, -f * xiz * yiz,
                          f * (1.0 + xiz * xiz), -f * yiz])
        Jv = torch.stack([zero, fiz, -fiz * yiz, -f * (1.0 + yiz * yiz),
                          f * xiz * yiz, f * xiz])
        return r, torch.stack([Ju, Jv]), p[2] <= min_depth  # J [2, 6, N]

    def err_of(r):
        return torch.sqrt((r * r).sum(0) + 1e-18)

    def run(R, t, sel_mask, n):
        for _ in range(n):
            r, J, behind = residuals_and_jac(R, t)
            err = err_of(r)
            w_h = torch.where(err <= huber_px, 1.0,
                              huber_px / torch.clamp(err, min=1e-9))
            w = torch.where(sel_mask & ~behind, w_h, 0.0)
            Jw = J * w
            H = torch.einsum("rin,rjn->ij", Jw, J) + 1e-6 * eye6
            g = torch.einsum("rin,rn->i", Jw, r)
            dR, dt = se3_exp(-solve6_spd(H, g))
            R, t = dR @ R, dR @ t + dt
        return R, t

    R, t = run(R_init, t_init, valid, iters)

    # Second stage: hard-reject outliers of the first fit and refit.
    r, _, behind = residuals_and_jac(R, t)
    stage2_valid = valid & ~behind & (err_of(r) < outlier_px)
    enough = stage2_valid.sum() >= 6
    R2, t2 = run(R, t, stage2_valid, max(iters // 2, 3))
    R = torch.where(enough, R2, R)
    t = torch.where(enough, t2, t)

    r, J, behind = residuals_and_jac(R, t)
    err = err_of(r)
    inliers = valid & ~behind & (err < outlier_px)
    n_in = inliers.sum()
    mean_err = torch.where(inliers, err, 0.0).sum() / torch.clamp(n_in, min=1)
    Jw = J * inliers.to(J.dtype)
    return PoseEstimate(rotation=R, translation=t, inliers=inliers,
                        mean_error=mean_err, num_inliers=n_in,
                        hessian=torch.einsum("rin,rjn->ij", Jw, J))


_GRAPHS = Graphed(_estimate_pose_gn_eager, "vo.pose_gn.replay")


def estimate_pose_gn(
    camera: PinholeCamera,
    landmarks_ref: torch.Tensor,
    obs_uv: torch.Tensor,
    valid: torch.Tensor,
    R_init: Optional[torch.Tensor] = None,
    t_init: Optional[torch.Tensor] = None,
    iters: int = 10,
    huber_px: float = 3.0,
    outlier_px: float = 6.0,
    min_depth: float = 0.25,
) -> PoseEstimate:
    """Estimate T with x_cur = T(x_ref) from landmarks [N, 3] in the
    reference camera and their pixels [N, 2] in the current image.

    On the current card the call replays the CUDA graph of its signature
    (span `vo.pose_gn.replay`), captured on its first call, which runs
    eagerly; elsewhere it runs `_estimate_pose_gn_eager`
    (`graphs.py`)."""
    return _GRAPHS(camera, landmarks_ref, obs_uv, valid, R_init, t_init,
                   iters, huber_px, outlier_px, min_depth)
