"""Full visual odometry step with lidar depth priors (counterpart of
vo/pipeline.py): tracklet-depth association, frame-to-frame pose GN
(with a retry from identity), acceptance gates, and the sliding-window
Schur BA.

The JAX step has two `lax.cond`s: the GN retry and the gated BA solve.
Here both predicates are read back to the host together, once per
step, and the skipped branch does not run — one device-to-host sync
per step, instead of paying a second GN solve every frame as
`torch.where` over both branches would.  The results equal the JAX
semantics, including the `est2.num_inliers > est.num_inliers` select.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DepthEstimatorConfig
from ..core.geometry import SE3, PinholeCamera, norm3
from ..device import Device, default_device
from ..tracks.pipeline import FrameInput, TrackletDepthState, process_frame
from .ba import BAProblem, run_ba
from .pose import PoseEstimate, estimate_pose_gn


class OdometryConfig(NamedTuple):
    ba_window: int = 5  # frames in the BA window
    ba_iters: int = 6
    ba_every: int = 1  # run BA every n frames
    depth_weight: float = 2.0
    min_motion_tracks: int = 12
    gn_iters: int = 10
    accept_max_err: float = 1.5  # px: mean inlier reprojection error
    accel_gate_m: float = 1.0  # max |t_rel| change per frame (m)
    retry_inlier_ratio: float = 0.5
    retry_max_err: float = 1.0  # px
    persist_landmarks: bool = False


class OdometryState(NamedTuple):
    """Odometry state (field layout of the JAX OdometryState)."""

    tracklets: TrackletDepthState
    win_R: torch.Tensor  # [W, 3, 3] camera-from-world ring, slot 0 newest
    win_t: torch.Tensor  # [W, 3]
    win_valid: torch.Tensor  # [W] bool
    frame_idx: torch.Tensor  # [] int32
    rel_R: torch.Tensor  # [3, 3] last relative motion (cur <- prev)
    rel_t: torch.Tensor  # [3]
    lm_world: torch.Tensor  # [L, 3] persisted BA landmarks
    lm_id: torch.Tensor  # [L] int32 owning track id, -1 = empty
    motion_ok: torch.Tensor  # [] bool: a motion solve was accepted

    @classmethod
    def create(cls, cfg: DepthEstimatorConfig, ocfg: OdometryConfig,
               max_tracks: int, max_length: int,
               device: Device = default_device()) -> "OdometryState":
        W = ocfg.ba_window
        win_valid = torch.zeros(W, dtype=torch.bool, device=device)
        win_valid[0] = True
        return cls(
            tracklets=TrackletDepthState.create(cfg, max_tracks, max_length,
                                                device),
            win_R=torch.eye(3, device=device).expand(W, 3, 3).clone(),
            win_t=torch.zeros((W, 3), device=device),
            win_valid=win_valid,
            frame_idx=torch.zeros((), dtype=torch.int32, device=device),
            rel_R=torch.eye(3, device=device),
            rel_t=torch.zeros(3, device=device),
            lm_world=torch.zeros((max_tracks, 3), device=device),
            lm_id=torch.full((max_tracks,), -1, dtype=torch.int32,
                             device=device),
            motion_ok=torch.zeros((), dtype=torch.bool, device=device))


def odometry_step(
    cfg: DepthEstimatorConfig,
    ocfg: OdometryConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    state: OdometryState,
    frame: FrameInput,
) -> tuple[OdometryState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full odometry frame: (state', R_cw [3,3], t_cw [3], diag [3])
    with diag = [num_motion_tracks, num_inliers, mean reproj error]."""
    tl_state, depths, codes = process_frame(
        cfg, camera, lidar_to_cam, state.tracklets, frame)
    return _odometry_tail(cfg, ocfg, camera, state, tl_state, depths, codes)


def _select(pred: torch.Tensor, a: PoseEstimate, b: PoseEstimate
            ) -> PoseEstimate:
    """Field-wise torch.where(pred, a, b)."""
    return PoseEstimate(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def _odometry_tail(cfg, ocfg, camera, state, tl_state, depths, codes):
    """Pose GN + window BA + state update."""
    table = tl_state.table
    dev = table.uv.device

    # Landmarks: tracks seen in this and the previous frame with a depth
    # at the previous frame, unprojected at table column 1.
    uv_prev = table.uv[:, 1]
    d_prev = table.depth[:, 1]
    uv_cur = table.uv[:, 0]
    usable = table.active() & (table.length >= 2) & (d_prev > 0)
    rays = camera.viewing_rays(uv_prev)
    rz = torch.clamp(rays[:, 2], min=1e-6)
    lm_prev = rays / rz[:, None] * d_prev[:, None]
    n_usable = usable.sum()

    est = estimate_pose_gn(camera, lm_prev, uv_cur, usable,
                           R_init=state.rel_R, t_init=state.rel_t,
                           iters=ocfg.gn_iters)

    # Retry from identity when the warm start left the GN basin.
    need_retry = ((est.num_inliers < ocfg.min_motion_tracks)
                  | (est.num_inliers.to(torch.float32)
                     < ocfg.retry_inlier_ratio * n_usable)
                  | (est.mean_error > ocfg.retry_max_err))
    run_it = (state.frame_idx % ocfg.ba_every == 0) & (state.frame_idx >= 1)
    # The one host sync of the step: both branch predicates at once.
    retry_host, run_ba_host = torch.stack([need_retry, run_it]).tolist()
    if retry_host:
        est2 = estimate_pose_gn(camera, lm_prev, uv_cur, usable,
                                R_init=torch.eye(3, device=dev),
                                t_init=torch.zeros(3, device=dev),
                                iters=ocfg.gn_iters)
        est = _select(est2.num_inliers > est.num_inliers, est2, est)

    # Acceptance gates: enough inliers, converged residual, plausible
    # translation change (not binding before the first accepted motion).
    gate = torch.clamp(0.5 * norm3(state.rel_t), min=ocfg.accel_gate_m)
    plausible = (~state.motion_ok) | (norm3(est.translation - state.rel_t)
                                      <= gate)
    confident = ((est.num_inliers >= 3 * ocfg.min_motion_tracks)
                 & (est.mean_error <= 0.8))
    enough = ((est.num_inliers >= ocfg.min_motion_tracks)
              & (est.mean_error <= ocfg.accept_max_err)
              & (plausible | confident))
    R_rel = torch.where(enough, est.rotation, state.rel_R)
    t_rel = torch.where(enough, est.translation, state.rel_t)

    # T_cur<-w = T_cur<-prev ∘ T_prev<-w
    R_cw = R_rel @ state.win_R[0]
    t_cw = R_rel @ state.win_t[0] + t_rel

    W = state.win_R.shape[0]
    win_R = torch.cat([R_cw[None], state.win_R[:-1]])
    win_t = torch.cat([t_cw[None], state.win_t[:-1]])
    win_valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           state.win_valid[:-1]])

    # ---- sliding-window BA: landmark l == track slot l, window frame k
    # == table column k.
    cols = torch.arange(W, device=dev)
    obs_mask = (table.active()[None, :]
                & (cols[:, None] < table.length[None, :])
                & win_valid[:, None])
    obs_uv = table.uv[:, :W].transpose(0, 1)  # [W, L, 2]
    dpri = table.depth[:, :W].transpose(0, 1)  # [W, L]
    dmask = obs_mask & (dpri > 0)

    # Landmark init: unproject the newest in-window depth observation.
    first_k = torch.argmax(dmask.to(torch.uint8), dim=0)  # [L]
    any_d = dmask.any(0)
    uv_init = torch.gather(obs_uv, 0, first_k[None, :, None].expand(
        1, -1, 2))[0]
    d_init = torch.gather(dpri, 0, first_k[None, :])[0]
    rays_l = camera.viewing_rays(uv_init)
    lm_cam = rays_l / torch.clamp(rays_l[:, 2:3], min=1e-6) * d_init[:, None]
    lm_world = torch.einsum("lji,lj->li", win_R[first_k],
                            lm_cam - win_t[first_k])  # R^T (p - t)

    if ocfg.persist_landmarks:
        persisted = (state.lm_id == table.track_id) & (state.lm_id >= 0)
        lm_world = torch.where(persisted[:, None], state.lm_world, lm_world)

    lm_valid = table.active() & any_d & (obs_mask.sum(0) >= 2)

    # Gauge: fix the oldest valid pose (and all invalid slots).
    oldest_valid = win_valid.sum() - 1
    problem = BAProblem(
        R=win_R, t=win_t, landmarks=lm_world, obs_uv=obs_uv,
        obs_mask=obs_mask, depth_prior=dpri, depth_mask=dmask,
        fixed=(cols == oldest_valid) | ~win_valid, lm_valid=lm_valid)
    if run_ba_host:
        res = run_ba(camera, problem, iters=ocfg.ba_iters,
                     depth_weight=ocfg.depth_weight, compute_cost=False)
        ba_R, ba_t, ba_lm = (res.problem.R, res.problem.t,
                             res.problem.landmarks)
    else:
        ba_R, ba_t, ba_lm = problem.R, problem.t, problem.landmarks

    if ocfg.persist_landmarks:
        lm_world_out = torch.where(lm_valid[:, None], ba_lm, 0.0)
        lm_id_out = torch.where(lm_valid, table.track_id, -1)
    else:
        lm_world_out, lm_id_out = state.lm_world, state.lm_id

    new_state = OdometryState(
        tracklets=tl_state, win_R=ba_R, win_t=ba_t, win_valid=win_valid,
        frame_idx=state.frame_idx + 1, rel_R=R_rel, rel_t=t_rel,
        lm_world=lm_world_out, lm_id=lm_id_out,
        motion_ok=state.motion_ok | enough)
    diag = torch.stack([n_usable.to(torch.float32),
                        est.num_inliers.to(torch.float32), est.mean_error])
    return new_state, ba_R[0], ba_t[0], diag


def run_odometry(cfg: DepthEstimatorConfig, ocfg: OdometryConfig,
                 camera: PinholeCamera, lidar_to_cam: SE3,
                 frames: list[FrameInput], max_tracks: int = 2048,
                 max_length: int = 12,
                 device: Device = default_device(),
                 ) -> tuple[np.ndarray, list]:
    """Host loop over frames: ([F, 4, 4] world<-cam poses, diagnostics)."""
    state = OdometryState.create(cfg, ocfg, max_tracks, max_length, device)
    poses, diags = [], []
    for frame in frames:
        state, R_cw, t_cw, diag = odometry_step(
            cfg, ocfg, camera, lidar_to_cam, state, frame)
        R_cw = R_cw.cpu().numpy()
        t_cw = t_cw.cpu().numpy()
        T = np.eye(4)
        T[:3, :3] = R_cw.T
        T[:3, 3] = -R_cw.T @ t_cw
        poses.append(T)
        diags.append(diag.cpu().numpy())
    return np.stack(poses), diags
