"""Per-frame tracklet-depth association step (counterpart of
tracks/pipeline.py).

One call per frame: RANSAC ground plane of the current cloud, track
matching, the fused two-frame depth estimator (previous-frame features
of new tracks against the cached last frame, newest features against
the current frame), and the track-table update.  State is an explicit
NamedTuple passed in and returned.

The semantic ground plane (a `FrameInput` with `semantic` set) is not
ported yet and raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..config import DepthEstimatorConfig
from ..core.depth_estimator import (estimate_depths_pair, no_ground_plane,
                                    rasterize_cloud)
from ..core.geometry import SE3, PinholeCamera
from ..core.projection import POINT_NOT_DEFINED, FrameCloud
from ..core.ransac import GroundPlane, RansacDraws, fit_ground_plane_ransac
from ..core.result_types import NUM_RESULT_TYPES
from ..device import Device, default_device
from .table import TrackTable, match_tracks, update_tracks

# RANSAC randomness of one frame: a generator on the cloud's device, or
# pre-drawn (sub_idx, picks) indices.
RansacRng = Union[torch.Generator, RansacDraws, tuple]

_NO_SEMANTIC = ("the semantic ground plane (FrameInput.semantic / "
                "fit_ground_plane_semantic) is not ported yet")


def _empty_frame_cloud(cfg: DepthEstimatorConfig,
                       device: torch.device | str) -> FrameCloud:
    """All-invalid rasterized frame (cold-start 'last frame')."""
    P, H, W = cfg.max_points, cfg.image_height, cfg.image_width
    return FrameCloud(
        points_lidar=torch.zeros((P, 3), device=device),
        points_cam=torch.zeros((P, 3), device=device),
        uv=torch.zeros((P, 2), device=device),
        valid=torch.zeros(P, dtype=torch.bool, device=device),
        visible=torch.zeros(P, dtype=torch.bool, device=device),
        grid=torch.full((H, W), POINT_NOT_DEFINED, dtype=torch.int32,
                        device=device),
        planes=torch.zeros((2, H, W), device=device),
        winner_flat=torch.full((P,), H * W, dtype=torch.int32,
                               device=device),
    )


class TrackletDepthState(NamedTuple):
    """Cross-frame state: track table, the last frame (rasterized), its
    ground plane and the accumulated outcome counters."""

    table: TrackTable
    frame_last: FrameCloud
    gp_last: GroundPlane
    counters: torch.Tensor  # [NUM_RESULT_TYPES] int32

    @classmethod
    def create(cls, cfg: DepthEstimatorConfig, max_tracks: int,
               max_length: int, device: Device = default_device()
               ) -> "TrackletDepthState":
        return cls(
            table=TrackTable.create(max_tracks, max_length, device),
            frame_last=_empty_frame_cloud(cfg, device),
            gp_last=no_ground_plane(cfg.max_points, device),
            counters=torch.zeros(NUM_RESULT_TYPES, dtype=torch.int32,
                                 device=device),
        )


class FrameInput(NamedTuple):
    """One synchronized frame."""

    cloud: torch.Tensor  # [P, 3] lidar-frame points
    cloud_valid: torch.Tensor  # [P] bool
    ids: torch.Tensor  # [M] int32 track ids
    ids_valid: torch.Tensor  # [M] bool
    uv_new: torch.Tensor  # [M, 2] newest feature per track
    uv_prev: torch.Tensor  # [M, 2] previous-frame feature per track
    stamp: torch.Tensor  # [] time
    rng: RansacRng  # RANSAC generator or pre-drawn (sub_idx, picks)
    semantic: Optional[torch.Tensor] = None  # not ported: must be None


def _ground_plane(cfg: DepthEstimatorConfig, cloud: torch.Tensor,
                  cloud_valid: torch.Tensor, rng: RansacRng
                  ) -> GroundPlane:
    if isinstance(rng, torch.Generator):
        generator, sub_idx, picks = rng, None, None
    else:
        generator, (sub_idx, picks) = None, rng
    return fit_ground_plane_ransac(
        cloud, cloud_valid, generator, sub_idx=sub_idx, picks=picks,
        distance_threshold=cfg.ransac_plane_distance_treshold,
        min_z=cfg.ransac_plane_min_z, max_z=cfg.ransac_plane_max_z,
        num_hypotheses=cfg.ransac_num_hypotheses,
        subsample=cfg.ransac_subsample_points,
        axis_max_angle_deg=cfg.ransac_axis_max_angle_deg,
        use_refinement=cfg.ransac_plane_use_refinement,
        refinement_threshold=cfg.ransac_plane_refinement_treshold)


def prime_state(cfg: DepthEstimatorConfig, camera: PinholeCamera,
                lidar_to_cam: SE3, state: TrackletDepthState,
                cloud: torch.Tensor, cloud_valid: torch.Tensor,
                key: RansacRng,
                semantic: Optional[torch.Tensor] = None
                ) -> TrackletDepthState:
    """Install a cloud (+ its ground plane, rasterized) as the 'last
    frame' before the first processed frame."""
    if semantic is not None:
        raise NotImplementedError(_NO_SEMANTIC)
    if cfg.do_use_ransac_plane:
        gp = _ground_plane(cfg, cloud, cloud_valid, key)
    else:
        gp = no_ground_plane(cfg.max_points, cloud.device)
    frame = rasterize_cloud(cfg, camera, lidar_to_cam, cloud, cloud_valid, gp)
    return state._replace(frame_last=frame, gp_last=gp)


def process_frame(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    state: TrackletDepthState,
    frame: FrameInput,
) -> tuple[TrackletDepthState, torch.Tensor, torch.Tensor]:
    """Process one frame; returns (state', depths_new [M], codes_new [M])."""
    if frame.semantic is not None:
        raise NotImplementedError(_NO_SEMANTIC)
    if cfg.do_use_ransac_plane:
        gp = _ground_plane(cfg, frame.cloud, frame.cloud_valid, frame.rng)
    else:
        gp = no_ground_plane(cfg.max_points, frame.cloud.device)

    slot_exist, is_new = match_tracks(state.table, frame.ids, frame.ids_valid)
    frame_cur = rasterize_cloud(cfg, camera, lidar_to_cam, frame.cloud,
                                frame.cloud_valid, gp)
    est_prev, est_new = estimate_depths_pair(
        cfg, camera, lidar_to_cam,
        state.frame_last, frame.uv_prev, is_new, state.gp_last,
        frame_cur, frame.uv_new, frame.ids_valid, gp)
    table, _ = update_tracks(
        state.table, frame.ids, frame.ids_valid, frame.uv_new,
        frame.uv_prev, est_new.depths, est_prev.depths, frame.stamp,
        match=(slot_exist, is_new))
    new_state = TrackletDepthState(
        table=table, frame_last=frame_cur, gp_last=gp,
        counters=state.counters + est_new.counters + est_prev.counters)
    return new_state, est_new.depths, est_new.codes
