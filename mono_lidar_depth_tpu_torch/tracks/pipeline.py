"""Per-frame tracklet-depth association step (counterpart of
tracks/pipeline.py).

One call per frame: RANSAC ground plane of the current cloud, track
matching, the fused two-frame depth estimator (previous-frame features
of new tracks against the cached last frame, newest features against
the current frame), and the track-table update.  State is an explicit
NamedTuple passed in and returned.  A frame that carries a semantic label
image takes its ground plane from the road classes instead of RANSAC.  On
a card `process_frame` replays the frame as two CUDA graphs around the
gather (`graphs.Graphed`); `_process_frame_eager` is the same frame op by
op.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Union

import torch

from ..config import DepthEstimatorConfig
from ..core.depth_estimator import (depth_pair_cascade, depth_pair_gather,
                                    estimate_depths_pair, no_ground_plane,
                                    rasterize_cloud)
from ..core.geometry import SE3, PinholeCamera
from ..core.projection import POINT_NOT_DEFINED, FrameCloud
from ..core.ransac import (GroundPlane, RansacDraws, fit_ground_plane_ransac,
                           fit_ground_plane_semantic)
from ..core.result_types import NUM_RESULT_TYPES
from ..device import Device, default_device
from ..graphs import Graphed
from ..obs.timing import span
from .table import TrackTable, match_tracks, update_tracks

# RANSAC randomness of one frame: a generator on the cloud's device, or
# pre-drawn (sub_idx, picks) indices.
RansacRng = Union[torch.Generator, RansacDraws, tuple]


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
    semantic: Optional[torch.Tensor] = None  # [H, W] label image or None


@lru_cache(maxsize=None)
def _intrinsics(camera: PinholeCamera, device: torch.device) -> torch.Tensor:
    """The camera matrix on `device`, made once: building it from a host
    list on every frame would synchronize with the card."""
    return camera.intrinsics(device)


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


def _frame_ground_plane(cfg: DepthEstimatorConfig, camera: PinholeCamera,
                        lidar_to_cam: SE3, cloud: torch.Tensor,
                        cloud_valid: torch.Tensor, rng: RansacRng,
                        semantic: Optional[torch.Tensor]) -> GroundPlane:
    """The ground plane of one cloud: none when the road pass is off, from
    the semantic road classes when the frame carries a label image (the
    reference's 4-way-sync path), else from RANSAC."""
    if not cfg.do_use_ransac_plane:
        return no_ground_plane(cfg.max_points, cloud.device)
    if semantic is not None:
        return fit_ground_plane_semantic(
            cloud, cloud_valid, semantic, lidar_to_cam.rotation,
            lidar_to_cam.translation, _intrinsics(camera, cloud.device),
            ground_labels=cfg.semantic_ground_labels,
            inlier_threshold=cfg.ransac_plane_refinement_treshold)
    return _ground_plane(cfg, cloud, cloud_valid, rng)


def prime_state(cfg: DepthEstimatorConfig, camera: PinholeCamera,
                lidar_to_cam: SE3, state: TrackletDepthState,
                cloud: torch.Tensor, cloud_valid: torch.Tensor,
                key: RansacRng,
                semantic: Optional[torch.Tensor] = None
                ) -> TrackletDepthState:
    """Install a cloud (+ its ground plane, rasterized) as the 'last
    frame' before the first processed frame."""
    gp = _frame_ground_plane(cfg, camera, lidar_to_cam, cloud, cloud_valid,
                             key, semantic)
    frame = rasterize_cloud(cfg, camera, lidar_to_cam, cloud, cloud_valid, gp)
    return state._replace(frame_last=frame, gp_last=gp)


def _front(cfg: DepthEstimatorConfig, camera: PinholeCamera,
           lidar_to_cam: SE3, table: TrackTable, frame: FrameInput):
    """The stages before the neighbor gather: (ground plane, (slot, is_new)
    of `match_tracks`, the rasterized current frame)."""
    with span("assoc.ground_plane"):
        gp = _frame_ground_plane(cfg, camera, lidar_to_cam, frame.cloud,
                                 frame.cloud_valid, frame.rng,
                                 frame.semantic)
    with span("assoc.match_tracks"):
        match = match_tracks(table, frame.ids, frame.ids_valid)
    with span("assoc.rasterize"):
        frame_cur = rasterize_cloud(cfg, camera, lidar_to_cam, frame.cloud,
                                    frame.cloud_valid, gp)
    return gp, match, frame_cur


def _update(table: TrackTable, counters: torch.Tensor, frame: FrameInput,
            match, est_prev, est_new):
    """The table update and the counters after the depth pair: (table,
    counters, depths_new, codes_new)."""
    with span("assoc.update_tracks"):
        table, _ = update_tracks(
            table, frame.ids, frame.ids_valid, frame.uv_new, frame.uv_prev,
            est_new.depths, est_prev.depths, frame.stamp, match=match)
    return (table, counters + est_new.counters + est_prev.counters,
            est_new.depths, est_new.codes)


def _back(cfg: DepthEstimatorConfig, camera: PinholeCamera,
          lidar_to_cam: SE3, nbs, gp: GroundPlane, match, table: TrackTable,
          gp_last: GroundPlane, counters: torch.Tensor, frame: FrameInput):
    """The stages after the neighbor gather, on its neighbor sets `nbs`:
    the depth cascade, then `_update`.  Of the planes it reads `coeffs`
    and `ok`, of the frame its lanes."""
    with span("assoc.depth_pair"):
        est_prev, est_new = depth_pair_cascade(
            cfg, camera, lidar_to_cam, nbs, frame.uv_prev, match[1], gp_last,
            frame.uv_new, frame.ids_valid, gp)
    return _update(table, counters, frame, match, est_prev, est_new)


def _process_frame_eager(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    state: TrackletDepthState,
    frame: FrameInput,
) -> tuple[TrackletDepthState, torch.Tensor, torch.Tensor]:
    """`process_frame` op by op on the host: each stage in a span of
    `obs.timing` (`assoc.frame` the root)."""
    with span("assoc.frame", frame=True):
        gp, match, frame_cur = _front(cfg, camera, lidar_to_cam, state.table,
                                      frame)
        with span("assoc.depth_pair"):
            est_prev, est_new = estimate_depths_pair(
                cfg, camera, lidar_to_cam,
                state.frame_last, frame.uv_prev, match[1], state.gp_last,
                frame_cur, frame.uv_new, frame.ids_valid, gp)
        table, counters, depths, codes = _update(
            state.table, state.counters, frame, match, est_prev, est_new)
    return TrackletDepthState(table, frame_cur, gp, counters), depths, codes


_FRONT = Graphed(_front, "assoc.replay")
_BACK = Graphed(_back, "assoc.replay")


def process_frame(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    state: TrackletDepthState,
    frame: FrameInput,
) -> tuple[TrackletDepthState, torch.Tensor, torch.Tensor]:
    """Process one frame; returns (state', depths_new [M], codes_new [M]).

    Functional: neither `state` nor `frame` is changed, and nothing that
    is returned changes when a later frame runs.

    On a card the frame replays two CUDA graphs (`graphs.Graphed`): the
    front (ground plane, track matching, rasterization), then one eager
    launch of the neighbor gather, then the back (the depth cascade, the
    table update, the counters).  They hold the eager body's kernels in
    its order and are captured once per input signature: the device,
    `cfg`, `camera`, whether `semantic` is given, the kind of `rng`, the
    shape and dtype of every tensor, and the TF32, matmul-precision and
    determinism switches in force.  A segment replays when every tensor
    is on the current CUDA device and no stream capture is running.  The
    frame runs `_process_frame_eager`, the same stages op by op, where
    the depth pair is not the fused one (`do_use_depth_segmentation` or
    `set_all_depths_to_zero` on) or where RANSAC runs (no `semantic`)
    from a generator: only pre-drawn `(sub_idx, picks)` are replayed; an
    `rng` that no stage reads is dropped.  The first frame of a signature
    and every frame off the card run the segments' stages eagerly, each
    in a span of `obs.timing` (`assoc.frame` the root; `assoc.depth_pair`
    holds the cascade, the gather runs between the segments); a replayed
    frame enters only `assoc.frame` and `assoc.replay`."""
    ransac = cfg.do_use_ransac_plane and frame.semantic is None
    if not ransac:
        frame = frame._replace(rng=None)
    if (cfg.do_use_depth_segmentation or cfg.set_all_depths_to_zero
            or (ransac and isinstance(frame.rng, torch.Generator))):
        return _process_frame_eager(cfg, camera, lidar_to_cam, state, frame)
    with span("assoc.frame", frame=True):
        gp, match, frame_cur = _FRONT(cfg, camera, lidar_to_cam, state.table,
                                      frame)
        nbs = depth_pair_gather(cfg, camera, state.frame_last, frame.uv_prev,
                                frame_cur, frame.uv_new)
        table, counters, depths, codes = _BACK(
            cfg, camera, lidar_to_cam, nbs, gp._replace(inlier_mask=None),
            match, state.table, state.gp_last._replace(inlier_mask=None),
            state.counters, frame._replace(cloud=None, cloud_valid=None,
                                           rng=None, semantic=None))
    return TrackletDepthState(table, frame_cur, gp, counters), depths, codes


def process_sequence(cfg: DepthEstimatorConfig, camera: PinholeCamera,
                     lidar_to_cam: SE3, state: TrackletDepthState,
                     frames: FrameInput
                     ) -> tuple[TrackletDepthState, torch.Tensor,
                                torch.Tensor]:
    """`process_frame` over a stacked sequence: every tensor field of
    `frames` has a leading time axis [F, ...]; `rng` is one generator for
    all frames or a stacked `(sub_idx [F, S_sub], picks [F, S, 3])`.
    Returns (final state, depths [F, M], codes [F, M])."""
    F = frames.cloud.shape[0]
    depths, codes = [], []
    for k in range(F):
        rng = frames.rng
        if not isinstance(rng, torch.Generator):
            rng = RansacDraws(rng[0][k], rng[1][k])
        frame = FrameInput(
            cloud=frames.cloud[k], cloud_valid=frames.cloud_valid[k],
            ids=frames.ids[k], ids_valid=frames.ids_valid[k],
            uv_new=frames.uv_new[k], uv_prev=frames.uv_prev[k],
            stamp=frames.stamp[k], rng=rng,
            semantic=None if frames.semantic is None else frames.semantic[k])
        state, d, c = process_frame(cfg, camera, lidar_to_cam, state, frame)
        depths.append(d)
        codes.append(c)
    return state, torch.stack(depths), torch.stack(codes)
