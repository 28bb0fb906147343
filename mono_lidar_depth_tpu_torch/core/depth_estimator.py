"""The fused per-frame depth-estimation pipeline (counterpart of
core/depth_estimator.py).

Every branch of the reference's per-feature state machine runs for all
features as masked lanes, and (code, depth) is a select cascade with
the reference's precedence; see the JAX module for the stage list and
the documented deviations.  With region growing
(`do_use_depth_segmentation=True`) the gather also returns the index
plane, from which the cascade takes each feature's seed point.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DepthEstimatorConfig
from ..device import Device, default_device
from ..obs.stats import count_codes
from .geometry import (SE3, PinholeCamera, dot3, plane_from_points,
                       point_plane_distance, ray_plane_intersection)
from .histogram import filter_points_min_dist_blob, nearest_point
from .neighbors import NeighborSet, gather_neighbors_frames
from .planefit import (check_planar, check_xz_flatness, first_three_points,
                       least_squares_plane, max_spanning_triangle,
                       mestimator_plane, pca_classify)
from .projection import FrameCloud, build_frame_cloud
from .ransac import GroundPlane
from .result_types import DepthResultType as R
from .row_segmentation import grow_regions, segment_rows


class DepthDebug(NamedTuple):
    """Per-feature forensic record (cfg.collect_debug)."""

    neighbor_count: torch.Tensor  # [N]
    seg_count: torch.Tensor  # [N]
    hist_bin: torch.Tensor  # [N]
    hist_lower: torch.Tensor  # [N]
    hist_upper: torch.Tensor  # [N]
    corners: torch.Tensor  # [N, 3, 3]
    road_count: torch.Tensor  # [N]


class DepthEstimate(NamedTuple):
    depths: torch.Tensor  # [N] depth, -1 on failure
    codes: torch.Tensor  # [N] int32 DepthResultType
    counters: torch.Tensor  # [NUM_RESULT_TYPES] int32
    debug: Optional[DepthDebug] = None


def no_ground_plane(max_points: int, device: Device = default_device()
                    ) -> GroundPlane:
    """Placeholder plane (ok == False disables the road pass)."""
    return GroundPlane(
        coeffs=torch.tensor([0.0, 0.0, 1.0, 0.0], device=device),
        inlier_mask=torch.zeros(max_points, dtype=torch.bool, device=device),
        ok=torch.zeros((), dtype=torch.bool, device=device))


def _all_zero_depths(features_valid: torch.Tensor) -> DepthEstimate:
    """cfg.set_all_depths_to_zero (DepthEstimator.cpp:448-453)."""
    codes = torch.where(features_valid, int(R.Success),
                        int(R.Unspecified)).to(torch.int32)
    return DepthEstimate(
        depths=torch.full(features_valid.shape, -1.0,
                          device=features_valid.device),
        codes=codes, counters=count_codes(codes, features_valid))


def estimate_depths(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    cloud_lidar: torch.Tensor,
    cloud_valid: torch.Tensor,
    features_uv: torch.Tensor,
    features_valid: torch.Tensor,
    ground_plane: Optional[GroundPlane] = None,
) -> DepthEstimate:
    """A metric depth for every feature [N, 2] against a lidar cloud."""
    if ground_plane is None:
        ground_plane = no_ground_plane(cloud_lidar.shape[0],
                                       cloud_lidar.device)
    if cfg.set_all_depths_to_zero:
        return _all_zero_depths(features_valid)
    frame = rasterize_cloud(cfg, camera, lidar_to_cam, cloud_lidar,
                            cloud_valid, ground_plane)
    return estimate_depths_from_frame(cfg, camera, lidar_to_cam, frame,
                                      features_uv, features_valid,
                                      ground_plane)


def rasterize_cloud(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    cloud_lidar: torch.Tensor,
    cloud_valid: torch.Tensor,
    ground_plane: GroundPlane,
) -> FrameCloud:
    """Frame ingest: transform + project + rasterize one cloud; the
    ground-inlier mask rides in the z plane's sign bit."""
    flags = ground_plane.inlier_mask if cfg.do_use_ransac_plane else None
    return build_frame_cloud(
        cloud_lidar, cloud_valid, lidar_to_cam, camera,
        cfg.image_height, cfg.image_width, cfg.grid_collision_rule,
        point_flags=flags, fast=cfg.fast_rasterization)


def plane_to_camera(lidar_to_cam: SE3, coeffs: torch.Tensor) -> torch.Tensor:
    """Lidar-frame plane [a, b, c, d] -> camera frame, in float64 and
    rounded once (the rule of `geometry.f32`)."""
    c = coeffs.double()
    n_c = dot3(lidar_to_cam.rotation.double(), c[:3])
    d_c = c[3] - dot3(n_c, lidar_to_cam.translation.double())
    return torch.cat([n_c, d_c[None]]).to(coeffs.dtype)


def _gather_two_scales(cfg, camera, frames, uvs):
    """Window gathers for both search scales (primary + road retry) over
    the features of all `frames`, joined in one lane order: one kernel
    launch on the card.  Region growing needs the neighbors' raw point
    indices, so it asks for the index plane."""
    hx = cfg.pixelarea_search_witdh * 0.5
    hy = cfg.pixelarea_search_height * 0.5
    scales = [(hx, hy, cfg.primary_window)]
    if cfg.do_use_ransac_plane:
        scales.append((hx * cfg.road_search_scale_x,
                       hy * cfg.road_search_scale_y, cfg.road_window))
    nbs = gather_neighbors_frames(frames, uvs, camera, scales,
                                  with_indices=cfg.do_use_depth_segmentation)
    return nbs[0], (nbs[1] if cfg.do_use_ransac_plane else None)


def estimate_depths_from_frame(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    frame: FrameCloud,
    features_uv: torch.Tensor,
    features_valid: torch.Tensor,
    ground_plane: GroundPlane,
) -> DepthEstimate:
    """Depths against a frame rasterized with the SAME ground plane."""
    if cfg.set_all_depths_to_zero:
        return _all_zero_depths(features_valid)
    nb1, nb2 = _gather_two_scales(cfg, camera, [frame], [features_uv])
    return _depth_cascade(
        cfg, camera, nb1, nb2, features_uv, features_valid,
        plane_to_camera(lidar_to_cam, ground_plane.coeffs), ground_plane.ok,
        frame=frame)


def estimate_depths_pair(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    lidar_to_cam: SE3,
    frame_a: FrameCloud,
    uv_a: torch.Tensor,
    valid_a: torch.Tensor,
    gp_a: GroundPlane,
    frame_b: FrameCloud,
    uv_b: torch.Tensor,
    valid_b: torch.Tensor,
    gp_b: GroundPlane,
) -> tuple[DepthEstimate, DepthEstimate]:
    """Two feature sets against two frames in one fused cascade: one
    gather over both frames and both scales (one kernel launch), then
    everything downstream once over the [Na + Nb] lanes.  Region growing
    is frame-local (the row segmentation of each cloud), so in that
    configuration the two frames run as two separate passes: two
    launches."""
    if cfg.set_all_depths_to_zero:
        return _all_zero_depths(valid_a), _all_zero_depths(valid_b)
    if cfg.do_use_depth_segmentation:
        return (estimate_depths_from_frame(cfg, camera, lidar_to_cam,
                                           frame_a, uv_a, valid_a, gp_a),
                estimate_depths_from_frame(cfg, camera, lidar_to_cam,
                                           frame_b, uv_b, valid_b, gp_b))

    Na, Nb = uv_a.shape[0], uv_b.shape[0]
    nb1, nb2 = _gather_two_scales(cfg, camera, [frame_a, frame_b],
                                  [uv_a, uv_b])
    uv = torch.cat([uv_a, uv_b])
    valid = torch.cat([valid_a, valid_b])
    coeffs = torch.cat([
        plane_to_camera(lidar_to_cam, gp_a.coeffs).expand(Na, 4),
        plane_to_camera(lidar_to_cam, gp_b.coeffs).expand(Nb, 4)])
    gp_ok = torch.cat([gp_a.ok.expand(Na), gp_b.ok.expand(Nb)])
    est = _depth_cascade(cfg, camera, nb1, nb2, uv, valid, coeffs, gp_ok)

    def part(sl: slice, v: torch.Tensor) -> DepthEstimate:
        codes = est.codes[sl]
        debug = (None if est.debug is None
                 else DepthDebug(*(x[sl] for x in est.debug)))
        return DepthEstimate(depths=est.depths[sl], codes=codes,
                             counters=count_codes(codes, v), debug=debug)

    return part(slice(0, Na), valid_a), part(slice(Na, Na + Nb), valid_b)


def _depth_cascade(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    nb1: NeighborSet,
    nb2: Optional[NeighborSet],
    features_uv: torch.Tensor,
    features_valid: torch.Tensor,
    gp_coeffs_cam: torch.Tensor,  # [4] or [N, 4] camera-frame plane
    gp_ok: torch.Tensor,  # [] or [N]
    frame: Optional[FrameCloud] = None,
) -> DepthEstimate:
    """The per-feature select cascade given gathered neighbor windows.
    `frame` is only needed for the region-growing branch."""
    N = features_uv.shape[0]
    dev = features_uv.device

    ray_dir = camera.viewing_rays(features_uv.to(torch.float32))
    ray_dir = torch.where(ray_dir[..., 2:3] < 0, -ray_dir, ray_dir)
    ray_origin = torch.zeros_like(ray_dir)

    enough1 = nb1.count >= cfg.radiusSearch_count_min

    if cfg.do_use_histogram_segmentation:
        hist = filter_points_min_dist_blob(
            nb1.z, nb1.mask, cfg.histogram_segmentation_bin_witdh,
            cfg.histogram_segmentation_min_pointcount, cfg.histogram_bins)
        seg_mask, hist_found = hist.seg_mask, hist.found
    else:  # DepthEstimator.cpp:762-764: use all neighbors
        seg_mask = nb1.mask
        hist_found = torch.ones(N, dtype=torch.bool, device=dev)

    depth_p, code_p, corners_p = _segment_depth(
        cfg, nb1.points_cam, seg_mask, ray_dir, ray_origin,
        check_planar_enabled=cfg.do_check_triangleplanar_condition)
    code_p = torch.where(hist_found, code_p, int(R.HistogramNoLocalMax))
    code_p = torch.where(enough1, code_p,
                         int(R.RadiusSearchInsufficientPoints))

    primary_success = code_p == int(R.Success)
    depth_primary = torch.where(primary_success, depth_p, -1.0)

    # ---- region growing (DepthEstimator.cpp:513-558): the seed is the
    # minimum-depth window neighbor; no seed and a seed beyond the global
    # maximum are hard returns; a successful grow + segment depth wins over
    # the primary path; any other region failure falls through to it.
    if cfg.do_use_depth_segmentation:
        rows = segment_rows(frame, cfg.max_scan_rows)
        seed_k, has_any = nearest_point(nb1.z, nb1.mask)
        seed_k = seed_k.long()[:, None]
        seed_raw = torch.gather(nb1.indices, 1, seed_k)[:, 0]
        seed_z = torch.gather(nb1.z, 1, seed_k)[:, 0]
        seed_in_range = seed_z <= cfg.treshold_depth_max
        grow = grow_regions(
            rows, seed_raw, has_any & seed_in_range, features_uv,
            max_dist_threshold=cfg.depth_segmentation_max_treshold_gradient,
            seed_to_seed_start=cfg.depth_segmentation_max_seedpoint_to_seedpoint_distance,
            seed_to_seed_gradient=cfg.depth_segmentation_max_seedpoint_to_seedpoint_distance_gradient,
            neighbor_to_seed_start=cfg.depth_segmentation_max_neighbor_to_seedpoint_distance,
            neighbor_to_seed_gradient=cfg.depth_segmentation_max_neighbor_to_seedpoint_distance_gradient,
            neighbor_start=cfg.depth_segmentation_max_neighbor_distance,
            neighbor_gradient=cfg.depth_segmentation_max_neighbor_distance_gradient,
            max_pointcount=cfg.depth_segmentation_max_pointcount,
            window=cfg.region_grow_window)
        safe_raw = torch.clamp(grow.raw_indices, 0,
                               frame.points_cam.shape[0] - 1).long()
        rg_points = torch.where(grow.mask[..., None],
                                frame.points_cam[safe_raw], 0.0)
        # no planarity check on the region path (DepthEstimator.cpp:551)
        depth_rg, code_rg, _ = _segment_depth(
            cfg, rg_points, grow.mask, ray_dir, ray_origin,
            check_planar_enabled=False)
        rg_success = ((grow.status == 1) & (code_rg == int(R.Success))
                      & enough1)
        code_p = torch.where(rg_success, int(R.SuccessRegionGrowing), code_p)
        depth_primary = torch.where(rg_success, depth_rg, depth_primary)
        no_seed = enough1 & ~has_any
        too_deep = enough1 & has_any & ~seed_in_range
        code_p = torch.where(no_seed, int(R.HistogramNoLocalMax), code_p)
        code_p = torch.where(too_deep,
                             int(R.TresholdDepthGlobalGreaterMax), code_p)
        depth_primary = torch.where(no_seed | too_deep, -1.0, depth_primary)
        # the hard returns also skip the road fallback
        primary_success = ((code_p == int(R.Success))
                           | (code_p == int(R.SuccessRegionGrowing))
                           | no_seed | too_deep)

    if cfg.do_use_ransac_plane:
        code_f, depth_f, road_count = _road_pass(
            cfg, nb2, ray_origin, ray_dir, gp_coeffs_cam, gp_ok,
            code_p, depth_primary, enough1, primary_success)
    else:
        code_f, depth_f = code_p, depth_primary
        road_count = torch.zeros(N, dtype=torch.int64, device=dev)

    code_f = torch.where(features_valid, code_f, int(R.Unspecified))
    depth_f = torch.where(features_valid, depth_f, -1.0)
    debug = None
    if cfg.collect_debug:
        if cfg.do_use_histogram_segmentation:
            h_bin, h_lo, h_hi = hist.bin_id, hist.lower, hist.upper
        else:
            h_bin = torch.full((N,), -1, dtype=torch.int32, device=dev)
            h_lo = torch.full((N,), -1.0, device=dev)
            h_hi = torch.full((N,), -1.0, device=dev)
        debug = DepthDebug(
            neighbor_count=nb1.count,
            seg_count=seg_mask.sum(-1).to(torch.int32),
            hist_bin=h_bin, hist_lower=h_lo, hist_upper=h_hi,
            corners=corners_p, road_count=road_count.to(torch.int32))
    return DepthEstimate(depths=depth_f, codes=code_f,
                         counters=count_codes(code_f, features_valid),
                         debug=debug)


def _segment_depth(cfg, points, seg_mask, ray_dir, ray_origin,
                   check_planar_enabled: bool):
    """Depth from a segmented point set — CalculateDepthSegmented as a
    select cascade.  Returns (depth [N], code [N] int32, corners)."""
    N = ray_dir.shape[0]
    dev = ray_dir.device
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    if (not cfg.do_use_PCA) and cfg.do_use_triangle_size_maximation:
        tri = max_spanning_triangle(points, seg_mask)
        tri_fail_code = int(R.TriangleNotPlanarInsufficientPoints)
    else:
        tri = first_three_points(points, seg_mask)
        tri_fail_code = int(R.HistogramNoLocalMax)  # DepthEstimator.cpp:920

    if (not cfg.do_use_PCA) and check_planar_enabled:
        planar_ok = check_planar(tri.corners,
                                 cfg.triangleplanar_crossnorm_treshold)
    else:
        planar_ok = ones

    if cfg.do_use_PCA:
        pca = pca_classify(points, seg_mask, cfg.pca_treshold_3_abs_min,
                           cfg.pca_treshold_3_2_rel_max,
                           cfg.pca_treshold_2_1_rel_min)
        n_unit = pca.normal
        offset = -dot3(n_unit, pca.anchor)
    else:
        n_unit, offset = plane_from_points(
            tri.corners[:, 0], tri.corners[:, 1], tri.corners[:, 2])

    cosang = torch.abs(dot3(n_unit, ray_dir))
    if cfg.viewray_plane_orthoganality_treshold > 0:
        ortho_ok = cosang >= cfg.viewray_plane_orthoganality_treshold
    else:
        ortho_ok = ones

    _, depth = ray_plane_intersection(n_unit, offset, ray_origin, ray_dir)
    depth, gate_code = _apply_depth_gates(cfg, depth, points[..., 2],
                                          seg_mask)

    # The FIRST failure in the reference's order wins: apply overrides
    # lowest-precedence first.
    code = torch.full((N,), int(R.Success), dtype=torch.int32, device=dev)
    code = torch.where(gate_code != 0, gate_code, code)
    code = torch.where(ortho_ok, code, int(R.PlaneViewrayNotOrthogonal))
    if cfg.do_use_PCA:
        code = torch.where(pca.is_cubic, int(R.PcaIsCubic), code)
        code = torch.where(pca.is_linear, int(R.PcaIsLine), code)
        code = torch.where(pca.is_point, int(R.PcaIsPoint), code)
    else:
        code = torch.where(planar_ok, code, int(R.TriangleNotPlanar))
    code = torch.where(tri.ok, code, tri_fail_code)
    return depth, code, tri.corners


def _road_pass(cfg, nb2, ray_origin, ray_dir, gp_coeffs_cam, gp_ok,
               code_p, depth_primary, enough1, primary_success):
    """Road-feature fallback against the ground plane, transformed once
    into the camera frame (point-plane distance is rigid-invariant)."""
    N = ray_dir.shape[0]
    enough2 = nb2.count >= cfg.radiusSearch_count_min

    coeffs_cam = gp_coeffs_cam
    if coeffs_cam.dim() == 2:
        coeffs_cam = coeffs_cam[:, None, :]  # [N, 1, 4] vs points [N, K, 3]
    gp_dist = point_plane_distance(nb2.points_cam, coeffs_cam)
    any_far = (nb2.mask & (gp_dist > cfg.ransac_plane_point_distance_treshold)
               ).any(-1)

    road_mask = nb2.mask & nb2.flags
    road_count = road_mask.sum(-1)
    if cfg.road_any_far_veto:
        # Reference parity (DepthEstimator.cpp:815-816): any far
        # neighbor vetoes the whole road pass.
        road_seg_ok = ~any_far & (road_count >= 3)
    else:
        road_seg_ok = road_count >= 3

    if cfg.plane_estimator_use_mestimator:
        fit = mestimator_plane(nb2.points_cam, road_mask, prior_dist=gp_dist)
        road_normal, road_anchor = fit.normal, fit.anchor
    elif cfg.plane_estimator_use_leastsquares:
        ls = least_squares_plane(nb2.points_cam, road_mask)
        road_normal, road_anchor = ls.normal, ls.anchor
    else:  # RoadDepthEstimatorMaxSpanningTriangle.cpp:24-40
        rtri = max_spanning_triangle(nb2.points_cam, road_mask)
        road_normal, _ = plane_from_points(
            rtri.corners[:, 0], rtri.corners[:, 1], rtri.corners[:, 2])
        flat_ok = check_xz_flatness(nb2.points_cam, road_mask,
                                    cfg.plane_estimator_z_x_min_relation)
        road_anchor = rtri.corners[:, 0]

    road_offset = -dot3(road_normal, road_anchor)
    _, depth_r = ray_plane_intersection(road_normal, road_offset,
                                        ray_origin, ray_dir)
    depth_r, gate_code_r = _apply_depth_gates(cfg, depth_r, nb2.z, road_mask)

    code_r = torch.where(gate_code_r != 0, gate_code_r, int(R.SuccessRoad))
    if cfg.plane_estimator_use_triangle_maximation:
        code_r = torch.where(flat_ok, code_r, int(R.InsufficientRoadPoints))
        code_r = torch.where(rtri.ok, code_r,
                             int(R.RadiusSearchInsufficientPoints))
    depth_r = torch.where(code_r == int(R.SuccessRoad), depth_r, -1.0)

    # The road pass runs when the primary pass got past the neighbor
    # check but did not succeed, and a ground plane exists.
    road_applicable = gp_ok & enough1 & ~primary_success
    code = torch.where(
        road_applicable,
        torch.where(enough2, torch.where(road_seg_ok, code_r, code_p),
                    int(R.RadiusSearchInsufficientPoints)),
        code_p)
    depth = torch.where(road_applicable,
                        torch.where(enough2 & road_seg_ok, depth_r, -1.0),
                        depth_primary)
    return code, depth, road_count


def _apply_depth_gates(cfg: DepthEstimatorConfig, depth, neighbor_depths,
                       seg_mask):
    """Global + local threshold gates + behind-camera check, in the
    order of CalculateDepthSegmented.  Returns (depth, code; 0 = pass)."""
    code = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)

    if cfg.treshold_depth_enabled:
        below = depth < cfg.treshold_depth_min
        above = depth > cfg.treshold_depth_max
        if cfg.treshold_depth_mode == 0:  # Dispose
            code = torch.where(above & (code == 0),
                               int(R.TresholdDepthGlobalGreaterMax), code)
            code = torch.where(below & (code == 0),
                               int(R.TresholdDepthGlobalSmallerMin), code)
        else:  # Adjust
            depth = torch.clamp(depth, cfg.treshold_depth_min,
                                cfg.treshold_depth_max)

    if cfg.treshold_depth_local_enabled:
        inf = float("inf")
        min_z = torch.where(seg_mask, neighbor_depths, inf).amin(-1)
        max_z = torch.where(seg_mask, neighbor_depths, -inf).amax(-1)
        interval = max_z - min_z
        if cfg.treshold_depth_local_valuetype == 1:  # relative
            tol = interval * cfg.treshold_depth_local_value
        else:
            tol = torch.full_like(interval, cfg.treshold_depth_local_value)
        lo = min_z - tol
        hi = max_z + tol
        has_pts = seg_mask.any(-1)
        if cfg.treshold_depth_local_mode == 0:  # Dispose
            code = torch.where(has_pts & (depth < lo) & (code == 0),
                               int(R.TresholdDepthLocalSmallerMin), code)
            code = torch.where(has_pts & (depth > hi) & (code == 0),
                               int(R.TresholdDepthLocalGreaterMax), code)
        else:
            depth = torch.where(has_pts, torch.clamp(depth, lo, hi), depth)

    if cfg.do_use_cut_behind_camera:
        code = torch.where((depth < 0) & (code == 0),
                           int(R.CornerBehindCamera), code)
    return depth, code
