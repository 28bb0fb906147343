"""Typed configuration for the TPU-native depth estimator.

Single validated dataclass replacing the reference's three config tiers
(`monolidar_fusion/include/monolidar_fusion/DepthEstimatorParameters.h:7-173`,
`tracklets_depth/include/tracklets_depth/parameters.h:17-41`, and the
rosinterface_handler `.rosif` files).  Field names follow the reference's
canonical `monolidar_fusion/parameters.yaml` (including its historical
spellings, e.g. ``pixelarea_search_witdh``) so that reference config files
load unchanged; the loader also accepts corrected spellings.

Unlike the reference (silent key mismatches, config/code divergence — see
`DepthEstimatorParameters.h:136`), unknown keys raise, and every value is
validated at construction.

Shape-determining fields (window sizes, histogram bins, pad sizes) are
Python ints consumed at trace time, so one config == one compiled program.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Mapping


# Spelling fixes accepted as aliases for the reference's canonical keys.
_KEY_ALIASES = {
    "do_debug_singleFeatures": "collect_debug",
    "pixelarea_search_width": "pixelarea_search_witdh",
    "histogram_segmentation_bin_width": "histogram_segmentation_bin_witdh",
    "threshold_depth_enabled": "treshold_depth_enabled",
    "threshold_depth_mode": "treshold_depth_mode",
    "threshold_depth_max": "treshold_depth_max",
    "threshold_depth_min": "treshold_depth_min",
    "threshold_depth_local_enabled": "treshold_depth_local_enabled",
    "threshold_depth_local_mode": "treshold_depth_local_mode",
    "threshold_depth_local_valuetype": "treshold_depth_local_valuetype",
    "threshold_depth_local_value": "treshold_depth_local_value",
}

# Reference keys that are accepted but have no effect in the TPU build
# (dead code paths in the reference: kd-tree search, region growing,
# radius search knobs that are never read, debug toggles).
_ACCEPTED_UNUSED = {
    "do_use_nearestNeighborSearch",
    "nnSearch_count",
    "do_use_radiusSearch",
    "radiusSearch_radius",
    "pixelarea_search_offset_x",
    "pixelarea_search_offset_y",
    "pca_debug",
    "do_publish_points",
    "ransac_plane_debug_visualize",
}


@dataclass(frozen=True)
class DepthEstimatorConfig:
    """All knobs of the per-frame depth estimation pipeline.

    Mirrors `DepthEstimatorParameters` (reference
    `DepthEstimatorParameters.h`) plus TPU-build-specific padding /
    precision knobs.  Frozen + hashable so it can be a static jit arg.
    """

    # --- Neighbor search (reference: neighbor_search_mode 0 = pixel grid;
    # mode 1 / kd-tree is dead code in the reference and unsupported here).
    neighbor_search_mode: int = 0
    pixelarea_search_witdh: int = 6
    pixelarea_search_height: int = 9
    radiusSearch_count_min: int = 3

    # --- Histogram segmentation (HistogramPointDepth.cpp:15-123).
    do_use_histogram_segmentation: bool = True
    histogram_segmentation_bin_witdh: float = 0.3
    histogram_segmentation_min_pointcount: int = 3

    # --- Region growing / scan-row depth segmentation.  The reference
    # wires this feature but its code path throws
    # (DepthEstimator.cpp:608); this build implements it
    # (core/row_segmentation.py).  Off by default for reference parity.
    do_use_depth_segmentation: bool = False
    depth_segmentation_max_treshold_gradient: float = 10.0
    depth_segmentation_max_neighbor_distance: float = 0.2
    depth_segmentation_max_neighbor_distance_gradient: float = 0.02
    depth_segmentation_max_seedpoint_to_seedpoint_distance: float = 0.5
    depth_segmentation_max_seedpoint_to_seedpoint_distance_gradient: float = 0.05
    depth_segmentation_max_neighbor_to_seedpoint_distance: float = 0.5
    depth_segmentation_max_neighbor_to_seedpoint_distance_gradient: float = 0.05
    depth_segmentation_max_pointcount: int = 4
    max_scan_rows: int = 128  # static row capacity (Velodyne: 64)
    region_grow_window: int = 32  # static per-row growth window (cells)

    # --- Global depth threshold (TresholdDepthGlobal.cpp:16-36).
    treshold_depth_enabled: bool = True
    treshold_depth_mode: int = 0  # 0 = Dispose, 1 = Adjust
    treshold_depth_max: float = 100.0
    treshold_depth_min: float = 0.0

    # --- Local depth threshold (TresholdDepthLocal.cpp:18-66).
    treshold_depth_local_enabled: bool = True
    treshold_depth_local_mode: int = 0  # 0 = Dispose, 1 = Adjust
    treshold_depth_local_valuetype: int = 1  # 0 = absolute, 1 = relative
    treshold_depth_local_value: float = 0.5

    # --- PCA local-patch classifier (PCA.cpp:21-62), off by default.
    do_use_PCA: bool = False
    pca_treshold_3_abs_min: float = 0.005
    pca_treshold_3_2_rel_max: float = 15.0
    pca_treshold_2_1_rel_min: float = 0.5

    # --- RANSAC ground plane (RansacPlane.cpp:26-155).
    do_use_ransac_plane: bool = True
    ransac_plane_distance_treshold: float = 0.3
    ransac_plane_min_z: float = -10000.0
    ransac_plane_max_z: float = 10000.0
    ransac_plane_max_iterations: int = 10000
    ransac_plane_use_refinement: bool = True
    ransac_plane_refinement_treshold: float = 10.2
    ransac_plane_use_camx_treshold: bool = False
    ransac_plane_treshold_camx: float = 2.0
    ransac_plane_point_distance_treshold: float = 0.2
    ransac_plane_probability: float = 0.999

    # --- Road ("ground plane") depth estimation strategy
    # (RoadDepthEstimator*.cpp); exactly one of the three must be set.
    plane_estimator_use_triangle_maximation: bool = False
    plane_estimator_z_x_min_relation: float = 0.0
    plane_estimator_use_leastsquares: bool = False
    plane_estimator_use_mestimator: bool = True

    # --- Misc gates (DepthEstimator.cpp:903-1037).
    do_use_cut_behind_camera: bool = True
    do_use_triangle_size_maximation: bool = True
    do_check_triangleplanar_condition: bool = True
    triangleplanar_crossnorm_treshold: float = 0.1
    viewray_plane_orthoganality_treshold: float = 0.03
    set_all_depths_to_zero: bool = False
    do_depth_calc_statistics: bool = True

    # --- TPU-build specific (no reference equivalent) -------------------
    # Static padded sizes: one compiled executable per distinct tuple.
    max_points: int = 131072  # padded lidar cloud size (KITTI ~120k)
    max_features: int = 2048  # padded feature count (~2009/frame in logs)
    image_width: int = 1248  # padded KITTI odometry image width
    image_height: int = 384  # padded KITTI odometry image height
    # Histogram: static bin count.  Depths are clamped into the last bin
    # (the reference clamps at 1e10 and uses a per-feature dynamic bin
    # count, Histogram.cpp:29-31; with a static bin range this only
    # differs for points beyond `histogram_max_depth`, which the global
    # depth gate disposes of anyway).  Deliberate, documented deviation.
    histogram_max_depth: float = 150.0
    # Batched RANSAC: number of pre-drawn plane hypotheses.  Replaces the
    # reference's sequential adaptive loop (p=0.999 early exit,
    # RansacPlane.cpp:102-108).  1024 parallel hypotheses give failure
    # probability < 1e-9 for inlier ratios >= 0.25.
    ransac_num_hypotheses: int = 1024
    ransac_subsample_points: int = 6000  # RansacPlane.cpp:32
    ransac_axis_max_angle_deg: float = 10.0  # RansacPlane.cpp:99
    # Pixel-grid collision rule: the reference keeps the FIRST projected
    # point per pixel (scan-order dependent, NeighborFinderPixel.cpp:51-54).
    # "nearest" keeps the point with smallest camera-z per pixel instead —
    # deterministic and order-independent.  "first" reproduces the
    # reference rule (scatter with lowest-index-wins).
    grid_collision_rule: str = "nearest"
    # Fast rasterization: collapse the 4 O(P)-offset scatter/gather
    # streams of the exact rasterizer to ONE scatter-min by carrying
    # the depth inside the scatter key (~2 cm quantization, decoded
    # depth error <= 1 cm) and reconstructing winner positions at cell
    # centers (+-0.5 px -> ~1.4 cm lateral at 20 m).  TPU scatters are
    # latency-bound per OFFSET (DESIGN.md "Rasterization is the new
    # floor"), so this roughly halves frame-ingest time.  Default OFF:
    # the exact path stays bit-pinned by the parity oracles.  Requires
    # grid_collision_rule == "nearest".
    fast_rasterization: bool = False

    # Road-pass neighbor window scales (DepthEstimator.cpp:585).
    road_search_scale_x: float = 2.0
    road_search_scale_y: float = 1.5
    # Reference parity: ANY neighbor farther than
    # ransac_plane_point_distance_treshold from the ground plane vetoes
    # the whole road pass (DepthEstimator.cpp:815-816) even though the
    # plane fit only uses inlier-flagged points — a known reference
    # defect that kills road features whose widened window clips a wall
    # edge.  False = improved mode: off-plane neighbors are trimmed
    # (excluded from the fit, which they already were) instead of
    # vetoing; measured success-rate gain in DESIGN.md.
    road_any_far_veto: bool = True

    # Semantic ground-plane path: road-class label set (the reference
    # hardcodes {6, 7, 8, 9}, tracklet_depth_module.cpp:280 /
    # RansacPlane.h:217); the inlier threshold is
    # ransac_plane_refinement_treshold, as in the reference
    # (tracklet_depth_module.cpp:281-284).
    semantic_ground_labels: tuple = (6, 7, 8, 9)

    # Per-feature forensic record (the reference's do_debug_singleFeatures
    # / DepthCalcStatsSinglePoint): when set, estimate_depths returns a
    # DepthDebug pytree for ALL features.
    collect_debug: bool = False

    def __post_init__(self):
        if self.neighbor_search_mode != 0:
            raise ValueError(
                "neighbor_search_mode must be 0 (pixel grid); the kd-tree "
                "mode is dead code in the reference (NeighborFinderKdd.*.unused)")
        road_modes = (
            self.plane_estimator_use_triangle_maximation
            + self.plane_estimator_use_leastsquares
            + self.plane_estimator_use_mestimator
        )
        if self.do_use_ransac_plane and road_modes != 1:
            raise ValueError(
                "exactly one plane_estimator_use_* mode must be enabled "
                f"(got {road_modes})")
        if self.treshold_depth_mode not in (0, 1):
            raise ValueError("treshold_depth_mode must be 0 (Dispose) or 1 (Adjust)")
        if self.treshold_depth_local_mode not in (0, 1):
            raise ValueError("treshold_depth_local_mode must be 0 or 1")
        if self.treshold_depth_local_valuetype not in (0, 1):
            raise ValueError("treshold_depth_local_valuetype must be 0 (absolute) or 1 (relative)")
        if self.histogram_segmentation_bin_witdh <= 0:
            raise ValueError("histogram bin width must be > 0")
        if self.grid_collision_rule not in ("nearest", "first"):
            raise ValueError("grid_collision_rule must be 'nearest' or 'first'")
        if self.fast_rasterization and self.grid_collision_rule != "nearest":
            raise ValueError(
                "fast_rasterization carries depth in the scatter key and "
                "only implements the 'nearest' collision rule")
        if self.pixelarea_search_witdh <= 0 or self.pixelarea_search_height <= 0:
            raise ValueError("search window must be positive")
        for name in ("max_points", "max_features", "image_width", "image_height",
                     "ransac_num_hypotheses", "ransac_subsample_points"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")

    # ---- derived static shapes -----------------------------------------

    @property
    def histogram_bins(self) -> int:
        """Static bin count covering [0, histogram_max_depth]."""
        return int(math.floor(self.histogram_max_depth / self.histogram_segmentation_bin_witdh)) + 2

    def window_cells(self, scale_x: float = 1.0, scale_y: float = 1.0) -> tuple[int, int]:
        """(rows, cols) upper bound of the search rectangle in grid cells.

        The reference iterates int(v-hy)..int(v+hy) x int(u-hx)..int(u+hx)
        inclusive (NeighborFinderPixel.cpp:69-81); for half-extent h the
        span is at most floor(2h)+2 cells.
        """
        hx = self.pixelarea_search_witdh * 0.5 * scale_x
        hy = self.pixelarea_search_height * 0.5 * scale_y
        return int(math.floor(2.0 * hy)) + 2, int(math.floor(2.0 * hx)) + 2

    @property
    def primary_window(self) -> tuple[int, int]:
        return self.window_cells(1.0, 1.0)

    @property
    def road_window(self) -> tuple[int, int]:
        return self.window_cells(self.road_search_scale_x, self.road_search_scale_y)

    # ---- constructors ---------------------------------------------------

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "DepthEstimatorConfig":
        """Build from a dict of reference-style keys; unknown keys raise."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for key, value in raw.items():
            key = _KEY_ALIASES.get(key, key)
            if key in _ACCEPTED_UNUSED:
                continue
            if key not in fields:
                raise KeyError(f"unknown DepthEstimatorConfig key: {key!r}")
            ftype = fields[key].type
            if ftype == "bool" or isinstance(fields[key].default, bool):
                value = bool(value)
            elif isinstance(fields[key].default, int) and not isinstance(value, bool):
                value = int(value)
            elif isinstance(fields[key].default, float):
                value = float(value)
            kwargs[key] = value
        return cls(**kwargs)

    @classmethod
    def from_yaml(cls, path: str) -> "DepthEstimatorConfig":
        """Load a reference-format parameters.yaml (OpenCV FileStorage
        subset: `%YAML:1.0` header + flat key: value pairs)."""
        import yaml

        with open(path) as f:
            text = f.read()
        # OpenCV FileStorage header '%YAML:1.0' is not valid YAML 1.1.
        lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
        data = yaml.safe_load("\n".join(lines)) or {}
        return cls.from_dict(data)

    def replace(self, **kw) -> "DepthEstimatorConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrackletConfig:
    """Tracklet-table sizing (replaces the reference's unbounded
    std::map tracklet cache, tracklet_depth_module.h:145-152)."""

    max_tracks: int = 4096  # ring-buffer capacity (track slots)
    max_track_length: int = 36  # per-track frame window kept

    def __post_init__(self):
        if self.max_tracks <= 0 or self.max_track_length < 2:
            raise ValueError("invalid tracklet table size")
