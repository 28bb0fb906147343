"""The depth association's per-feature cascade as one hand-written CUDA
kernel (csrc/depth_cascade.cu).

`depth_estimator._depth_cascade_plain` is the cascade in plain PyTorch:
the histogram segmentation, the primary plane and its gates, the road
pass and the final select, some 640 launches on a card.  `cascade_cuda`
launches the kernel that computes the same depths, codes and debug
fields, to the bit, in one launch, for CUDA tensors and a configuration
without region growing (`do_use_depth_segmentation`, which keeps the
plain body); it raises on anything else.  `depth_estimator._depth_cascade`
routes between the two: CPU tensors and region growing take the plain
body.

`launches` counts the kernel's launches (a launch captured into a CUDA
graph counts once, at its capture).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels
from ..config import DepthEstimatorConfig
from .geometry import PinholeCamera
from .neighbors import NeighborSet

launches = 0  # cascade_cuda kernel launches since the last reset


def cascade_params(cfg: DepthEstimatorConfig, camera: PinholeCamera,
                   k1: int, k2: int) -> kernels.CascadeParams:
    """The kernel's switches and thresholds for `cfg`; `k1`, `k2` the
    window cells of the primary and road scales (k2 = 0: no road pass).
    A c_float field rounds its Python float to float32 as PyTorch rounds a
    scalar that meets a float32 tensor; the PCA thresholds, compared in
    float64 with `geometry.f32(t)`, are that float32 value."""
    if cfg.plane_estimator_use_mestimator:
        road = 0
    elif cfg.plane_estimator_use_leastsquares:
        road = 1
    else:
        road = 2
    return kernels.CascadeParams(
        k1=k1, k2=k2, count_min=cfg.radiusSearch_count_min,
        use_histogram=cfg.do_use_histogram_segmentation,
        num_bins=cfg.histogram_bins,
        hist_min_count=cfg.histogram_segmentation_min_pointcount,
        bin_width=cfg.histogram_segmentation_bin_witdh,
        use_pca=cfg.do_use_PCA,
        use_triangle=cfg.do_use_triangle_size_maximation,
        check_planar=cfg.do_check_triangleplanar_condition,
        planar_threshold=cfg.triangleplanar_crossnorm_treshold,
        check_ortho=cfg.viewray_plane_orthoganality_treshold > 0,
        ortho_threshold=cfg.viewray_plane_orthoganality_treshold,
        depth_enabled=cfg.treshold_depth_enabled,
        depth_mode=cfg.treshold_depth_mode,
        depth_min=cfg.treshold_depth_min, depth_max=cfg.treshold_depth_max,
        local_enabled=cfg.treshold_depth_local_enabled,
        local_mode=cfg.treshold_depth_local_mode,
        local_relative=cfg.treshold_depth_local_valuetype == 1,
        local_value=cfg.treshold_depth_local_value,
        cut_behind=cfg.do_use_cut_behind_camera,
        pca_abs_min=cfg.pca_treshold_3_abs_min,
        pca_32_rel_max=cfg.pca_treshold_3_2_rel_max,
        pca_21_rel_min=cfg.pca_treshold_2_1_rel_min,
        road_estimator=road, far_veto=cfg.road_any_far_veto,
        far_threshold=cfg.ransac_plane_point_distance_treshold,
        z_x_min=cfg.plane_estimator_z_x_min_relation,
        cx=camera.cx, cy=camera.cy, focal=camera.focal_length,
        collect_debug=cfg.collect_debug)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           dev: torch.device) -> None:
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_window(tag: str, nb: NeighborSet, N: int, dev: torch.device,
                  road: bool) -> int:
    """The window's cell count, after checking its fields."""
    if nb.mask.dim() != 2 or nb.mask.shape[1] < 1:
        raise ValueError(f"{tag}.mask must be [N, K] with K >= 1, got "
                         f"{tuple(nb.mask.shape)}")
    K = nb.mask.shape[1]
    _check(f"{tag}.mask", nb.mask, torch.bool, (N, K), dev)
    _check(f"{tag}.points_cam", nb.points_cam, torch.float32, (N, K, 3), dev)
    _check(f"{tag}.count", nb.count, torch.int32, (N,), dev)
    _check(f"{tag}.z", nb.z, torch.float32, (N, K), dev)
    if road:
        if nb.flags is None:
            raise ValueError(f"{tag}.flags is needed for the road pass")
        _check(f"{tag}.flags", nb.flags, torch.bool, (N, K), dev)
    return K


def check_args(
    cfg: DepthEstimatorConfig,
    nb1: NeighborSet,
    nb2: Optional[NeighborSet],
    features_uv: torch.Tensor,
    features_valid: torch.Tensor,
    gp_coeffs_cam: torch.Tensor,
    gp_ok: torch.Tensor,
) -> tuple[int, int, int]:
    """(N, k1, k2) of a call of `cascade_cuda` whose tensors are what the
    kernel takes, all on features_uv's device: features_uv [N, 2] f32,
    features_valid [N] bool, the windows' fields as the neighbor gather
    makes them (nb2 with its flags when the road pass is on; it is not
    read when it is off, and k2 is 0), the camera-frame plane f32 [4] or
    [N, 4] and gp_ok bool [] or [N], each contiguous; raises on anything
    else."""
    dev = features_uv.device
    if features_uv.dim() != 2 or features_uv.shape[1] != 2:
        raise ValueError(f"features_uv must be [N, 2], got "
                         f"{tuple(features_uv.shape)}")
    N = features_uv.shape[0]
    _check("features_uv", features_uv, torch.float32, (N, 2), dev)
    _check("features_valid", features_valid, torch.bool, (N,), dev)
    k1 = _check_window("nb1", nb1, N, dev, road=False)
    road = cfg.do_use_ransac_plane
    if road and nb2 is None:
        raise ValueError("the road pass needs the road window nb2")
    k2 = _check_window("nb2", nb2, N, dev, road=True) if road else 0
    _check("gp_coeffs_cam", gp_coeffs_cam, torch.float32,
           (N, 4) if gp_coeffs_cam.dim() == 2 else (4,), dev)
    _check("gp_ok", gp_ok, torch.bool, (N,) if gp_ok.dim() == 1 else (), dev)
    return N, k1, k2


def cascade_cuda(
    cfg: DepthEstimatorConfig,
    camera: PinholeCamera,
    nb1: NeighborSet,
    nb2: Optional[NeighborSet],
    features_uv: torch.Tensor,
    features_valid: torch.Tensor,
    gp_coeffs_cam: torch.Tensor,
    gp_ok: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, Optional[tuple]]:
    """(depths [N] f32, codes [N] int32, debug) of the cascade by the
    kernel, one launch on the current stream; `debug` is None, or with
    `cfg.collect_debug` (seg_count, hist_bin, hist_lower, hist_upper,
    corners, road_count) as `DepthDebug` holds them.  Takes CUDA tensors
    as `check_args` describes them; raises on anything else, and on
    region growing."""
    global launches
    if cfg.do_use_depth_segmentation:
        raise ValueError("cascade_cuda has no region growing: "
                         "_depth_cascade_plain runs it")
    dev = features_uv.device
    if dev.type != "cuda":
        raise ValueError(f"cascade_cuda needs CUDA tensors, got {dev}")
    N, k1, k2 = check_args(cfg, nb1, nb2, features_uv, features_valid,
                           gp_coeffs_cam, gp_ok)

    depths = torch.empty(N, dtype=torch.float32, device=dev)
    codes = torch.empty(N, dtype=torch.int32, device=dev)
    debug = None
    if cfg.collect_debug:
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        debug = (torch.empty(N, **i32), torch.empty(N, **i32),
                 torch.empty(N, **f32), torch.empty(N, **f32),
                 torch.empty((N, 3, 3), **f32), torch.empty(N, **i32))
    if N == 0:
        return depths, codes, debug

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    w2 = (nb2.mask, nb2.points_cam, nb2.count, nb2.z, nb2.flags) if k2 \
        else (None,) * 5
    dbg = debug if debug is not None else (None,) * 6
    params = cascade_params(cfg, camera, k1, k2)
    lib = kernels.library("depth_cascade")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mld_depth_cascade(
            features_uv.data_ptr(), features_valid.data_ptr(),
            nb1.mask.data_ptr(), nb1.points_cam.data_ptr(),
            nb1.count.data_ptr(), nb1.z.data_ptr(), *map(ptr, w2),
            gp_coeffs_cam.data_ptr(), 4 if gp_coeffs_cam.dim() == 2 else 0,
            gp_ok.data_ptr(), 1 if gp_ok.dim() == 1 else 0, N,
            depths.data_ptr(), codes.data_ptr(), *map(ptr, dbg),
            ctypes.byref(params), stream)
        kernels.check(lib, code, "depth_cascade kernel launch")
        launches += 1
    return depths, codes, debug
