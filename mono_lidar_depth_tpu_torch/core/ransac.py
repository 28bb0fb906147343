"""Batched RANSAC ground plane (counterpart of core/ransac.py).

S pre-drawn 3-point hypotheses are scored at once: residuals over the
subsample are one [S_sub, S] float64 product, the best hypothesis is
the argmax inlier count, and an LS refit refines it.  The residuals, the
refit and the semantic plane's projection and distances run in float64
from the float32 points, sum in the order of `geometry.sum_sorted` and
round to float32 once, at the coefficients (the rule of `geometry.f32`).
The random draws come from a `torch.Generator`; `jax.random` streams
cannot be reproduced in PyTorch, so callers (the parity tests) may
inject the subsample indices and the hypothesis picks instead.

`fit_ground_plane_semantic` takes the ground from a semantic label image
instead: no random draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .geometry import (cross3, dot3, f32, norm3, smallest_eigenvector_sym3x3,
                       sum_sorted)
from .planefit import _scatter3, _wsum


class GroundPlane(NamedTuple):
    """Ground-plane estimate in the lidar frame."""

    coeffs: torch.Tensor  # [4] (a, b, c, d), |n| = 1
    inlier_mask: torch.Tensor  # [P] bool over the raw cloud
    ok: torch.Tensor  # [] bool


class RansacDraws(NamedTuple):
    """Pre-drawn RANSAC randomness."""

    sub_idx: torch.Tensor  # [S_sub] int indices into the cloud
    picks: torch.Tensor  # [S, 3] int indices into the subsample


def draw_ransac(valid: torch.Tensor, generator: torch.Generator,
                num_hypotheses: int, subsample: int) -> RansacDraws:
    """Uniform subsample indices over the valid prefix (with
    replacement) and hypothesis picks, without a host sync."""
    dev = valid.device
    n = torch.clamp(valid.sum(), min=1)
    u = torch.rand(subsample, generator=generator, device=dev)
    sub_idx = torch.minimum((u * n).long(), n - 1)
    picks = torch.randint(0, subsample, (num_hypotheses, 3),
                          generator=generator, device=dev)
    return RansacDraws(sub_idx, picks)


def _ls_plane(points: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted LS plane through weighted points -> coeffs [4], fitted
    in float64 and rounded to the points' float32."""
    p, w = points.double(), w.double()
    wsum = sum_sorted(w)
    c = _wsum(w, p) / torch.where(wsum == 0, 1.0, wsum)
    centered = (p - c) * torch.sqrt(w)[:, None]
    n = smallest_eigenvector_sym3x3(_scatter3(centered[None])[0])
    return torch.cat([n, -dot3(n, c)[None]]).to(points.dtype)


def _plane_dist(points: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """|n·p + d| in float64 for points [..., 3] and coeffs [4]."""
    c = coeffs.double()
    return torch.abs(dot3(points.double(), c[:3]) + c[3])


def fit_ground_plane_ransac(
    points_lidar: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    sub_idx: torch.Tensor | None = None,
    picks: torch.Tensor | None = None,
    distance_threshold: float = 0.3,
    min_z: float = -10000.0,
    max_z: float = 10000.0,
    num_hypotheses: int = 1024,
    subsample: int = 6000,
    axis_max_angle_deg: float = 10.0,
    use_refinement: bool = True,
    refinement_threshold: float = 10.2,
    inliers_from_full_cloud: bool = False,
) -> GroundPlane:
    """Fit the ground plane to a lidar cloud [P, 3] with batched RANSAC.

    The draws come from `generator`, unless both `sub_idx` [subsample]
    and `picks` [num_hypotheses, 3] are given."""
    P = points_lidar.shape[0]
    pts = points_lidar.to(torch.float32)

    zmask = valid
    if min_z > -1001.0:  # pass-through filter, RansacPlane.cpp:58-64
        zmask = zmask & (points_lidar[:, 2] > min_z) & (
            points_lidar[:, 2] < max_z)

    if sub_idx is None or picks is None:
        if generator is None:
            raise ValueError("pass a generator or both sub_idx and picks")
        sub_idx, picks = draw_ransac(valid, generator, num_hypotheses,
                                     subsample)
    sub_idx = sub_idx.long()
    picks = picks.long()
    sub_pts = pts[sub_idx]  # [S_sub, 3]
    sub_ok = zmask[sub_idx]
    n_usable = zmask.sum()

    tri = sub_pts[picks]  # [S, 3, 3]
    tri_ok = sub_ok[picks].all(dim=-1)
    n_raw = cross3(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n_norm = norm3(n_raw)
    n_unit = n_raw / torch.where(n_norm < 1e-12, 1.0, n_norm)[:, None]
    d = -dot3(n_unit, tri[:, 0])  # [S]

    cos_eps = math.cos(math.radians(axis_max_angle_deg))
    hyp_ok = tri_ok & (torch.abs(n_unit[:, 2]) >= cos_eps) & (n_norm >= 1e-12)

    res = torch.abs(dot3(sub_pts.double()[:, None], n_unit.double()[None])
                    + d.double()[None, :])  # [S_sub, S]
    inl = (res < f32(distance_threshold)) & sub_ok[:, None]
    counts = torch.where(hyp_ok, inl.sum(0), -1)
    # `index_select` on a 1-element index: indexing with the 0-dim `best`
    # itself would read it back to the host.
    best = torch.argmax(counts)[None]
    best_coeffs = torch.cat([n_unit.index_select(0, best)[0],
                             d.index_select(0, best)])
    best_inl_sub = inl.index_select(1, best)[:, 0]

    # `.index_put_` below has duplicate indices (the subsample is drawn
    # with replacement).  That is safe: the value written for an index
    # depends only on the point it names, so every duplicate writes the
    # same value and the order of the writes does not matter.
    inlier_mask = torch.zeros(P, dtype=torch.bool, device=pts.device)
    if use_refinement:
        refined = _ls_plane(sub_pts, best_inl_sub.to(torch.float32))
        if inliers_from_full_cloud:
            dist_full = _plane_dist(pts, refined)
            inlier_mask = zmask & (dist_full < f32(refinement_threshold))
        else:
            # Reference: within refinement distance of the UNrefined
            # model, over the subsample only.
            dist_sub = torch.abs(dot3(sub_pts, best_coeffs[:3])
                                 + best_coeffs[3])
            sel = sub_ok & (dist_sub < refinement_threshold)
            inlier_mask.index_put_((sub_idx,), sel)
        coeffs = refined
    else:
        coeffs = best_coeffs
        inlier_mask.index_put_((sub_idx,), best_inl_sub)

    ok = (n_usable >= 3) & (counts.index_select(0, best)[0] > 0)
    return GroundPlane(coeffs=_orient_up(coeffs),
                       inlier_mask=inlier_mask & valid, ok=ok)


def _pixel_index(x: torch.Tensor, last: int) -> torch.Tensor:
    """Truncate a pixel coordinate toward zero and clamp it to [0, last].

    The cast of a huge or non-finite value differs between devices (the
    card saturates and maps NaN to 0, the CPU gives INT_MIN); every such
    lane is out of the image and masked by the caller, so the value is
    first brought into a range where all casts agree."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0,
                       float(last)).to(torch.int64)


def fit_ground_plane_semantic(
    points_lidar: torch.Tensor,
    valid: torch.Tensor,
    semantic_image: torch.Tensor,
    lidar_to_cam_rotation: torch.Tensor,
    lidar_to_cam_translation: torch.Tensor,
    intrinsics: torch.Tensor,
    *,
    ground_labels: tuple[int, ...] = (6, 7, 8, 9),
    inlier_threshold: float = 10.2,
) -> GroundPlane:
    """Ground plane from a semantic label image [H, W] (integer labels).

    SemanticPlane::CalculateInliersPlane (RansacPlane.cpp:195-274):
    project the cloud into the image, keep the points that fall on a
    ground label, LS-fit a plane to them in the lidar frame, select the
    points of the full cloud within `inlier_threshold` of it and refit on
    those.  As the JAX package, points behind the camera are left out."""
    H, W = semantic_image.shape
    pts = points_lidar.to(torch.float32)
    p64 = pts.double()
    R, t, K = (x.double() for x in (lidar_to_cam_rotation,
                                    lidar_to_cam_translation, intrinsics))
    p_cam = torch.stack([dot3(p64, R[i]) + t[i] for i in range(3)], -1)
    proj = torch.stack([dot3(p_cam, K[i]) for i in range(3)], -1)
    z = proj[:, 2]
    safe_z = torch.where(z == 0, 1.0, z)
    u = proj[:, 0] / safe_z
    v = proj[:, 1] / safe_z
    # The reference's inclusive bounds, 0 <= u <= cols (RansacPlane.cpp:
    # 203-205); the clamp keeps the lookup inside the image.
    in_img = (u >= 0) & (u <= W) & (v >= 0) & (v <= H) & (z > 0)
    labels = semantic_image[_pixel_index(v, H - 1), _pixel_index(u, W - 1)]
    on_ground = torch.zeros_like(in_img)
    for lab in ground_labels:
        on_ground = on_ground | (labels == lab)
    seed = valid & in_img & on_ground

    coeffs0 = _ls_plane(pts, seed.to(torch.float32))
    refined_mask = valid & (_plane_dist(pts, coeffs0) < f32(inlier_threshold))
    coeffs = _ls_plane(pts, refined_mask.to(torch.float32))
    return GroundPlane(coeffs=_orient_up(coeffs), inlier_mask=refined_mask,
                       ok=seed.sum() >= 3)


def _orient_up(coeffs: torch.Tensor) -> torch.Tensor:
    """Canonical orientation: normal z-component >= 0."""
    return coeffs * torch.where(coeffs[2] < 0, -1.0, 1.0)
