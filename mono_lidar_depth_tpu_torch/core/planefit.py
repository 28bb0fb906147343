"""Batched local plane estimation over masked neighbor sets (counterpart
of core/planefit.py): max-spanning triangle, first three points,
planarity check, M-estimator and LS plane fits, PCA classifier and the
XZ flatness check.  All take [N, K, 3] points with [N, K] masks; 3x3
eigenproblems use the closed-form solver in `geometry`.

The triangle's ranking and the three fits run in float64 from the
float32 points, sum over K in the order of `geometry.sum_sorted` and
round to float32 once, at their outputs (the rule of `geometry.f32`),
with the JAX package's formulas: the Gram-form distances, the
M-estimator weights, Smith's closed form.

Argmax ties break in row-major window order (`torch.argmax` returns the
first maximum on CPU and CUDA), which keeps the [N, K] layout's scan
order — the reference's strict-> update rule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry import (cross3, dot3, f32, norm3,
                       smallest_eigenvector_sym3x3, sum_sorted,
                       sym3x3_eigenvalues)


class TriangleResult(NamedTuple):
    corners: torch.Tensor  # [N, 3, 3]
    ok: torch.Tensor  # [N] bool


def _pick(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points[n, idx[n]] for points [N, K, 3], idx [N]."""
    return torch.gather(points, 1, idx.long()[:, None, None].expand(
        -1, 1, points.shape[-1]))[:, 0]


def max_spanning_triangle(points: torch.Tensor, mask: torch.Tensor,
                          dist_threshold: float = 0.0) -> TriangleResult:
    """Farthest pair (i, j), then the third point k maximizing
    d(k,i) + d(k,j) with both legs > dist_threshold; fails on < 3
    points, coincident points or no valid third point.  The squared
    distances are ranked in float64; the corners are the float32
    points."""
    N, K, _ = points.shape
    dev = points.device
    p = points.double()
    sq = dot3(p, p)  # [N, K]
    gram = dot3(p[:, :, None], p[:, None, :])  # [N, K, K]
    d2 = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * gram, min=0.0)
    thr = f32(dist_threshold)
    pair_ok = mask[:, :, None] & mask[:, None, :]
    iu = torch.triu(torch.ones(K, K, dtype=torch.bool, device=dev),
                    diagonal=1)
    d2_pairs = torch.where(pair_ok & iu, d2, -1.0)

    flat = d2_pairs.reshape(N, K * K)
    best = torch.argmax(flat, dim=-1)
    maxdist = torch.gather(flat, 1, best[:, None])[:, 0]
    i_idx = best // K
    j_idx = best % K

    ok = (mask.sum(-1) >= 3) & (maxdist > thr)

    d_i = torch.gather(d2, 2, i_idx[:, None, None].expand(N, K, 1))[:, :, 0]
    d_j = torch.gather(d2, 2, j_idx[:, None, None].expand(N, K, 1))[:, :, 0]
    k_range = torch.arange(K, device=dev)
    k_ok = (mask & (k_range[None, :] != i_idx[:, None])
            & (k_range[None, :] != j_idx[:, None])
            & (d_i > thr) & (d_j > thr))
    score = torch.where(k_ok, d_i + d_j, -1.0)
    k_idx = torch.argmax(score, dim=-1)
    ok = ok & (torch.gather(score, 1, k_idx[:, None])[:, 0] > -1.0)

    corners = torch.stack([_pick(points, i_idx), _pick(points, j_idx),
                           _pick(points, k_idx)], dim=1)
    return TriangleResult(corners=corners, ok=ok)


def first_three_points(points: torch.Tensor, mask: torch.Tensor
                       ) -> TriangleResult:
    """First three masked points in scan order."""
    order = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    corners = [_pick(points, torch.argmax((mask & (order == r)).to(
        torch.uint8), dim=-1)) for r in range(3)]
    return TriangleResult(corners=torch.stack(corners, dim=1),
                          ok=mask.sum(-1) >= 3)


def _unit(v: torch.Tensor) -> torch.Tensor:
    n = norm3(v)[..., None]
    return v / torch.where(n == 0, 1.0, n)


def check_planar(corners: torch.Tensor, threshold: float) -> torch.Tensor:
    """All pairwise cross products of the normalized triangle edges have
    norm >= threshold.  corners [N, 3, 3] -> [N] bool."""
    c1, c2, c3 = corners[:, 0], corners[:, 1], corners[:, 2]
    e1, e2, e3 = _unit(c2 - c1), _unit(c3 - c1), _unit(c3 - c2)
    return ((norm3(cross3(e1, e2)) >= threshold)
            & (norm3(cross3(e1, e3)) >= threshold)
            & (norm3(cross3(e2, e3)) >= threshold))


class PlaneFit(NamedTuple):
    normal: torch.Tensor  # [N, 3]
    anchor: torch.Tensor  # [N, 3]
    ok: torch.Tensor  # [N]


def _scatter3(centered: torch.Tensor) -> torch.Tensor:
    """Σ_k c_k c_kᵀ for centered [N, K, 3] -> [N, 3, 3], each entry a
    `sum_sorted` over K."""
    c0, c1, c2 = centered.unbind(-1)
    s = sum_sorted(torch.stack([c0 * c0, c0 * c1, c0 * c2, c1 * c1,
                                c1 * c2, c2 * c2], -2)).unbind(-1)
    return torch.stack([torch.stack([s[0], s[1], s[2]], -1),
                        torch.stack([s[1], s[3], s[4]], -1),
                        torch.stack([s[2], s[4], s[5]], -1)], -2)


def _wsum(w: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Σ_k w_k p_k for w [N, K] and points [N, K, 3] -> [N, 3]."""
    return sum_sorted((w[..., None] * points).transpose(-1, -2))


def _fit(points: torch.Tensor, center: torch.Tensor, centered: torch.Tensor,
         ok: torch.Tensor) -> PlaneFit:
    """The float64 fit's normal and its center, rounded to the points'
    float32."""
    normal = smallest_eigenvector_sym3x3(_scatter3(centered))
    return PlaneFit(normal=normal.to(points.dtype),
                    anchor=center.to(points.dtype), ok=ok)


def mestimator_plane(points: torch.Tensor, mask: torch.Tensor,
                     prior_normal: Optional[torch.Tensor] = None,
                     prior_offset: Optional[torch.Tensor] = None,
                     prior_dist: Optional[torch.Tensor] = None,
                     eps: float = 1e-9) -> PlaneFit:
    """Plane fit with weights 1 / max(prior distance, eps): weighted
    centroid, normal = smallest eigenvector of the weighted scatter."""
    p = points.double()
    if prior_dist is None:
        prior_dist = torch.abs(dot3(p, prior_normal.double()[..., None, :])
                               + prior_offset.double()[..., None])
    w = torch.where(mask, 1.0 / torch.clamp(prior_dist.double(), min=f32(eps)),
                    0.0)
    wsum = sum_sorted(w)[..., None]
    center = _wsum(w, p) / torch.where(wsum == 0, 1.0, wsum)
    centered = (p - center[..., None, :]) * torch.sqrt(w)[..., None]
    return _fit(points, center, centered,
                (mask.sum(-1) >= 3) & (wsum[..., 0] > 0))


def _masked_mean_centered(points: torch.Tensor, mask: torch.Tensor):
    """The masked mean and the centered masked points, in float64."""
    p = points.double()
    m = mask.double()
    cnt = mask.sum(-1, keepdim=True).double()
    mean = _wsum(m, p) / torch.where(cnt == 0, 1.0, cnt)
    return mean, (p - mean[..., None, :]) * m[..., None]


def least_squares_plane(points: torch.Tensor, mask: torch.Tensor
                        ) -> PlaneFit:
    """Unweighted orthogonal-distance LS plane fit."""
    return _fit(points, *_masked_mean_centered(points, mask),
                mask.sum(-1) >= 3)


class PCAResult(NamedTuple):
    is_plane: torch.Tensor  # [N]
    is_point: torch.Tensor
    is_linear: torch.Tensor
    is_cubic: torch.Tensor
    normal: torch.Tensor  # [N, 3]
    anchor: torch.Tensor  # [N, 3]


def pca_classify(points: torch.Tensor, mask: torch.Tensor,
                 treshold_3_abs_min: float,
                 treshold_3_2_rel_max: float,
                 treshold_2_1_rel_min: float) -> PCAResult:
    """PCA patch classification on the raw (unnormalized) scatter,
    checks in the reference's order: cubic, linear, point, plane."""
    mean, centered = _masked_mean_centered(points, mask)
    cov = _scatter3(centered)
    evals = sym3x3_eigenvalues(cov)
    e1, e2, e3 = evals[..., 0], evals[..., 1], evals[..., 2]
    safe_e3 = torch.where(e3 == 0, 1.0, e3)
    is_cubic = (e2 - e1) / safe_e3 < f32(treshold_2_1_rel_min)
    is_linear = ~is_cubic & ((e3 - e2) / safe_e3 > f32(treshold_3_2_rel_max))
    is_point = ~is_cubic & ~is_linear & (e3 < f32(treshold_3_abs_min))
    is_plane = ~is_cubic & ~is_linear & ~is_point
    normal = smallest_eigenvector_sym3x3(cov).to(points.dtype)
    return PCAResult(is_plane=is_plane, is_point=is_point,
                     is_linear=is_linear, is_cubic=is_cubic,
                     normal=normal, anchor=mean.to(points.dtype))


def check_xz_flatness(points: torch.Tensor, mask: torch.Tensor,
                      threshold: float) -> torch.Tensor:
    """sizeZ / sizeX >= threshold over the masked set."""
    inf = float("inf")
    x, z = points[..., 0], points[..., 2]
    size_x = (torch.where(mask, x, -inf).amax(-1)
              - torch.where(mask, x, inf).amin(-1))
    size_z = (torch.where(mask, z, -inf).amax(-1)
              - torch.where(mask, z, inf).amin(-1))
    safe_x = torch.where(size_x == 0, 1e-30, size_x)
    return mask.any(-1) & (size_z / safe_x >= threshold)
