"""First-local-max depth-blob segmentation (counterpart of
core/histogram.py, sort-based formulation).

The K bin ids of each feature are sorted and the reference's
break/abort bin scan runs over the occupied-bin groups with
cumulative max/min scans (`torch.cummax` / `torch.cummin` in place of
`lax.cummax` / `lax.cummin`); see the JAX module for the semantics and
the equivalence argument.  Integer logic only after the binning, so the
outputs are bit-identical to the JAX function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import _div


class HistogramSegmentation(NamedTuple):
    seg_mask: torch.Tensor  # [N, K] points inside the selected bin
    found: torch.Tensor  # [N] bool
    lower: torch.Tensor  # [N] selected bin lower border (-1 none)
    upper: torch.Tensor  # [N] selected bin upper border (-1 none)
    bin_id: torch.Tensor  # [N] selected bin (-1 none)


def _first_true(flags: torch.Tensor, fill: int) -> torch.Tensor:
    """Index of the first True along the last axis; `fill` if none."""
    idx = torch.argmax(flags.to(torch.uint8), dim=-1)
    return torch.where(flags.any(-1), idx, fill).to(torch.int32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[n, idx[n]] for x [N, K], idx [N]."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def filter_points_min_dist_blob(
    depths: torch.Tensor,
    mask: torch.Tensor,
    bin_width: float,
    min_pointcount: int,
    num_bins: int,
) -> HistogramSegmentation:
    """Segment neighbor depths [N, K] by the first local-max bin."""
    N, K = depths.shape
    B = num_bins
    dev = depths.device

    d = torch.clamp(depths, max=999.0)
    # |d| / w >= 0, so clamping at B before the cast is exact.
    bins = torch.clamp(torch.clamp(_div(torch.abs(d), bin_width), max=float(B))
                       .to(torch.int32), 0, B - 1)
    bins_m = torch.where(mask, bins, B)  # invalid -> sentinel B, sorts last
    sb = torch.sort(bins_m, dim=1).values
    karr = torch.arange(K, dtype=torch.int32, device=dev)[None, :].expand(
        N, K)
    valid = sb < B
    prev_sb = torch.cat([torch.full((N, 1), -1, dtype=sb.dtype, device=dev),
                         sb[:, :-1]], dim=1)
    is_start = valid & (sb != prev_sb)

    # Group run lengths: next group-start position minus own position.
    startpos = torch.where(is_start, karr, K)
    suffmin = torch.flip(torch.cummin(torch.flip(startpos, [1]), 1).values,
                         [1])
    next_start = torch.cat([suffmin[:, 1:],
                            torch.full((N, 1), K, dtype=torch.int32,
                                       device=dev)], dim=1)
    n_valid = valid.sum(1, dtype=torch.int32)
    gcount = torch.where(is_start,
                         torch.minimum(next_start, n_valid[:, None]) - karr,
                         0)

    gap_before = is_start & (prev_sb >= 0) & (sb > prev_sb + 1)
    qual = torch.where(is_start & (gcount >= min_pointcount), gcount, -1)
    M = torch.cummax(qual, 1).values
    Mprev = torch.cat([torch.full((N, 1), -1, dtype=M.dtype, device=dev),
                       M[:, :-1]], dim=1)
    abort_b = gap_before & (Mprev == -1)
    break_b = (gap_before & (Mprev >= 0)) | (
        is_start & (gcount < Mprev) & ~gap_before)

    fb = _first_true(break_b, K)
    fa = _first_true(abort_b, K)
    Mprev_at_fb = _take(Mprev, torch.clamp(fb, max=K - 1))
    M_last = M[:, -1]
    clean = (fb == K) & (fa == K)
    found = torch.where(fb < fa, True,
                        torch.where(fa < fb, False, clean & (M_last >= 0)))
    target = torch.where(fb < K, Mprev_at_fb, M_last)
    cand = (is_start & (qual == target[:, None]) & (target[:, None] >= 0)
            & (karr < torch.minimum(fb, fa)[:, None]))
    sel = _first_true(cand, K)
    bin_id = _take(sb, torch.clamp(sel, max=K - 1))
    found = found & valid.any(1) & (sel < K)
    bin_id = torch.where(found, bin_id, -1)

    lower = bin_id.to(d.dtype) * bin_width
    upper = lower + bin_width
    seg_mask = (mask & (d >= lower[:, None]) & (d < upper[:, None])
                & found[:, None])
    return HistogramSegmentation(
        seg_mask=seg_mask,
        found=found,
        lower=torch.where(found, lower, -1.0),
        upper=torch.where(found, upper, -1.0),
        bin_id=bin_id,
    )


def nearest_point(depths: torch.Tensor, mask: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(index of the minimum-depth masked entry per row, row non-empty)."""
    d = torch.where(mask, depths, float("inf"))
    return torch.argmin(d, dim=-1).to(torch.int32), mask.any(-1)
