"""Velodyne scan-row segmentation + region-growing depth segmentation
(counterpart of core/row_segmentation.py).

  * Row segmentation: the visible points, in scan order, are split into
    rows wherever the image-x coordinate jumps up by more than 50 px: a
    cumsum rank compacts the visible subsequence, a second cumsum over the
    jump flags gives the row ids.  One pass, O(P).
  * Region growing: from each feature's nearest lidar point (the seed),
    grow along its row and one adjacent row, bounded by distance caps that
    scale with the seed's depth.  The walk-with-breaks is a prefix-AND
    over a static column window around the seed, for all features at once.

Status codes of `grow_regions`: 1 ok, -1 no adjacent-row seed, -2
seed-to-seed distance exceeded, -3 no growth, -4 no nearest point.

Meaningful only for azimuth-ordered scans; on an unordered cloud the jump
rule yields no coherent rows and every feature falls through to the
regular pipeline.

Against the JAX package: a scatter with the out-of-range index P (or
`max_rows`) becomes a write into a scratch one slot longer whose last slot
is cut.  On a cloud with more than `max_rows` rows the row ids are clipped,
so several row starts write the last slot of `row_start`; JAX's CPU backend
applies its updates in order and keeps the last, which is the largest
position, so the write here is a `scatter_reduce_` with `amax`: the same
value, and one that does not depend on the order of the writes on the
card.  No loop over features or rows and no read-back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import norm3
from .projection import FrameCloud

ROW_JUMP_PX = 50.0  # HelperLidarRowSegmentation.cpp:30


class RowStructure(NamedTuple):
    """Compact scan-row layout of the visible points."""

    comp_raw: torch.Tensor  # [P] int32 raw point index at compact position (or -1)
    comp_uv: torch.Tensor  # [P, 2] image coords at compact positions
    comp_xyz: torch.Tensor  # [P, 3] camera-frame coords at compact positions
    comp_valid: torch.Tensor  # [P] bool
    row_id: torch.Tensor  # [P] int32 row of each compact position
    col_id: torch.Tensor  # [P] int32 column within row
    row_start: torch.Tensor  # [R] int32 compact index of each row's first point
    row_len: torch.Tensor  # [R] int32
    num_rows: torch.Tensor  # [] int32
    rank: torch.Tensor  # [P] int32 raw index -> compact position (or -1)


def _set_drop(base: torch.Tensor, index: torch.Tensor, values: torch.Tensor
              ) -> torch.Tensor:
    """base.at[index].set(values, mode="drop") for index in [0, N] whose
    entries below N are distinct: an index N is dropped (it writes a
    scratch slot that is cut)."""
    N = base.shape[0]
    out = torch.cat([base, base[:1]])
    out[index.long()] = values
    return out[:N]


def segment_rows(frame: FrameCloud, max_rows: int = 128) -> RowStructure:
    """Split the visible points (in raw scan order) into rows."""
    P = frame.valid.shape[0]
    dev = frame.valid.device
    i32 = torch.int32
    vis = frame.visible
    rank = torch.cumsum(vis.to(i32), 0, dtype=i32) - 1
    n_vis = vis.sum(dtype=i32)
    tgt = torch.where(vis, rank, P)

    arange = torch.arange(P, dtype=i32, device=dev)
    comp_raw = _set_drop(torch.full((P,), -1, dtype=i32, device=dev), tgt,
                         arange)
    comp_uv = _set_drop(torch.zeros_like(frame.uv), tgt, frame.uv)
    comp_xyz = _set_drop(torch.zeros_like(frame.points_cam), tgt,
                         frame.points_cam)
    comp_valid = arange < n_vis

    x = comp_uv[:, 0]
    prev_x = torch.cat([x.new_full((1,), float("-inf")), x[:-1]])
    new_row = comp_valid & ((x > prev_x + ROW_JUMP_PX) | (arange == 0))
    row_id = torch.cumsum(new_row.to(i32), 0, dtype=i32) - 1
    row_id = torch.where(comp_valid, torch.clamp(row_id, 0, max_rows - 1), -1)
    # column = offset from the row's first compact position
    start_of_row = torch.cummax(torch.where(new_row, arange, -1), 0).values
    col_id = torch.where(comp_valid, arange - start_of_row, -1)

    # Clipped row ids repeat on a cloud with more than max_rows rows: the
    # largest position wins (see the module docstring).
    row_start = torch.full((max_rows + 1,), -1, dtype=i32, device=dev)
    row_start.scatter_reduce_(
        0, torch.where(new_row & (row_id >= 0), row_id, max_rows).long(),
        arange, "amax", include_self=True)
    row_cnt = torch.zeros(max_rows + 1, dtype=i32, device=dev)
    row_cnt.index_add_(0, torch.where(comp_valid, row_id, max_rows).long(),
                       torch.ones_like(arange))
    num_rows = torch.where(comp_valid, row_id, -1).amax() + 1

    return RowStructure(comp_raw=comp_raw, comp_uv=comp_uv,
                        comp_xyz=comp_xyz, comp_valid=comp_valid,
                        row_id=row_id, col_id=col_id,
                        row_start=row_start[:max_rows],
                        row_len=row_cnt[:max_rows], num_rows=num_rows,
                        rank=torch.where(vis, rank, -1))


class RegionGrowResult(NamedTuple):
    raw_indices: torch.Tensor  # [N, 2W] int32 raw indices of the grown set
    mask: torch.Tensor  # [N, 2W] bool
    status: torch.Tensor  # [N] int32: 1 ok, or -1/-2/-3/-4


def _grad_dist(threshold: float, start: float, gradient: float,
               seed_depth: torch.Tensor) -> torch.Tensor:
    """getMaxDist (HelperLidarRowSegmentation.cpp:302-313)."""
    delta = seed_depth - start
    return torch.where(seed_depth <= threshold, start,
                       start + delta * gradient)


def _take(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table[clip(index)] along axis 0 for an int32 index of any shape."""
    return table[torch.clamp(index, 0, table.shape[0] - 1).long()]


def _row_window(rows: RowStructure, row: torch.Tensor,
                center_col: torch.Tensor, width: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """A static column window [N, width] of compact positions for (row,
    center_col) pairs: (compact positions, valid)."""
    P = rows.comp_valid.shape[0]
    start = _take(rows.row_start, row)
    length = _take(rows.row_len, row)
    offs = torch.arange(width, dtype=torch.int32,
                        device=row.device) - width // 2
    cols = center_col[:, None] + offs[None, :]
    ok = ((row >= 0)[:, None] & (cols >= 0) & (cols < length[:, None])
          & (start >= 0)[:, None])
    pos = torch.clamp(start[:, None] + cols, 0, P - 1)
    return pos, ok


def _pick(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[n, k[n]] for x [N, K] and k [N]."""
    return torch.gather(x, 1, k[:, None])[:, 0]


def grow_regions(
    rows: RowStructure,
    seed_raw: torch.Tensor,
    seed_valid: torch.Tensor,
    feature_uv: torch.Tensor,
    *,
    max_dist_threshold: float = 10.0,
    seed_to_seed_start: float = 0.5,
    seed_to_seed_gradient: float = 0.05,
    neighbor_to_seed_start: float = 0.5,
    neighbor_to_seed_gradient: float = 0.05,
    neighbor_start: float = 0.2,
    neighbor_gradient: float = 0.02,
    max_pointcount: int = 4,
    window: int = 32,
) -> RegionGrowResult:
    """Region-grow around per-feature seed points along two scan rows.

    Args:
      rows: output of segment_rows.
      seed_raw: [N] int raw index of each feature's nearest lidar point.
      seed_valid: [N] seed availability (False -> status -4).
      feature_uv: [N, 2].
      defaults follow parameters.yaml:77-87.
    """
    N = seed_raw.shape[0]
    dev = seed_raw.device
    seed_ci = _take(rows.rank, seed_raw)
    seed_ci = torch.where(seed_valid, seed_ci, -1)
    seed_row = _take(rows.row_id, seed_ci)
    seed_col = _take(rows.col_id, seed_ci)
    seed_xyz = _take(rows.comp_xyz, seed_ci)
    seed_depth = seed_xyz[:, 2]

    d_seed2seed = _grad_dist(max_dist_threshold, seed_to_seed_start,
                             seed_to_seed_gradient, seed_depth)
    d_nb2seed = _grad_dist(max_dist_threshold, neighbor_to_seed_start,
                           neighbor_to_seed_gradient, seed_depth)
    d_nb = _grad_dist(max_dist_threshold, neighbor_start, neighbor_gradient,
                      seed_depth)

    def sq_dist(uv: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        d = uv - ref
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]

    # ---- adjacent-row seed: the nearest point (image space) in a window
    # of row seed_row +- 1 around a proportional column estimate.
    def adj_seed(delta: int):
        row = seed_row + delta
        own_len = _take(rows.row_len, seed_row)
        adj_len = _take(rows.row_len, row)
        # int32 / int32 is a true division in f32, as in JAX
        frac = seed_col / torch.clamp(own_len, min=1)
        center = (frac * adj_len).to(torch.int32)
        pos, ok = _row_window(rows, row, center, window)
        d2 = sq_dist(rows.comp_uv[pos.long()], feature_uv[:, None, :])
        d2 = torch.where(ok, d2, float("inf"))
        best = torch.argmin(d2, dim=1)
        return _pick(pos, best), _pick(d2, best) < float("inf")

    top_ci, top_ok = adj_seed(-1)
    bot_ci, bot_ok = adj_seed(1)
    # the nearer of the two (image distance), as getNeighborRowPoint does
    inf = float("inf")
    top_d = torch.where(top_ok, sq_dist(rows.comp_uv[top_ci.long()],
                                        feature_uv), inf)
    bot_d = torch.where(bot_ok, sq_dist(rows.comp_uv[bot_ci.long()],
                                        feature_uv), inf)
    use_top = top_d <= bot_d
    adj_ci = torch.where(use_top, top_ci, bot_ci)
    adj_any = top_ok | bot_ok
    # second candidate for the seed-to-seed fallback (selectRowIndex)
    alt_ci = torch.where(use_top, bot_ci, top_ci)
    alt_ok = torch.where(use_top, bot_ok, top_ok)

    adj_dist = norm3(rows.comp_xyz[adj_ci.long()] - seed_xyz)
    alt_dist = norm3(rows.comp_xyz[alt_ci.long()] - seed_xyz)
    primary_ok = adj_any & (adj_dist <= d_seed2seed)
    fallback_ok = alt_ok & (alt_dist <= d_seed2seed)
    second_ci = torch.where(primary_ok, adj_ci,
                            torch.where(fallback_ok, alt_ci, -1))
    seed2_fail = adj_any & ~primary_ok & ~fallback_ok  # status -2

    # ---- growth along a row from a seed: prefix-AND within the window.
    half = window // 2
    right_side = (torch.arange(window, device=dev) >= half)[None, :]
    always = torch.ones((N, 1), dtype=torch.bool, device=dev)

    def grow(row, col, ci_seed):
        pos, ok = _row_window(rows, row, col, window)
        xyz = rows.comp_xyz[pos.long()]  # [N, W, 3]
        anchor = _take(rows.comp_xyz, ci_seed)
        dist_seed = norm3(xyz - anchor[:, None, :])
        step = norm3(xyz[:, 1:] - xyz[:, :-1])
        cond = ok & (dist_seed <= d_nb2seed[:, None])
        # chain condition: neighbor-to-neighbor step bounded
        step_ok = step <= d_nb[:, None]
        right_step_ok = torch.cat([always, step_ok], dim=1)
        left_step_ok = torch.cat([step_ok, always], dim=1)
        # prefix-AND going right from the center, and left from the center
        # (cumprod has no bool form)
        right_run = torch.cumprod(
            (~right_side | (cond & right_step_ok)).to(torch.int32), dim=1)
        left_run = torch.flip(torch.cumprod(torch.flip(
            (right_side | (cond & left_step_ok)).to(torch.int32), [1]),
            dim=1), [1])
        grown = torch.where(right_side, right_run, left_run).bool() & cond
        return pos, grown, dist_seed

    pos1, grown1, ds1 = grow(seed_row, seed_col, seed_ci)
    row2 = _take(rows.row_id, second_ci)
    col2 = _take(rows.col_id, second_ci)
    pos2, grown2, ds2 = grow(row2, col2, second_ci)
    grown2 = grown2 & (second_ci >= 0)[:, None]

    pos = torch.cat([pos1, pos2], dim=1)  # [N, 2W]
    grown = torch.cat([grown1, grown2], dim=1)
    dseed = torch.where(grown, torch.cat([ds1, ds2], dim=1), inf)

    if max_pointcount > 0:
        # keep the max_pointcount nearest-to-seed grown points; most of
        # dseed is inf, and equal values keep their index order
        order = torch.argsort(dseed, dim=1, stable=True)
        keep_rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(2 * window, device=dev).expand(
                N, 2 * window))
        grown = grown & (keep_rank < max_pointcount)

    second_grew = grown1.any(1) & grown2.any(1)

    status = torch.ones(N, dtype=torch.int32, device=dev)
    status = torch.where(~second_grew, -3, status)
    status = torch.where(seed2_fail, -2, status)
    status = torch.where(~adj_any, -1, status)
    status = torch.where(~seed_valid, -4, status)

    raw = rows.comp_raw[pos.long()]
    grown = grown & (status == 1)[:, None]
    return RegionGrowResult(raw_indices=torch.where(grown, raw, -1),
                            mask=grown, status=status)
