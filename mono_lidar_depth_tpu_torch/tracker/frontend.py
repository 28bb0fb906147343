"""Stateful tracking frontend: persistent track ids over a KLT stream
(counterpart of tracker/frontend.py).

Produces exactly the interface the tracklet-depth pipeline consumes
(ids / uv_new / uv_prev / valid per frame).  A track is emitted once it
has been observed in >= 2 consecutive frames.

Lane model: a fixed [N] array of track lanes.  Lanes whose feature is
lost are freed and immediately replenished with fresh detections (one
per spatial cell, harris.detect_features); new lanes get sequential ids
from a device counter.  The pyramid lives in the state so consecutive
frames reuse it.  `track_frame` reads nothing back to the host.

Against the JAX package: `jnp.nanmedian` averages the two middle values
of an even count where `torch.nanmedian` takes the lower one, so the
median flow is a sort and the mean of the two middle valid entries; and
an `.at[idx].set(..., mode="drop")` with the out-of-range index N
becomes a write into an (N+1)-long scratch whose last slot is cut.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .harris import detect_features
from .klt import build_pyramid, track_features


class TrackerState(NamedTuple):
    pyramid: tuple  # previous frame pyramid (tuple of [H/2^l, W/2^l])
    uv: torch.Tensor  # [N, 2] lane position in the previous frame
    ids: torch.Tensor  # [N] int32 track id (-1 free)
    age: torch.Tensor  # [N] int32 frames observed
    valid: torch.Tensor  # [N] bool
    next_id: torch.Tensor  # scalar int32
    flow: torch.Tensor  # [N, 2] last frame's image flow (motion prior)


class TrackerOutput(NamedTuple):
    ids: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] emit mask (age >= 2 this frame)
    uv_new: torch.Tensor  # [N, 2] position in the current frame
    uv_prev: torch.Tensor  # [N, 2] position in the previous frame


def init_tracker(img: torch.Tensor, max_features: int, levels: int = 3,
                 cell_size: int = 16) -> TrackerState:
    """Tracker state of a first frame `img` ([H, W] float, on its device)."""
    dev = img.device
    pyr = tuple(build_pyramid(img, levels))
    uv, ok = detect_features(img, max_features, cell_size=cell_size)
    lanes = torch.arange(max_features, dtype=torch.int32, device=dev)
    return TrackerState(
        pyramid=pyr, uv=uv, ids=torch.where(ok, lanes, -1),
        age=ok.to(torch.int32), valid=ok,
        next_id=torch.tensor(max_features, dtype=torch.int32, device=dev),
        flow=torch.zeros((max_features, 2), dtype=torch.float32, device=dev))


def _nanmedian0(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Median over the rows of x [N, C] where `keep` [N], as
    jnp.nanmedian(where(keep, x, nan), axis=0): the mean of the two
    middle values of an even count; NaN when no row is kept."""
    nan = torch.full_like(x, float("nan"))
    ordered, _ = torch.sort(torch.where(keep[:, None], x, nan), dim=0)
    count = keep.sum()
    lo = torch.clamp((count - 1) // 2, min=0)
    hi = torch.clamp(count // 2, max=x.shape[0] - 1)
    # gather, not ordered[lo]: a 0-dim index would be read back to the host
    mid = ordered.gather(0, torch.stack([lo, hi])[:, None].expand(2,
                                                                  x.shape[1]))
    return mid[0] * 0.5 + mid[1] * 0.5


def _set_drop(base: torch.Tensor, index: torch.Tensor, values
              ) -> torch.Tensor:
    """base.at[index].set(values, mode="drop") for index in [0, N]: an
    index N is dropped (it writes a scratch slot that is cut)."""
    N = base.shape[0]
    out = torch.cat([base, base[:1]])
    if isinstance(values, torch.Tensor):
        out[index.long()] = values
    else:  # a Python scalar goes in as a kernel argument, not as a copy
        out.index_fill_(0, index.long(), values)
    return out[:N]


def track_frame(state: TrackerState, img: torch.Tensor,
                cell_size: int = 16, patch: int = 9, iters: int = 8
                ) -> tuple[TrackerState, TrackerOutput]:
    """Advance the tracker by one frame."""
    N = state.uv.shape[0]
    dev = state.uv.device
    pyr_next = tuple(build_pyramid(img, len(state.pyramid)))
    # constant-velocity warm start: last frame's flow (plus the median
    # flow for lanes with no history — fresh detections during fast
    # motion inherit the camera's dominant image motion)
    has_hist = state.valid & (torch.sum(torch.abs(state.flow), dim=1) > 0)
    med_flow = torch.nan_to_num(_nanmedian0(state.flow, has_hist))
    lane_flow = torch.where(has_hist[:, None], state.flow, med_flow[None, :])
    uv_t, ok = track_features(state.pyramid, pyr_next, state.uv, state.valid,
                              patch=patch, iters=iters,
                              uv_guess=state.uv + lane_flow)
    survived = ok & state.valid

    # Replenish: detect in cells not already occupied by survivors.
    det_uv, det_ok = detect_features(
        img, N, cell_size=cell_size,
        occupied_uv=uv_t, occupied_valid=survived)

    # Allocate detections (in detection order) to free lanes (in lane
    # order) — same rank-matching scheme as tracks.table.update_tracks.
    lanes = torch.arange(N, dtype=torch.int32, device=dev)
    free = ~survived
    free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    free_list = _set_drop(torch.full((N,), -1, dtype=torch.int32, device=dev),
                          torch.where(free, free_rank, N), lanes)
    det_rank = torch.cumsum(det_ok.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    num_free = torch.sum(free.to(torch.int32), dtype=torch.int32)
    alloc = det_ok & (det_rank < num_free)
    lane = torch.where(
        alloc, free_list[torch.clamp(det_rank, 0, N - 1).long()], N)

    uv_out = _set_drop(torch.where(survived[:, None], uv_t, 0.0), lane,
                       det_uv)
    new_ids = state.next_id + det_rank
    ids = _set_drop(torch.where(survived, state.ids, -1), lane, new_ids)
    age = _set_drop(torch.where(survived, state.age + 1, 0), lane, 1)
    valid = _set_drop(survived, lane, True)
    next_id = state.next_id + torch.sum(alloc.to(torch.int32),
                                        dtype=torch.int32)

    out = TrackerOutput(
        ids=state.ids,
        valid=survived & (age >= 2),
        uv_new=uv_t,
        uv_prev=state.uv,
    )
    flow = torch.where(survived[:, None], uv_t - state.uv, 0.0)
    flow = _set_drop(flow, lane, 0.0)  # fresh lanes: no history
    new_state = TrackerState(pyramid=pyr_next, uv=uv_out, ids=ids,
                             age=age, valid=valid, next_id=next_id,
                             flow=flow)
    return new_state, out
