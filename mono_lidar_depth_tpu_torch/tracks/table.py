"""Fixed-capacity tracklet table (counterpart of tracks/table.py).

A ring of `max_tracks` slots over dense [T, L] arrays, column 0 the
newest frame.  JAX's out-of-bounds-dropping scatters (`mode="drop"`)
become scatters into tensors with one extra trash row at index T that
is sliced off afterwards; every real row receives at most one write,
so the results are exact and independent of the write order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import Device, default_device

FREE = -1


class TrackTable(NamedTuple):
    """[T]-slot track store; L = per-track frame window (newest first)."""

    track_id: torch.Tensor  # [T] int32, -1 = free slot
    age: torch.Tensor  # [T] int32
    length: torch.Tensor  # [T] int32 valid frames in the window (<= L)
    uv: torch.Tensor  # [T, L, 2] f32, column 0 newest
    depth: torch.Tensor  # [T, L] f32, -1 = none
    stamps: torch.Tensor  # [L] f32, column 0 newest

    @classmethod
    def create(cls, max_tracks: int, max_length: int,
               device: Device = default_device()) -> "TrackTable":
        T, L = max_tracks, max_length
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            track_id=torch.full((T,), FREE, **i32),
            age=torch.zeros(T, **i32),
            length=torch.zeros(T, **i32),
            uv=torch.zeros((T, L, 2), device=device),
            depth=torch.full((T, L), -1.0, device=device),
            stamps=torch.zeros(L, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.track_id.shape[0]

    @property
    def window(self) -> int:
        return self.depth.shape[1]

    def active(self) -> torch.Tensor:
        return self.track_id != FREE


def match_tracks(table: TrackTable, ids: torch.Tensor,
                 ids_valid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot [M] int32 existing slot or -1, is_new [M] bool)."""
    eq = (ids[:, None] == table.track_id[None, :]) & table.active()[None, :]
    found = eq.any(1)
    first = torch.argmax(eq.to(torch.uint8), dim=1).to(torch.int32)
    slot = torch.where(found, first, FREE)
    return slot, ids_valid & ~found


def _flag_rows(T: int, target: torch.Tensor, on: torch.Tensor
               ) -> torch.Tensor:
    """[T] bool: row r is set iff some lane with on[m] targets r (lanes
    that are off target the trash row T)."""
    out = torch.zeros(T + 1, dtype=torch.int32, device=target.device)
    out.scatter_reduce_(0, target, on.to(torch.int32), reduce="amax")
    return out[:T].bool()


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """x with one trash row appended along axis 0."""
    return torch.cat([x, torch.zeros_like(x[:1])])


def update_tracks(
    table: TrackTable,
    ids: torch.Tensor,
    ids_valid: torch.Tensor,
    uv_new: torch.Tensor,
    uv_prev: torch.Tensor,
    depths_new: torch.Tensor,
    depths_prev: torch.Tensor,
    stamp: torch.Tensor,
    match: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[TrackTable, torch.Tensor]:
    """One frame of tracklet bookkeeping: drop unmatched tracks, seed new
    tracks with the previous-frame entry then the newest, push one frame
    onto existing tracks, shift the stamps.  Returns (table, slot [M])."""
    T, L = table.capacity, table.window
    dev = ids.device

    slot_exist, is_new = (match if match is not None
                          else match_tracks(table, ids, ids_valid))

    # GC: free every slot that is not matched this frame.
    hit = (slot_exist >= 0) & ids_valid
    matched = _flag_rows(T, torch.where(hit, slot_exist, T).long(), hit)
    keep = table.active() & matched

    # New track of rank r takes the r-th free slot (slot order).
    free = ~keep
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    free_list = torch.full((T + 1,), FREE, dtype=torch.int32, device=dev)
    free_list[torch.where(free, free_rank, T).long()] = torch.arange(
        T, dtype=torch.int32, device=dev)
    free_list = free_list[:T]
    new_rank = torch.cumsum(is_new.to(torch.int32), 0) - 1
    num_free = free.sum(dtype=torch.int32)
    overflow = new_rank >= num_free  # table full: drop the track
    slot_new = torch.where(is_new & ~overflow,
                           free_list[torch.clamp(new_rank, 0, T - 1).long()],
                           FREE)
    slot = torch.where(is_new, slot_new, slot_exist)
    landing = (slot >= 0) & ids_valid

    # Reset freed / newly allocated slots.
    reset = free
    track_id = torch.where(reset, FREE, table.track_id)
    age = torch.where(reset, 0, table.age)
    length = torch.where(reset, 0, table.length)
    uv = torch.where(reset[:, None, None], 0.0, table.uv)
    depth = torch.where(reset[:, None], -1.0, table.depth)

    tgt = torch.where(landing, slot, T).long()
    seed = landing & is_new
    seed_tgt = torch.where(seed, slot, T).long()

    # Seed new tracks with the PREVIOUS frame entry first.
    track_id = _pad_row(track_id)
    track_id[seed_tgt] = ids.to(torch.int32)
    uv = _pad_row(uv)
    uv[seed_tgt, 0] = uv_prev
    depth = _pad_row(depth)
    depth[seed_tgt, 0] = depths_prev
    length = _pad_row(length)
    # not `length[seed_tgt] = 1`: a scalar assigned through an index
    # tensor waits for the card
    length.index_fill_(0, seed_tgt, 1)
    track_id, uv, depth, length = (track_id[:T], uv[:T], depth[:T],
                                   length[:T])

    # Push the newest frame for all landing tracks: shift right.
    push = _flag_rows(T, tgt, landing)
    seeded = _flag_rows(T, seed_tgt, seed)
    uv = torch.where(push[:, None, None],
                     torch.cat([uv[:, :1], uv[:, :-1]], 1), uv)
    depth = torch.where(push[:, None],
                        torch.cat([depth[:, :1], depth[:, :-1]], 1), depth)
    uv = _pad_row(uv)
    uv[tgt, 0] = uv_new
    depth = _pad_row(depth)
    depth[tgt, 0] = depths_new
    uv, depth = uv[:T], depth[:T]
    length = torch.where(push, torch.clamp(length + 1, max=L), length)
    # Age: entries seen - 1 (a documented deviation from the reference,
    # whose published age stays 0).
    age = torch.where(push, torch.where(seeded, 1, age + 1), age)
    age = torch.where(reset & ~push, 0, age)

    stamps = torch.cat([stamp.reshape(1).to(table.stamps.dtype),
                        table.stamps[:-1]])
    return TrackTable(track_id=track_id, age=age, length=length, uv=uv,
                      depth=depth, stamps=stamps), slot
