"""Depth-augmented track records — the framework's "wire format" (a copy
of the JAX package's io/messages.py, numpy only; `tracks_from_table` reads
the port's TrackTable back from its device).

Array-schema equivalent of `matches_msg_depth_ros` (SURVEY.md §2.4):
  FeaturePoint {u, v, d}  (d < 0 = no depth)
  Tracklet {feature_points newest-first, id, age}
  MatchesMsg {tracks, stamps} — stamps length = longest tracklet,
    newest first, aligned by `match[size-i] ↔ stamps[stamps.size-i]`
    (matches_msg_depth_ros/README.md:4-6)

plus the WithOutlierFlag / WithInlierFlag variants {is_outlier, error,
label} used by the downstream conversion chain.  Records serialize to
a single .npz per sequence.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class FeatureTracks:
    """A batch of depth-augmented tracklets (one frame's publish)."""

    uv: np.ndarray  # [T, L, 2] newest first
    depth: np.ndarray  # [T, L]
    length: np.ndarray  # [T]
    track_id: np.ndarray  # [T]
    age: np.ndarray  # [T]
    stamps: np.ndarray  # [L] newest first
    # optional downstream annotations (per track):
    is_outlier: Optional[np.ndarray] = None  # [T] bool
    error: Optional[np.ndarray] = None  # [T] float32
    label: Optional[np.ndarray] = None  # [T] int16 semantic label

    @property
    def num_tracks(self) -> int:
        return int((self.length > 0).sum())

    def success_fail_counts(self) -> tuple[int, int]:
        """Per-feature success/fail tally over all valid entries
        (convert_tracklets_to_matches_msg counters,
        tracklet_depth_module.cpp:232-238)."""
        valid = np.arange(self.depth.shape[1])[None, :] < self.length[:, None]
        d = self.depth[valid]
        return int((d >= 0).sum()), int((d < 0).sum())

    def save(self, path: str) -> None:
        data = dict(uv=self.uv, depth=self.depth, length=self.length,
                    track_id=self.track_id, age=self.age, stamps=self.stamps)
        for k in ("is_outlier", "error", "label"):
            v = getattr(self, k)
            if v is not None:
                data[k] = v
        np.savez_compressed(path, **data)

    @classmethod
    def load(cls, path: str) -> "FeatureTracks":
        z = np.load(path)
        return cls(uv=z["uv"], depth=z["depth"], length=z["length"],
                   track_id=z["track_id"], age=z["age"], stamps=z["stamps"],
                   is_outlier=z.get("is_outlier"), error=z.get("error"),
                   label=z.get("label"))


def tracks_from_table(table) -> FeatureTracks:
    """Export the device-side TrackTable as a host FeatureTracks record,
    keeping only active slots (the reference publishes exactly the
    tracks updated this frame; after GC those are the active set)."""
    def host(x) -> np.ndarray:
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    active = host(table.active())
    stamps = host(table.stamps)
    max_len = int(host(table.length).max()) if active.any() else 0
    return FeatureTracks(
        uv=host(table.uv)[active],
        depth=host(table.depth)[active],
        length=host(table.length)[active],
        track_id=host(table.track_id)[active],
        age=host(table.age)[active],
        stamps=stamps[:max(max_len, 1)],
    )
