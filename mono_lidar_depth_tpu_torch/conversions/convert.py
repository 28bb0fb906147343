"""Conversions between track-record flavors (counterpart of
conversions/convert.py; numpy, but for the one batched window gather of
`semantic_labels_for_tracks`, which is PyTorch).

Array-native equivalents of the reference's conversion library and
nodelets (SURVEY.md §2.5-2.6):

  * add_outlier_flags       — `AddOutlierFlag` nodelet / `Convert(msg,
    flags[, errors])` (matches_msg_conversions_ros/convert.hpp:31-115,
    add_outlier_flag.cpp:24-41): annotate tracks with outlier flags
    (all-false shim when no estimator runs).
  * lift_to_depth           — `ConvertToDepth` (convert.hpp:117-140):
    give depth-less tracks a d = -1 column.
  * mark_depth_outlier      — `MarkDepthOutlier` nodelet
    (mark_depth_outlier.cpp:33-67): zip per-track depth records with
    outlier-flagged records (sizes must match, as the reference
    enforces at :43-47).
  * semantic_labels_for_tracks — `SemanticLabels` nodelet
    (semantic_labels.cpp:38-107): per track, histogram the semantic
    labels in an ROI around the NEWEST feature and assign the argmax
    label.  Implemented as one batched window gather over all tracks
    instead of a per-track cv::Mat ROI loop.
  * newest_pair_points      — `ConvertF2F` (convert_opencv3.cpp:15-32):
    matched point lists for the two newest frames of each track.

The ExactTime message synchronization of the reference nodelets is
unnecessary here: records are aligned by frame index by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.messages import FeatureTracks


def add_outlier_flags(tracks: FeatureTracks,
                      is_outlier: np.ndarray | None = None,
                      error: np.ndarray | None = None) -> FeatureTracks:
    """Annotate tracks with outlier flags (defaults to all-inlier, the
    AddOutlierFlag shim behavior)."""
    n = len(tracks.track_id)
    if is_outlier is None:
        is_outlier = np.zeros(n, dtype=bool)
    if len(is_outlier) != n:
        raise ValueError(
            f"flag count {len(is_outlier)} != track count {n}")
    if error is not None and len(error) != n:
        raise ValueError("error count mismatch")
    return FeatureTracks(
        uv=tracks.uv, depth=tracks.depth, length=tracks.length,
        track_id=tracks.track_id, age=tracks.age, stamps=tracks.stamps,
        is_outlier=np.asarray(is_outlier, dtype=bool),
        error=(np.asarray(error, dtype=np.float32)
               if error is not None else np.zeros(n, np.float32)),
        label=tracks.label)


def lift_to_depth(uv: np.ndarray, length: np.ndarray, track_id: np.ndarray,
                  age: np.ndarray, stamps: np.ndarray) -> FeatureTracks:
    """Build a depth-flavored record from depth-less tracks (d = -1)."""
    T, L, _ = uv.shape
    return FeatureTracks(
        uv=np.asarray(uv, np.float32),
        depth=np.full((T, L), -1.0, np.float32),
        length=np.asarray(length), track_id=np.asarray(track_id),
        age=np.asarray(age), stamps=np.asarray(stamps))


def mark_depth_outlier(depth_tracks: FeatureTracks,
                       flagged_tracks: FeatureTracks) -> FeatureTracks:
    """Zip depth tracks with outlier annotations from a second record
    (e.g. a motion estimator's inlier classification).

    Tracks are joined by track_id; the reference instead requires
    identical ordering and throws on size mismatch — we enforce the
    same invariant (every depth track must appear in the flagged
    record) but join by id, which is order-independent.
    """
    if flagged_tracks.is_outlier is None:
        raise ValueError("flagged_tracks carries no outlier flags")
    id_to_pos = {int(t): i for i, t in enumerate(flagged_tracks.track_id)}
    n = len(depth_tracks.track_id)
    flags = np.zeros(n, dtype=bool)
    errs = np.zeros(n, dtype=np.float32)
    labels = np.zeros(n, dtype=np.int16)
    for i, tid in enumerate(depth_tracks.track_id):
        j = id_to_pos.get(int(tid))
        if j is None:
            raise ValueError(f"track {int(tid)} missing from flagged record")
        flags[i] = bool(flagged_tracks.is_outlier[j])
        if flagged_tracks.error is not None:
            errs[i] = flagged_tracks.error[j]
        if flagged_tracks.label is not None:
            labels[i] = flagged_tracks.label[j]
    return FeatureTracks(
        uv=depth_tracks.uv, depth=depth_tracks.depth,
        length=depth_tracks.length, track_id=depth_tracks.track_id,
        age=depth_tracks.age, stamps=depth_tracks.stamps,
        is_outlier=flags, error=errs, label=labels)


def semantic_labels_for_tracks(uv_newest: torch.Tensor,
                               valid: torch.Tensor,
                               semantic_image: torch.Tensor,
                               roi: int = 5,
                               num_labels: int = 256) -> torch.Tensor:
    """Assign each track the argmax semantic label in a roi×roi window
    around its newest feature (SemanticLabels nodelet semantics,
    semantic_labels.cpp:38-72; default ROI 5x5 per its .rosif config).

    Args:
      uv_newest: [N, 2] newest feature positions.
      valid: [N].
      semantic_image: [H, W] integer labels.
      roi: window side length (odd).
      num_labels: label-histogram size; labels outside [0, num_labels)
        are not counted (as jax.nn.one_hot leaves them out).

    Returns [N] int32 labels (-1 for invalid tracks); ties go to the
    smallest label.
    """
    H, W = semantic_image.shape
    dev = uv_newest.device
    half = roi // 2
    # truncation toward zero as the JAX cast; NaN -> 0 and out-of-range
    # values saturate there, so they are brought into range first
    uv = torch.clamp(torch.nan_to_num(uv_newest, nan=0.0), -2.0 ** 30,
                     2.0 ** 30).to(torch.int64)
    x0 = torch.clamp(uv[:, 0] - half, 0, W - 1)
    y0 = torch.clamp(uv[:, 1] - half, 0, H - 1)
    d = torch.arange(roi, device=dev)
    xs = torch.clamp(x0[:, None] + d[None, :], 0, W - 1)  # [N, roi]
    ys = torch.clamp(y0[:, None] + d[None, :], 0, H - 1)
    flat = (ys[:, :, None] * W + xs[:, None, :]).reshape(len(x0), roi * roi)
    labels = semantic_image.reshape(-1)[flat]  # [N, R]
    bins = torch.arange(num_labels, device=dev)
    counts = (labels[..., None] == bins).sum(1)  # [N, num_labels]
    best = torch.argmax(counts, dim=1).to(torch.int32)
    return torch.where(valid, best, -1).to(torch.int32)


def newest_pair_points(tracks: FeatureTracks
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Matched (newest, previous) point lists for frame-to-frame
    consumers (ConvertF2F).  Returns (uv_cur [M,2], uv_prev [M,2],
    track_id [M]) over tracks with length >= 2."""
    sel = tracks.length >= 2
    return (tracks.uv[sel, 0], tracks.uv[sel, 1], tracks.track_id[sel])
