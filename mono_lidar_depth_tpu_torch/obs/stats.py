"""Depth-calculation outcome statistics (counterpart of obs/stats.py).

Per-frame counters are a [NUM_RESULT_TYPES] int32 histogram of the
result codes of the valid features (`count_codes`); `DepthCalcStats`
accumulates them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.result_types import NUM_RESULT_TYPES, DepthResultType as R
from ..device import Device, default_device


def count_codes(codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Outcome histogram [NUM_RESULT_TYPES] int32 of codes[valid].

    Invalid lanes go to an extra bin that is dropped, so no boolean
    indexing is needed; an index_add_ rather than `torch.bincount`,
    which reads its input's maximum back to the host on CUDA."""
    binned = torch.where(valid, codes.long(), NUM_RESULT_TYPES)
    hist = torch.zeros(NUM_RESULT_TYPES + 1, dtype=torch.int32,
                       device=codes.device)
    hist.index_add_(0, binned, torch.ones_like(binned, dtype=torch.int32))
    return hist[:NUM_RESULT_TYPES]


class DepthCalcStats(NamedTuple):
    """Accumulated + last-frame outcome counters."""

    accumulated: torch.Tensor  # [NUM_RESULT_TYPES] int32
    last_frame: torch.Tensor  # [NUM_RESULT_TYPES]
    frames: torch.Tensor  # [] int32
    points: torch.Tensor  # [] int32

    @classmethod
    def zeros(cls, device: Device = default_device()) -> "DepthCalcStats":
        z = torch.zeros(NUM_RESULT_TYPES, dtype=torch.int32, device=device)
        s = torch.zeros((), dtype=torch.int32, device=device)
        return cls(accumulated=z, last_frame=z, frames=s, points=s)

    def update(self, frame_counters: torch.Tensor) -> "DepthCalcStats":
        return DepthCalcStats(
            accumulated=self.accumulated + frame_counters,
            last_frame=frame_counters,
            frames=self.frames + 1,
            points=self.points + frame_counters.sum(dtype=torch.int32))


def success_rates(counters) -> dict:
    """Success rate over all points and over lidar-covered points, from
    host-side counters (numpy array or list)."""
    counters = np.asarray(counters)
    total = int(counters.sum())
    success = int(counters[R.Success] + counters[R.SuccessRoad]
                  + counters[R.SuccessRegionGrowing])
    covered = max(total - int(counters[R.RadiusSearchInsufficientPoints]), 1)
    return {
        "total_points": total,
        "success": success,
        "success_rate_all": success / max(total, 1),
        "success_rate_lidar_covered": success / covered,
    }


def format_stats_report(stats: DepthCalcStats) -> str:
    """Human-readable dump in the spirit of
    DepthCalculationStatistics::ToFile (absolute, % of all, % of
    lidar-covered).  Reads the counters back to the host."""
    acc = stats.accumulated.cpu().numpy()
    rates = success_rates(acc)
    total = max(rates["total_points"], 1)
    covered = max(total - int(acc[R.RadiusSearchInsufficientPoints]), 1)
    lines = [
        f"frames: {int(stats.frames)}  feature points: {total}",
        f"success (all): {rates['success']} = {100.0 * rates['success_rate_all']:.2f}%",
        f"success (lidar-covered): {100.0 * rates['success_rate_lidar_covered']:.2f}%",
        "",
        f"{'outcome':42s} {'count':>10s} {'% all':>8s} {'% covered':>10s}",
    ]
    for code in R:
        c = int(acc[code])
        if c == 0 and code not in (R.Success, R.RadiusSearchInsufficientPoints):
            continue
        lines.append(
            f"{code.name:42s} {c:10d} {100.0 * c / total:8.2f} "
            f"{100.0 * c / covered:10.2f}")
    return "\n".join(lines)
