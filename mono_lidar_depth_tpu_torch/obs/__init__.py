"""Observability: outcome statistics, per-stage timing, the program's own
spans, profiling."""

from .stats import DepthCalcStats, format_stats_report
from .timing import StageTimer, frame_spans, span

__all__ = ["DepthCalcStats", "format_stats_report", "StageTimer",
           "frame_spans", "span"]
