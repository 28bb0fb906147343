"""Observability: outcome statistics, per-stage timing, profiling."""

from .stats import DepthCalcStats, format_stats_report
from .timing import StageTimer

__all__ = ["DepthCalcStats", "format_stats_report", "StageTimer"]
