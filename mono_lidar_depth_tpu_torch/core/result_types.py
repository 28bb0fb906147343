"""Depth-calculation result taxonomy.

Numeric values match the reference enum exactly
(`monolidar_fusion/include/monolidar_fusion/eDepthResultType.h:9-31`) so
result-code statistics are directly comparable.
"""

from __future__ import annotations

import enum


class DepthResultType(enum.IntEnum):
    Unspecified = 0
    Success = 1
    RadiusSearchInsufficientPoints = 2
    HistogramNoLocalMax = 3
    TresholdDepthGlobalGreaterMax = 4
    TresholdDepthGlobalSmallerMin = 5
    TresholdDepthLocalGreaterMax = 6
    TresholdDepthLocalSmallerMin = 7
    TriangleNotPlanar = 8
    TriangleNotPlanarInsufficientPoints = 9
    CornerBehindCamera = 10
    PlaneViewrayNotOrthogonal = 11
    PcaIsPoint = 12
    PcaIsLine = 13
    PcaIsCubic = 14
    InsufficientRoadPoints = 15
    SuccessRoad = 16
    RegionGrowingNearestSeedNotAvailable = 17
    RegionGrowingSeedsOutOfRange = 18
    RegionGrowingInsufficientPoints = 19
    SuccessRegionGrowing = 20


NUM_RESULT_TYPES = 21

# Result codes that carry a valid depth.
SUCCESS_CODES = (
    DepthResultType.Success,
    DepthResultType.SuccessRoad,
    DepthResultType.SuccessRegionGrowing,
)
