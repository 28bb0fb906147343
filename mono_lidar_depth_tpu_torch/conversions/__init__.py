"""Track-record conversions (reference layers L-conv / L-conv-tool)."""

from .convert import (add_outlier_flags, lift_to_depth, mark_depth_outlier,
                      newest_pair_points, semantic_labels_for_tracks)

__all__ = ["add_outlier_flags", "lift_to_depth", "mark_depth_outlier",
           "newest_pair_points", "semantic_labels_for_tracks"]
