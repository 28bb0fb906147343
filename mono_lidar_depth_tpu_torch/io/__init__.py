"""I/O: KITTI odometry dataset, native prefetching reader, synthetic
sequences, track export, checkpoints."""

from .checkpoint import load_checkpoint, save_checkpoint
from .kitti import KittiCalib, KittiSequence, pad_cloud, read_velodyne
from .messages import FeatureTracks, tracks_from_table

__all__ = ["KittiCalib", "KittiSequence", "read_velodyne", "pad_cloud",
           "FeatureTracks", "tracks_from_table", "load_checkpoint",
           "save_checkpoint"]
