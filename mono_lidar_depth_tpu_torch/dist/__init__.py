"""Distribution (counterpart of dist/): device meshes and shardings, the
frame-parallel depth association, the landmark-sharded bundle adjustment
and the edge-sharded pose graph on `torch.distributed`, one process per
rank; `launch.run_ranks` starts such a world on one host."""

from .mesh import frame_sharding, make_mesh, replicated_sharding
from .sharded import (distributed_ba, distributed_pose_graph,
                      sharded_depth_association)

__all__ = ["make_mesh", "frame_sharding", "replicated_sharding",
           "distributed_ba", "distributed_pose_graph",
           "sharded_depth_association"]
