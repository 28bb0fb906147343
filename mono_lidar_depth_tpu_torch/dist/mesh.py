"""Device meshes and canonical shardings (counterpart of dist/mesh.py).

The framework's two parallel axes:

  "frame"    — data parallelism over frames (depth association is
               embarrassingly parallel per frame)
  "landmark" — model parallelism over landmark blocks in bundle
               adjustment (the reduced camera system is summed over this
               axis)

The JAX package runs one controller over a `jax.sharding.Mesh`.  The
port runs one process per rank, and each rank computes on its own
shard: the mesh is a `torch.distributed.device_mesh.DeviceMesh` of shape
(frame, landmark) over the ranks of the default process group, with one
process group per axis, and a sharding names the block of a tensor that
this rank holds.

Backends: NCCL when every rank has a card of its own; gloo (on CUDA or
CPU tensors) otherwise.  NCCL refuses two ranks on one card, so ranks
that share a card use gloo, which stages CUDA tensors through the host.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import Device, default_device

FRAME_AXIS = "frame"
LANDMARK_AXIS = "landmark"


def default_backend(device: Device, world_size: int) -> str:
    """NCCL when `device` is a card and the world has no more ranks than
    there are cards, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_mesh(n_devices: Optional[int] = None, landmark_parallel: int = 1,
              *, device: Device = default_device(),
              backend: Optional[str] = None) -> DeviceMesh:
    """Build a (frame, landmark) mesh over the ranks of the default process
    group: shape (n // landmark_parallel, landmark_parallel).

    An initialized default process group is used as it is; otherwise one
    is initialized from the environment (`MASTER_ADDR`, `MASTER_PORT`,
    `RANK`, `WORLD_SIZE`, as torchrun sets them) with `backend`, by
    default `default_backend(device, WORLD_SIZE)`.  `device` is this
    rank's device (a rank of a multi-card world passes its own card); a
    CUDA device is made current.  `n_devices` defaults to the world size
    and must equal it."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        dist.init_process_group(backend or default_backend(device, world))
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()}, not {backend}")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices % landmark_parallel != 0:
        raise ValueError("n_devices must be divisible by landmark_parallel")
    if n_devices != world:
        raise ValueError(f"a mesh over {n_devices} ranks in a world of "
                         f"{world}")
    return init_device_mesh(
        device.type, (n_devices // landmark_parallel, landmark_parallel),
        mesh_dim_names=(FRAME_AXIS, LANDMARK_AXIS))


class Sharding(NamedTuple):
    """This rank's block of dimension `dim` of a tensor split evenly over
    the ranks of mesh axis `axis` (`axis` None: replicated, the whole
    tensor)."""

    mesh: DeviceMesh
    axis: Optional[str]
    dim: int = 0

    @property
    def size(self) -> int:
        return 1 if self.axis is None else self.mesh.size(
            self.mesh.mesh_dim_names.index(self.axis))

    @property
    def rank(self) -> int:
        return 0 if self.axis is None else self.mesh.get_local_rank(self.axis)

    def block(self, n: int) -> slice:
        """The indices of this rank's block of a dimension of length n."""
        if n % self.size != 0:
            raise ValueError(f"a dimension of {n} does not split over the "
                             f"{self.size} ranks of axis {self.axis!r}")
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of x (a view)."""
        b = self.block(x.shape[self.dim])
        return x.narrow(self.dim, b.start, b.stop - b.start)

    def group(self):
        """The process group of the axis (None: replicated, nothing to
        sum)."""
        return None if self.axis is None else self.mesh.get_group(self.axis)


def frame_sharding(mesh: DeviceMesh, dim: int = 0) -> Sharding:
    """Dimension `dim` (the frame batch) sharded over frames."""
    return Sharding(mesh, FRAME_AXIS, dim)


def landmark_sharding(mesh: DeviceMesh, dim: int = 0) -> Sharding:
    """Dimension `dim` (the landmarks) sharded over the landmark axis."""
    return Sharding(mesh, LANDMARK_AXIS, dim)


def replicated_sharding(mesh: DeviceMesh) -> Sharding:
    """The whole tensor on every rank."""
    return Sharding(mesh, None)
