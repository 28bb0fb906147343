"""The one collective of the distributed solvers (the port's `psum`).

JAX's `jax.lax.psum(x, axis_name)` inside `shard_map` becomes an
in-place `torch.distributed.all_reduce(SUM)` on the process group of the
mesh axis.  Every rank runs the same program on its own shard; the
tensors summed at one point go out as ONE flat buffer, so a point of the
program costs one collective whatever the number of tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum(group, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The sums over the ranks of `group` of tensors of one dtype and any
    shapes, in their shapes.  The inputs are left as they were."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return tuple(out)
