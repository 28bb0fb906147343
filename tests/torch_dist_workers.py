"""Rank programs of tests/test_torch_dist.py.

They run in processes spawned by `mono_lidar_depth_tpu_torch.dist.launch
.run_ranks`, which import this module by name: it imports torch, numpy
and the port, never JAX.  Inputs arrive as numpy arrays; results go back
as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensors(tree):
    return type(tree)(*(torch.from_numpy(np.asarray(x)) for x in tree))


def _numpy(tree):
    return tuple(np.asarray(x) for x in tree)


def mesh_facts(n: int, device) -> dict:
    """Shapes, axis names and per-axis ranks of the meshes of an n-rank
    world, the sharding blocks, and the errors of bad splits."""
    from mono_lidar_depth_tpu_torch.dist import mesh as M

    facts = {}
    for lp in (1, 2, n):
        mesh = M.make_mesh(n, landmark_parallel=lp, device=device)
        facts[lp] = dict(
            shape=tuple(mesh.shape), names=tuple(mesh.mesh_dim_names),
            frame_rank=mesh.get_local_rank(M.FRAME_AXIS),
            landmark_rank=mesh.get_local_rank(M.LANDMARK_AXIS),
            frame_block=M.frame_sharding(mesh).local(torch.arange(2 * n)
                                                     ).tolist(),
            landmark_block=M.landmark_sharding(mesh, dim=1).local(
                torch.arange(4 * n).reshape(2, 2 * n)).tolist(),
            replicated=M.replicated_sharding(mesh).local(
                torch.arange(3)).tolist())
    errors = []
    for bad in (dict(n_devices=n, landmark_parallel=3),
                dict(n_devices=2 * n)):
        try:
            M.make_mesh(device=device, **bad)
        except ValueError as e:
            errors.append(str(e))
    facts["errors"] = errors
    return facts


def programs(rank: int, n: int, device, inp: dict) -> dict:
    """The three sharded programs of an n-rank world on the inputs of
    test_torch_dist.py; in a world of one also their group=None forms."""
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
    from mono_lidar_depth_tpu_torch.dist import (
        distributed_ba, distributed_pose_graph, make_mesh,
        sharded_depth_association)
    from mono_lidar_depth_tpu_torch.vo import pose_graph as pg
    from mono_lidar_depth_tpu_torch.vo.ba import BAProblem, run_ba

    out = {"mesh": mesh_facts(n, device)} if n == 4 else {}
    mesh = make_mesh(n, device=device)

    cfg = T.DepthEstimatorConfig(**inp["cfg"])
    l2c = T.SE3(*map(torch.from_numpy, inp["lidar_to_cam"]))
    step = sharded_depth_association(cfg, T.PinholeCamera(**inp["camera"]),
                                     l2c, mesh)
    out["assoc"] = _numpy(step(*map(torch.from_numpy, inp["frames"]),
                               RansacDraws(*map(torch.from_numpy,
                                                inp["draws"]))))

    cam = T.PinholeCamera(**inp["ba_camera"])
    problem = _tensors(BAProblem(*inp["ba"]))
    mesh_lm = make_mesh(n, landmark_parallel=n, device=device)
    out["ba"] = {}
    for iters in inp["ba_iters"]:
        res = distributed_ba(cam, mesh_lm, iters=iters)(problem)
        out["ba"][iters] = (res.problem.R.numpy(), res.problem.t.numpy(),
                            res.problem.landmarks.numpy(),
                            float(res.initial_cost), float(res.final_cost))
        if n == 1:
            one = run_ba(cam, problem, iters=iters)
            out["ba"][iters, None] = (
                one.problem.R.numpy(), one.problem.t.numpy(),
                one.problem.landmarks.numpy(), float(one.initial_cost),
                float(one.final_cost))

    graph = _tensors(pg.PoseGraph(*inp["graph"]))
    counts = []
    real_pcg = pg._pcg

    def counted(*args, **kwargs):
        x, iterations = real_pcg(*args, **kwargs)
        counts.append(int(iterations))
        return x, iterations

    pg._pcg = counted
    try:
        res = distributed_pose_graph(mesh, **inp["pg_kw"])(graph)
    finally:
        pg._pcg = real_pcg
    out["pg"] = (res.R.numpy(), res.t.numpy(), counts)
    if n == 1:
        one = pg.optimize_pose_graph(graph, **inp["pg_kw"])
        out["pg", None] = (one.R.numpy(), one.t.numpy())
    return out
