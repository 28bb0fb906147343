"""Sharded execution (counterpart of dist/sharded.py): frame-parallel depth
association, landmark-sharded bundle adjustment and the edge-sharded pose
graph.

Each of the three returns a function that every rank of the mesh calls with
the same whole inputs, as the JAX programs take global arrays: the rank
takes its own block (mesh.py's shardings) and computes on it, and the
sums that JAX psums are all-reduced over the process group of the mesh
axis (the `group=` forms of vo/ba.py and vo/pose_graph.py).  What comes
back is the rank's block of a sharded result and the whole of a
replicated one.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..collectives import all_reduce_sum
from ..core.depth_estimator import estimate_depths
from ..core.ransac import RansacDraws, fit_ground_plane_ransac
from ..vo.ba import BAProblem, BAResult, ba_cost, ba_iteration
from ..vo.pose_graph import PoseGraph, optimize_pose_graph
from .mesh import FRAME_AXIS, LANDMARK_AXIS, Sharding, frame_sharding


def sharded_depth_association(cfg, camera, lidar_to_cam, mesh: DeviceMesh):
    """Build a frame-batch depth-association step whose batch axis is
    sharded over the mesh's frame axis.

    Returns fn(clouds [B,P,3], cvalids [B,P], feats [B,N,2], fvalids
    [B,N], draws) -> (depths [B/F,N], codes [B/F,N], counters [21]): the
    rank's block of F = the frame-axis size, and the counters summed over
    the whole batch.  `draws` is a RansacDraws of per-frame stacks
    (sub_idx [B, S_sub], picks [B, S, 3]): frame b's plane comes from
    draws b whichever rank runs it, so any number of ranks gives the same
    bits.  Each frame is one `fit_ground_plane_ransac` + `estimate_depths`
    (JAX vmaps them; here a loop over the rank's frames, one neighbor-
    gather launch each).  B must be divisible by F."""
    frames = frame_sharding(mesh)

    def step(clouds, cvalids, feats, fvalids, draws: RansacDraws):
        depths, codes, counters = [], [], []
        rows = frames.block(clouds.shape[0])
        for b in range(rows.start, rows.stop):
            gp = fit_ground_plane_ransac(
                clouds[b], cvalids[b], sub_idx=draws.sub_idx[b],
                picks=draws.picks[b],
                distance_threshold=cfg.ransac_plane_distance_treshold,
                num_hypotheses=cfg.ransac_num_hypotheses,
                subsample=cfg.ransac_subsample_points,
                use_refinement=cfg.ransac_plane_use_refinement,
                refinement_threshold=cfg.ransac_plane_refinement_treshold)
            out = estimate_depths(cfg, camera, lidar_to_cam, clouds[b],
                                  cvalids[b], feats[b], fvalids[b], gp)
            depths.append(out.depths)
            codes.append(out.codes)
            counters.append(out.counters)
        total = torch.stack(counters).sum(0, dtype=counters[0].dtype)
        total, = all_reduce_sum(frames.group(), total)
        return torch.stack(depths), torch.stack(codes), total

    return step


def _landmark_block(problem: BAProblem, mesh: DeviceMesh) -> BAProblem:
    """This rank's landmarks: dim 0 of landmarks and lm_valid, dim 1 of
    the [K, L] observation leaves; the poses whole."""
    lm0 = Sharding(mesh, LANDMARK_AXIS, 0)
    lm1 = Sharding(mesh, LANDMARK_AXIS, 1)
    return problem._replace(
        landmarks=lm0.local(problem.landmarks),
        obs_uv=lm1.local(problem.obs_uv), obs_mask=lm1.local(problem.obs_mask),
        depth_prior=lm1.local(problem.depth_prior),
        depth_mask=lm1.local(problem.depth_mask),
        lm_valid=lm0.local(problem.lm_valid))


def distributed_ba(camera, mesh: DeviceMesh, iters: int = 8,
                   huber_px: float = 2.0, depth_weight: float = 1.0,
                   huber_depth: float = 0.5, damping: float = 1e-4):
    """Build a landmark-sharded BA solver over `mesh`'s landmark axis.

    The returned fn(problem) runs the Gauss-Newton/Schur algorithm of
    vo.ba.run_ba with the landmark dimension L split across the ranks:
    each rank assembles Hll/Hpl/W for its landmarks, the [K,K,6,6]
    reduced camera system is all-reduced, the (tiny) solve is replicated,
    and landmark updates stay local.  L must be divisible by the
    landmark-axis size, else ValueError.  The result's landmark leaves
    are the rank's block; poses and costs are whole."""
    group = mesh.get_group(LANDMARK_AXIS)

    def solve(problem: BAProblem) -> BAResult:
        pb = _landmark_block(problem, mesh)
        c0 = ba_cost(camera, pb, huber_px, depth_weight, huber_depth, group)
        for _ in range(iters):
            pb = ba_iteration(camera, pb, huber_px, depth_weight,
                              huber_depth, damping, group)
        c1 = ba_cost(camera, pb, huber_px, depth_weight, huber_depth, group)
        return BAResult(problem=pb, initial_cost=c0, final_cost=c1)

    return solve


def pad_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """The graph with its edge count padded up to a multiple of
    `multiple` by invalid edges (edge_valid False, identity measurement)
    from pose 0 to pose 0, which add nothing to any sum."""
    pad = -graph.edge_i.shape[0] % multiple
    if pad == 0:
        return graph

    def cat(x, fill):
        return torch.cat([x, fill.to(x.dtype).expand(pad, *x.shape[1:])])

    t = graph.t
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    zero = t.new_zeros(())
    return graph._replace(
        edge_i=cat(graph.edge_i, zero), edge_j=cat(graph.edge_j, zero),
        Z_R=cat(graph.Z_R, eye), Z_t=cat(graph.Z_t, zero),
        edge_weight=cat(graph.edge_weight, zero),
        edge_valid=cat(graph.edge_valid, zero))


def distributed_pose_graph(mesh: DeviceMesh, gn_iters: int = 8,
                           cg_iters: int = 60, huber: float = 0.5,
                           damping: float = 1e-6, axis: str = FRAME_AXIS):
    """Build an edge-sharded pose-graph solver over `mesh`'s `axis`.

    The returned fn(graph) runs the Gauss-Newton/PCG algorithm of
    vo.pose_graph.optimize_pose_graph with the EDGE list split across the
    ranks: each rank linearizes its edges, and the per-pose gradient,
    CG-matvec and chain-block sums are all-reduced over the axis, O(N * 6)
    numbers per CG step.  Poses (R, t, fixed) are replicated.  An edge
    count that does not split evenly is padded (`pad_edges`).  Returns
    the whole graph with the optimized poses."""
    edges = Sharding(mesh, axis, 0)
    group = mesh.get_group(axis)

    def solve(graph: PoseGraph) -> PoseGraph:
        g = pad_edges(graph, edges.size)
        local = g._replace(
            edge_i=edges.local(g.edge_i), edge_j=edges.local(g.edge_j),
            Z_R=edges.local(g.Z_R), Z_t=edges.local(g.Z_t),
            edge_weight=edges.local(g.edge_weight),
            edge_valid=edges.local(g.edge_valid))
        out = optimize_pose_graph(local, gn_iters=gn_iters, cg_iters=cg_iters,
                                  huber=huber, damping=damping, group=group)
        return graph._replace(R=out.R, t=out.t)

    return solve
