"""Entry points of the PyTorch/CUDA port (counterpart of
__graft_entry__.py).

entry(device)        — the single-card forward step on the flagship
                       pipeline (per-frame depth association), tiny shapes.
dryrun_multichip(n)  — one step of the three sharded programs over an
                       n-rank `torch.distributed` world at KITTI shapes:
                       frame-parallel depth association, landmark-sharded
                       bundle adjustment, edge-sharded pose graph.

    python3 -c "import __graft_entry_torch__ as g; g.dryrun_multichip(2)"

runs 2 ranks on the visible cards (NCCL when each rank has a card of its
own, gloo over CUDA tensors when ranks share one); `device="cpu"` runs
them as gloo processes on the CPU.  Nothing here imports JAX, so the
spawned ranks never load it.
"""

from __future__ import annotations

import numpy as np
import torch

from mono_lidar_depth_tpu_torch.device import Device, default_device


def _tiny_cfg():
    from mono_lidar_depth_tpu_torch import DepthEstimatorConfig

    return DepthEstimatorConfig(
        max_points=2048, max_features=128, image_width=256, image_height=128,
        ransac_num_hypotheses=128, ransac_subsample_points=512)


def _kitti_cfg():
    """Real KITTI shapes: 131k-point scans, 2048 features, 1226x370."""
    from mono_lidar_depth_tpu_torch import DepthEstimatorConfig

    return DepthEstimatorConfig(
        max_points=131072, max_features=2048,
        image_width=1226, image_height=370,
        ransac_num_hypotheses=1024, ransac_subsample_points=6000)


def _calib(cfg, device: Device):
    from mono_lidar_depth_tpu_torch import SE3, PinholeCamera

    if cfg.image_width > 256:
        cam = PinholeCamera(width=cfg.image_width, height=cfg.image_height,
                            focal_length=707.0, cx=601.8, cy=183.1)
    else:
        cam = PinholeCamera(width=256, height=128, focal_length=200.0,
                            cx=128.0, cy=64.0)
    R_lc = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float32)
    return cam, SE3(torch.from_numpy(R_lc).to(device),
                    torch.zeros(3, device=device))


def _frame_arrays(cfg, rng, batch: int | None, device: Device):
    """(cloud, valid, features, feature valid) of one frame, or of `batch`
    frames stacked; the numpy draws of __graft_entry__.py."""
    from mono_lidar_depth_tpu_torch.io.kitti import (make_synthetic_scan,
                                                     pad_cloud)

    def one():
        scan = make_synthetic_scan(rng, cfg.max_points // 2)
        cloud, valid = pad_cloud(scan, len(scan), cfg.max_points)
        feats = rng.uniform(
            [1, 1], [cfg.image_width - 1, cfg.image_height - 1],
            (cfg.max_features, 2)).astype(np.float32)
        return cloud, valid, feats, np.ones(cfg.max_features, dtype=bool)

    parts = [one() for _ in range(1 if batch is None else batch)]
    arrays = [np.stack(x) for x in zip(*parts)]
    if batch is None:
        arrays = [a[0] for a in arrays]
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def frame_draws(cfg, cvalids: torch.Tensor):
    """RANSAC draws of a frame batch: frame b's from a generator on the
    clouds' device seeded with b, whichever rank runs the frame."""
    from mono_lidar_depth_tpu_torch.core.ransac import (RansacDraws,
                                                        draw_ransac)

    draws = [draw_ransac(cvalids[b], torch.Generator(
        device=cvalids.device).manual_seed(b), cfg.ransac_num_hypotheses,
        cfg.ransac_subsample_points) for b in range(cvalids.shape[0])]
    return RansacDraws(torch.stack([d.sub_idx for d in draws]),
                       torch.stack([d.picks for d in draws]))


def ba_problem(cam, L: int, rng, device: Device):
    """K = 8 keyframes and L landmarks, observed where in front of the
    camera, with depth priors; landmarks perturbed by 0.1."""
    from mono_lidar_depth_tpu_torch.vo.ba import BAProblem

    K = 8
    X = np.stack([rng.uniform(-10, 10, L), rng.uniform(-4, 4, L),
                  rng.uniform(8, 40, L)], 1).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    ts = np.stack([np.array([0.4 * k, 0, 0.1 * k], np.float32)
                   for k in range(K)])
    obs, masks = [], []
    for k in range(K):
        p = X @ Rs[k].T + ts[k]
        uv = np.stack([cam.focal_length * p[:, 0] / p[:, 2] + cam.cx,
                       cam.focal_length * p[:, 1] / p[:, 2] + cam.cy], 1)
        obs.append(uv.astype(np.float32))
        masks.append(p[:, 2] > 1)
    noise = rng.normal(size=X.shape).astype(np.float32) * 0.1
    prior = np.stack([(X @ Rs[k].T + ts[k])[:, 2] for k in range(K)])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BAProblem(
        R=dev(Rs), t=dev(ts), landmarks=dev(X + noise),
        obs_uv=dev(np.stack(obs)), obs_mask=dev(np.stack(masks)),
        depth_prior=dev(prior.astype(np.float32)),
        depth_mask=dev(np.stack(masks)), fixed=dev(np.arange(K) == 0),
        lm_valid=dev(np.ones(L, bool)))


def kitti00_graph(rng, device: Device, n_poses: int = 4541):
    """KITTI-00-scale pose graph: a straight chain of `n_poses` (300 m x
    500 m), its odometry edges, 20 closures of span 301, positions
    perturbed by 0.05 m; pose 0 fixed."""
    from mono_lidar_depth_tpu_torch.vo.pose_graph import PoseGraph

    n = n_poses
    ang = np.linspace(0, 1.0, n).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    t = np.stack([ang * 300, np.zeros(n, np.float32), ang * 500], 1)
    ci = np.linspace(0, n - 302, 20).astype(np.int64)
    ei = np.concatenate([np.arange(n - 1), ci])
    ej = np.concatenate([np.arange(1, n), ci + 301])
    Z_R = np.einsum("nij,nik->njk", R[ei], R[ej]).astype(np.float32)
    Z_t = np.einsum("nij,ni->nj", R[ei], t[ej] - t[ei]).astype(np.float32)
    E = len(ei)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PoseGraph(
        R=dev(R), t=dev(t + rng.normal(0, 0.05, t.shape).astype(np.float32)),
        edge_i=dev(ei), edge_j=dev(ej), Z_R=dev(Z_R), Z_t=dev(Z_t),
        edge_weight=dev(np.ones(E, np.float32)),
        edge_valid=dev(np.ones(E, bool)), fixed=dev(np.arange(n) == 0))


def entry(device: Device = default_device()):
    """(fn, example_args): the forward step on one device, tiny shapes."""
    from mono_lidar_depth_tpu_torch import estimate_depths

    cfg = _tiny_cfg()
    cam, T = _calib(cfg, device)
    args = _frame_arrays(cfg, np.random.default_rng(0), None, device)

    def fn(cloud, cvalid, feats, fvalid):
        out = estimate_depths(cfg, cam, T, cloud, cvalid, feats, fvalid, None)
        return out.depths, out.codes, out.counters

    return fn, args


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def dryrun_rank(rank: int, n: int, device: torch.device) -> dict:
    """One rank of `dryrun_multichip`: the three programs at KITTI shapes,
    with __graft_entry__.py's asserts; returns what the rank saw."""
    from mono_lidar_depth_tpu_torch.dist import (
        distributed_ba, distributed_pose_graph, make_mesh,
        sharded_depth_association)

    cfg = _kitti_cfg()
    cam, T = _calib(cfg, device)
    rng = np.random.default_rng(0)

    # ---- (a) frame-parallel depth association, one frame per rank
    mesh = make_mesh(n, device=device)
    clouds, cvalids, feats, fvalids = _frame_arrays(cfg, rng, n, device)
    step = sharded_depth_association(cfg, cam, T, mesh)
    depths, codes, total = step(clouds, cvalids, feats, fvalids,
                                frame_draws(cfg, cvalids))
    _check(tuple(depths.shape) == (1, cfg.max_features),
           f"rank {rank}: depths {tuple(depths.shape)}")
    _check(int(total.sum()) == n * cfg.max_features,
           f"rank {rank}: counters sum to {int(total.sum())}")

    # ---- (b) landmark-sharded BA: K = 8, L = 1024 per rank
    mesh_lm = make_mesh(n, landmark_parallel=n, device=device)
    res = distributed_ba(cam, mesh_lm, iters=3)(ba_problem(cam, 1024 * n,
                                                           rng, device))
    _check(bool(torch.isfinite(res.final_cost)),
           f"rank {rank}: BA cost {float(res.final_cost)}")

    # ---- (c) edge-sharded pose graph, 4541 poses and 20 closures
    graph = kitti00_graph(rng, device)
    out = distributed_pose_graph(mesh, gn_iters=2, cg_iters=10)(graph)
    _check(bool(torch.isfinite(out.t).all()), f"rank {rank}: poses")
    return dict(counters=total.cpu().numpy(),
                ba_cost=(float(res.initial_cost), float(res.final_cost)),
                t=out.t.cpu().numpy())


def dryrun_multichip(n_devices: int, device: Device | None = None) -> list:
    """Run ONE step of the three sharded programs over an n-rank world:
    (a) the frame-parallel depth association (n frames, counters summed
    over the 'frame' axis), (b) the landmark-sharded distributed Schur
    BA (the reduced camera system summed over the 'landmark' axis), (c)
    the edge-sharded pose graph at KITTI-00 scale.  Ranks run on the
    visible cards, or as CPU processes with `device="cpu"`; without a card
    and without `device="cpu"` this raises.  Returns each rank's
    `dryrun_rank` record."""
    from mono_lidar_depth_tpu_torch import kernels
    from mono_lidar_depth_tpu_torch.dist.launch import run_ranks

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                               "device='cpu' for CPU ranks")
        kernels.build()  # once, before the ranks load it
    return run_ranks(dryrun_rank, n_devices, device=device, timeout=900.0)
