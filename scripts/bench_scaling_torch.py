#!/usr/bin/env python3
"""Scaling of the port's sharded programs over 1..N ranks (counterpart of
scripts/bench_scaling.py): frame-parallel depth association and
landmark-sharded bundle adjustment.

    python3 scripts/bench_scaling_torch.py                 # ranks 1 2 4
    python3 scripts/bench_scaling_torch.py --ranks 1 2 --device cpu

Every world is a set of processes spawned by
`mono_lidar_depth_tpu_torch.dist.launch.run_ranks`, one rank each, on the
visible cards: rank r on card r % torch.cuda.device_count().  Where a world
has more ranks than there are cards, the ranks share cards over gloo (NCCL
refuses two ranks on one card), which stages every all-reduce through the
host; on one card no scaling is measured, as the reference's virtual CPU
mesh measured none.  Each line's `note` says how many cards the ranks had.

Prints one JSON line per workload with the reference's keys (`devices`
holds the world sizes).  Where it departs from the reference:
  * `--ranks` (default 1 2 4) takes the place of `--devices` (1 2 4 8),
    and `--device` (default cuda:0) that of `--platform`; without a card
    the script exits 1 unless given `--device cpu`.
  * The RANSAC draws of the association come from a numpy generator
    (`draws`), not from jax.random keys; the clouds, features and the BA
    problem are the reference's numpy data.
  * On stderr, one more JSON line {"port": ...}: the card (nvidia-smi's
    name and power limit), the torch version, the seconds of each world
    and the kernel launches of all ranks.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402  (the repo root is on the path now)
from mono_lidar_depth_tpu_torch import (  # noqa: E402
    SE3, DepthEstimatorConfig, PinholeCamera)
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws  # noqa: E402
from mono_lidar_depth_tpu_torch.dist import (  # noqa: E402
    distributed_ba, make_mesh, sharded_depth_association)
from mono_lidar_depth_tpu_torch.dist.launch import run_ranks  # noqa: E402
from mono_lidar_depth_tpu_torch.obs.launches import (  # noqa: E402
    kernel_launches, launches_since)
from mono_lidar_depth_tpu_torch.vo.ba import BAProblem  # noqa: E402

CFG = dict(max_points=16384, max_features=512, image_width=640,
           image_height=192, ransac_num_hypotheses=256,
           ransac_subsample_points=2048)
CAMERA = (640, 192, 350.0, 320.0, 96.0)
R_LC = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float32)
BA_K, BA_L_PER_RANK, BA_ITERS = 8, 512, 8
REPS = 5  # timed calls per world, after one untimed call
RANK_TIMEOUT_S = 600.0


def workload_inputs(max_ranks: int) -> dict:
    """The reference's numpy data, drawn in its order from
    default_rng(0): B = 2 * max_ranks clouds and feature sets, then the BA
    problem at L = 512 * max_ranks landmarks; the RANSAC draws from
    default_rng(1)."""
    cfg = DepthEstimatorConfig(**CFG)
    rng = np.random.default_rng(0)
    B = max_ranks * 2
    clouds = rng.uniform([2, -15, -2], [60, 15, 3],
                         (B, cfg.max_points, 3)).astype(np.float32)
    feats = rng.uniform([2, 2], [638, 190],
                        (B, cfg.max_features, 2)).astype(np.float32)
    frames = (clouds, np.ones((B, cfg.max_points), bool), feats,
              np.ones((B, cfg.max_features), bool))
    draw = np.random.default_rng(1)
    draws = (draw.integers(0, cfg.max_points,
                           (B, cfg.ransac_subsample_points)),
             draw.integers(0, cfg.ransac_subsample_points,
                           (B, cfg.ransac_num_hypotheses, 3)))

    K, L = BA_K, BA_L_PER_RANK * max_ranks
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-5, 5, L),
                  rng.uniform(5, 60, L)], 1).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    ts = np.stack([np.array([0.5 * k, 0, 0.2 * k], np.float32)
                   for k in range(K)])
    obs, masks, dpri = [], [], []
    for k in range(K):
        p = X @ Rs[k].T + ts[k]
        uv = np.stack([350.0 * p[:, 0] / p[:, 2] + 320.0,
                       350.0 * p[:, 1] / p[:, 2] + 96.0], 1)
        uv += rng.normal(size=uv.shape) * 0.5
        obs.append(uv.astype(np.float32))
        masks.append(p[:, 2] > 1)
        dpri.append(p[:, 2].astype(np.float32))
    problem = BAProblem(
        R=Rs, t=ts,
        landmarks=X + rng.normal(size=X.shape).astype(np.float32) * 0.2,
        obs_uv=np.stack(obs), obs_mask=np.stack(masks),
        depth_prior=np.stack(dpri), depth_mask=np.stack(masks),
        fixed=np.arange(K) == 0, lm_valid=np.ones(L, bool))
    return {"frames": frames, "draws": draws, "ba": tuple(problem)}


def rank_program(rank: int, n: int, device, inp: dict, reps: int) -> dict:
    """Both workloads on one rank of an n-rank world: one untimed call,
    then `reps` timed calls, each ended by a host read of its result (the
    reference's block_until_ready).  Returns the seconds of each and the
    rank's kernel launches."""
    cfg = DepthEstimatorConfig(**CFG)
    cam = PinholeCamera(*CAMERA)
    l2c = SE3(torch.from_numpy(R_LC).to(device),
              torch.zeros(3, device=device))
    before = kernel_launches()
    out = {}

    mesh = make_mesh(n, device=device)
    step = sharded_depth_association(cfg, cam, l2c, mesh)
    frames = [torch.from_numpy(x).to(device) for x in inp["frames"]]
    draws = RansacDraws(*(torch.from_numpy(x).to(device)
                          for x in inp["draws"]))
    float(step(*frames, draws)[0].sum())
    t0 = time.perf_counter()
    for _ in range(reps):
        float(step(*frames, draws)[0].sum())
    out["depth_s"] = time.perf_counter() - t0

    problem = BAProblem(*(torch.from_numpy(np.asarray(x)).to(device)
                          for x in inp["ba"]))
    solver = distributed_ba(cam, make_mesh(n, landmark_parallel=n,
                                           device=device), iters=BA_ITERS)
    float(solver(problem).final_cost)
    t0 = time.perf_counter()
    for _ in range(reps):
        float(solver(problem).final_cost)
    out["ba_s"] = time.perf_counter() - t0
    out["launches"] = launches_since(before)
    return out


def _note(kind: str, ranks: Sequence[int], what: str) -> str:
    if kind == "cpu":
        return (f"CPU ranks (one thread each) share this host's cores - "
                f"{what}; this run validates the sharded program structure")
    cards = torch.cuda.device_count()
    return (f"{max(ranks)} ranks on {cards} card(s) "
            f"(torch.cuda.device_count()): ranks beyond {cards} share a "
            f"card over gloo - {what}")


def run(ranks: Sequence[int] = (1, 2, 4), device="cuda:0",
        reps: int = REPS) -> dict:
    """Both workloads at every world size in `ranks`; prints the
    reference's two JSON lines and returns {"lines": [...], "port": ...}.
    The rank programs are this module's `rank_program`: spawned ranks
    import this module by name, so run it as a script or import it with
    its directory on sys.path."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_scaling_torch: no CUDA device; pass "
                           "device='cpu' for a run on the CPU")
    inp = workload_inputs(max(ranks))
    B = len(inp["frames"][0])
    fps, solves, seconds = [], [], []
    launches = {k: 0 for k in kernel_launches()}
    for n in ranks:
        t0 = time.perf_counter()
        outs = run_ranks(rank_program, n, (inp, reps), device=dev,
                         timeout=RANK_TIMEOUT_S)
        seconds.append(time.perf_counter() - t0)
        fps.append(reps * B / max(o["depth_s"] for o in outs))
        solves.append(reps / max(o["ba_s"] for o in outs))
        for o in outs:
            for k, v in o["launches"].items():
                launches[k] += v
    scale = ranks[-1] / ranks[0]
    lines = [
        {"workload": "depth_association_frame_parallel",
         "devices": list(ranks),
         "frames_per_s": [round(f, 1) for f in fps],
         "efficiency_at_max": round((fps[-1] / fps[0]) / scale, 3),
         "note": _note(dev.type, ranks, "efficiency is only meaningful "
                       "with a card per rank")},
        {"workload": "distributed_schur_ba",
         "devices": list(ranks),
         "solves_per_s": [round(s, 2) for s in solves],
         "efficiency_at_max": round((solves[-1] / solves[0]) / scale, 3),
         "note": _note(dev.type, ranks, "the per-rank landmark shard is "
                       "L/D, so work scales down 1/D per rank; wall-clock "
                       "efficiency needs a card per rank")}]
    for line in lines:
        print(json.dumps(line), flush=True)
    return {"lines": lines, "port": {
        "card": bench_torch.card_line(dev), "torch": torch.__version__,
        "device": str(dev), "cards": (torch.cuda.device_count()
                                      if dev.type == "cuda" else 0),
        "world_seconds": seconds, "launches": launches}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--device", default="cuda:0",
                    help="torch device type of the ranks (default cuda:0: "
                         "the visible cards; 'cpu' runs CPU ranks)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        print("bench_scaling_torch: no CUDA device; pass --device cpu for a "
              "run on the CPU", file=sys.stderr)
        return 1
    out = run(args.ranks, args.device)
    print(json.dumps({"port": out["port"]}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
