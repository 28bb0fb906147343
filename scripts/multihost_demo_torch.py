#!/usr/bin/env python3
"""Multi-process distributed BA (counterpart of scripts/multihost_demo.py).

The landmark-sharded Schur BA (`dist.distributed_ba`) over a
`torch.distributed` world that spans separate processes, each started as
its own interpreter, checked against the single-process `run_ba` on the
same problem: the reference's numpy data (`default_rng(0)`, K = 4 poses,
L = 256 landmarks, `PinholeCamera(640, 480, 500, 320, 240)`, 6
iterations).

    python3 scripts/multihost_demo_torch.py                # spawns 2 processes
    python3 scripts/multihost_demo_torch.py --device cpu
    python3 scripts/multihost_demo_torch.py --worker N --port P   # internal

Process 0 prints the reference's JSON line.  Where it departs from the
reference:
  * A `torch.distributed` process holds one rank, where a `jax.distributed`
    process holds all of its local devices.  The reference's 2 processes
    hold 2 virtual devices each, 4 in all; here the same 2 processes hold
    one rank each, so `global_devices` is 2.  The problem keeps the
    reference's size (L = 64 x its 4 devices), which splits evenly over 2.
  * The ranks meet at a free port that the parent picks and passes with
    `--port`, not at a fixed one; `--device` (default cuda:0) takes the
    place of the reference's CPU platform: both ranks on card 0 over gloo
    (NCCL refuses two ranks on one card), or on the CPU.  Without a card
    the script exits 1 unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

NPROC = 2
REFERENCE_GLOBAL_DEVICES = 4  # the reference's 2 processes x 2 devices
ITERS = 6
WORKER_TIMEOUT_S = 600


def problem_arrays() -> tuple:
    """The reference's problem as numpy arrays, in BAProblem's field
    order, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)  # identical data in every process
    K, L = 4, 64 * REFERENCE_GLOBAL_DEVICES
    X = np.stack([rng.uniform(-10, 10, L), rng.uniform(-4, 4, L),
                  rng.uniform(8, 40, L)], 1).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    ts = np.stack([np.array([0.5 * k, 0, 0.2 * k], np.float32)
                   for k in range(K)])
    obs, masks, dpri = [], [], []
    for k in range(K):
        p = X @ Rs[k].T + ts[k]
        uv = np.stack([500.0 * p[:, 0] / p[:, 2] + 320.0,
                       500.0 * p[:, 1] / p[:, 2] + 240.0], 1)
        uv += rng.normal(size=uv.shape).astype(np.float32) * 0.5
        obs.append(uv.astype(np.float32))
        masks.append(p[:, 2] > 1)
        dpri.append(p[:, 2].astype(np.float32))
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.2
    return (Rs, ts, X0, np.stack(obs), np.stack(masks), np.stack(dpri),
            np.stack(masks), np.arange(K) == 0, np.ones(L, bool))


def worker(process_id: int, port: int, device: str) -> dict:
    """One rank: join the world, solve sharded and single-process; process
    0 prints and returns the reference's record."""
    import torch.distributed as dist

    from mono_lidar_depth_tpu_torch import PinholeCamera
    from mono_lidar_depth_tpu_torch.dist.mesh import default_backend
    from mono_lidar_depth_tpu_torch.dist.sharded import distributed_ba
    from mono_lidar_depth_tpu_torch.dist import make_mesh
    from mono_lidar_depth_tpu_torch.vo.ba import BAProblem, run_ba

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        default_backend(dev, NPROC), init_method=f"tcp://localhost:{port}",
        rank=process_id, world_size=NPROC,
        timeout=timedelta(seconds=WORKER_TIMEOUT_S))
    try:
        cam = PinholeCamera(640, 480, 500.0, 320.0, 240.0)
        problem = BAProblem(*(torch.from_numpy(x).to(dev)
                              for x in problem_arrays()))
        mesh = make_mesh(NPROC, landmark_parallel=NPROC, device=dev)
        res = distributed_ba(cam, mesh, iters=ITERS)(problem)
        final_cost = float(res.final_cost)
        ref = run_ba(cam, problem, iters=ITERS)  # single-process, local
        ref_cost = float(ref.final_cost)
    finally:
        dist.destroy_process_group()
    ok = abs(final_cost - ref_cost) <= 1e-3 * max(1.0, ref_cost)
    out = {"multihost_processes": NPROC,
           "global_devices": NPROC,
           "distributed_final_cost": round(final_cost, 4),
           "single_process_final_cost": round(ref_cost, 4),
           "match": bool(ok)}
    if process_id == 0:
        print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device type of the ranks (default cuda:0; "
                         "'cpu' runs CPU ranks)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        print("multihost_demo_torch: no CUDA device; pass --device cpu for a "
              "run on the CPU", file=sys.stderr)
        return 1
    if args.worker is not None:
        worker(args.worker, args.port, args.device)
        return 0
    from mono_lidar_depth_tpu_torch.dist.launch import _free_port

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(pid),
         "--port", str(port), "--device", args.device],
        stdout=None if pid == 0 else subprocess.DEVNULL)
        for pid in range(NPROC)]
    try:
        codes = [p.wait(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        print(f"multihost_demo_torch: worker exit codes {codes}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
