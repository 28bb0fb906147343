#!/usr/bin/env python3
"""Endurance record of the PyTorch/CUDA port (counterpart of
scripts/endurance_run.py): one long multi-lap sequence end to end, VO +
sliding-window BA + the pose-graph backend, with a checkpoint/resume
equivalence check halfway.

    python3 scripts/endurance_run_torch.py                  # 2048 frames on cuda:0
    python3 scripts/endurance_run_torch.py --frames 256 --checkpoint-at 128
    python3 scripts/endurance_run_torch.py --device cpu --frames 48 \\
        --checkpoint-at 24 --tag cpu_smoke

Stages, the reference's five through the port's public API:
  1. render the loop sequence (384x128, laps of LAP_FRAMES frames) in
     memory with `render_sequence`;
  2. straight-through VO (`eval_vo_sequence`, chunked): wall time, ms per
     frame, ATE;
  3. checkpointed run: stop at `--checkpoint-at`, save the carry to the
     on-disk .npz format, load it, resume; the stitched trajectory must
     match stage 2's to 1e-5 (the port's resume is bit-identical);
  4. the backend on stage 2's trajectory: lap-scaled metric proposals
     unioned with the appearance proposals, verification of each pair
     (measured once, through a memo that both legs and the consistency
     filter's remeasure share), the consistency filter, the calibrated
     chain-preconditioned solve;
  5. the same chain under injected drift (0.05 deg/frame of yaw and 3% of
     scale on the VO output; images and scans untouched);
then ENDURANCE_<tag>.json at the repo root, and one JSON line per stage
on stdout.

Where it departs from the reference:
  * The sequence is rendered in memory, not written as PNGs (the images
    are the same bytes; Pillow is not needed), so there is no `--seq-dir`.
  * `--device` (default cuda:0) takes the place of `--platform`; without
    a card the script exits 1 unless given `--device cpu`.
  * The default tag is `torch_h100`, and the tags of the reference's own
    records (REFERENCE_TAGS) are refused: their files are the JAX
    package's history.
  * `backend` holds the torch device; the record adds `port`: the card
    (nvidia-smi's name and power limit), the torch version, the kernel
    launches of each stage, the verification directions and their
    seconds, the appearance proposer's seconds, and the seconds and GN
    iterations of every pose-graph solve.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402  (the repo root is on the path now)
from mono_lidar_depth_tpu_torch import DepthEstimatorConfig, precision  # noqa: E402
from mono_lidar_depth_tpu_torch.eval import (  # noqa: E402
    eval_vo_sequence, propose_loop_closures,
    propose_loop_closures_appearance, run_pose_graph_backend,
    union_closure_candidates)
from mono_lidar_depth_tpu_torch.eval.kitti_eval import (  # noqa: E402
    closure_constraint_from_frames, filter_consistent_closures)
from mono_lidar_depth_tpu_torch.io.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from mono_lidar_depth_tpu_torch.io.synthetic_dataset import (  # noqa: E402
    SyntheticSpec, render_sequence)
from mono_lidar_depth_tpu_torch.obs.launches import (  # noqa: E402
    kernel_launches, launches_since)
from mono_lidar_depth_tpu_torch.vo import closures  # noqa: E402
from mono_lidar_depth_tpu_torch.vo.metrics import ate_rmse  # noqa: E402

W, H = 384, 128
LAP_FRAMES = 220  # frames per lap of the circuit
REFERENCE_TAGS = ("r4", "r5")  # ENDURANCE_r4.json, ENDURANCE_r5.json
DRIFT_YAW_DEG = 0.05  # injected yaw bias per frame (stage 5)
DRIFT_SCALE = 1.03  # injected scale error per frame (stage 5)
INJECTED = "0.05 deg/frame yaw bias + 3% scale error"  # the record's text
VO_KW = dict(max_tracks=384, max_length=8, verbose=False)


def endurance_spec(frames: int, lap_frames: int = LAP_FRAMES
                   ) -> SyntheticSpec:
    """The reference's sequence: a multi-lap loop at 384x128."""
    return SyntheticSpec(frames=frames, image_width=W, image_height=H,
                         focal=240.0, lidar_rows=20, lidar_cols=500,
                         step=0.55, loop=True, lap_frames=lap_frames)


def endurance_config() -> DepthEstimatorConfig:
    """The reference's depth-association configuration."""
    return DepthEstimatorConfig(
        max_points=16384, max_features=384, image_width=W, image_height=H,
        radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)


def laps_of(spec: SyntheticSpec) -> int:
    """Whole laps of the spec's circuit (the closure budgets scale with
    it); at LAP_FRAMES this is the reference's `frames // 220`."""
    return max(1, spec.frames // (spec.lap_frames or spec.frames))


def vo_stage(seq, cfg, device) -> tuple[dict, dict]:
    """Stage 2: straight-through VO.  Returns (eval_vo_sequence's dict,
    the record's `vo` entry)."""
    t0 = time.perf_counter()
    vo = eval_vo_sequence(seq, cfg, device=device, **VO_KW)
    wall = time.perf_counter() - t0
    gt = seq.gt_poses[vo["frame_ids"]]
    ate = float(ate_rmse(vo["poses"][:, :3, 3], gt[:, :3, 3]))
    return vo, {"frames": vo["frames"], "wall_s": round(wall, 1),
                "ms_per_frame": round(1e3 * wall / vo["frames"], 1),
                "ate_rmse_m": round(ate, 3)}


def resume_stage(seq, cfg, device, checkpoint_at: int,
                 straight: np.ndarray, workdir: str) -> dict:
    """Stage 3: run to `checkpoint_at`, save the carry to an .npz, load
    it, resume; the stitched poses against stage 2's `straight`."""
    part1 = eval_vo_sequence(seq, cfg, device=device,
                             max_frames=checkpoint_at, return_carry=True,
                             **VO_KW)
    ckpt = str(Path(workdir) / "vo_checkpoint.npz")
    save_checkpoint(ckpt, part1["carry"], {"next_frame": checkpoint_at})
    carry, meta = load_checkpoint(ckpt, part1["carry"])
    part2 = eval_vo_sequence(seq, cfg, device=device,
                             start_frame=meta["next_frame"],
                             init_carry=carry, **VO_KW)
    stitched = np.concatenate([part1["poses"], part2["poses"]])
    max_dev = float(np.abs(stitched - straight).max())
    return {"checkpoint_frame": checkpoint_at,
            "checkpoint_bytes": Path(ckpt).stat().st_size,
            "max_pose_deviation": max_dev,
            "equivalent": bool(max_dev < 1e-5)}


class ClosureMemo:
    """Verification of a frame pair, measured once: the nominal and the
    drifted leg propose many of the same pairs, and the consistency
    filter's remeasure repeats hops.  Every miss is one
    `closure_constraint_from_frames` call (two directions) with the
    port's own RANSAC generator (`vo/closures._closure_rng`), so a
    remeasure returns the first measurement.  `calls` and `seconds`
    count the misses."""

    def __init__(self, seq, cfg, device):
        self.seq, self.cfg, self.device = seq, cfg, device
        self.memo: dict = {}
        self.calls = 0
        self.seconds = 0.0

    def __call__(self, fi: int, fj: int):
        key = (fi, fj)
        if key not in self.memo:
            t0 = time.perf_counter()
            self.memo[key] = closure_constraint_from_frames(
                self.seq, self.cfg, fi, fj,
                max_features=self.cfg.max_features, device=self.device)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
        return self.memo[key]


def appearance_candidates(seq, frame_ids, laps: int,
                          min_gap: int = 100) -> list:
    """The pose-free appearance proposals, computed once for both legs."""
    return propose_loop_closures_appearance(
        seq, [int(f) for f in frame_ids], min_gap=min_gap, stride=4,
        max_candidates=8 * laps)


class SolveTimes:
    """While open, the seconds and GN iterations of every
    `optimize_pose_graph` call the backend makes (one without a folded
    odometry bias, two with one)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.solves: list = []

    def __enter__(self):
        self.real = closures.optimize_pose_graph

        def timed(g, gn_iters, **kw):
            t0 = time.perf_counter()
            out = self.real(g, gn_iters=gn_iters, **kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.solves.append((time.perf_counter() - t0, gn_iters))
            return out

        closures.optimize_pose_graph = timed
        return self

    def __exit__(self, *exc):
        closures.optimize_pose_graph = self.real


def backend_leg(traj: np.ndarray, label: str, frame_ids, gt: np.ndarray,
                laps: int, cands_app: list, measure, device,
                min_gap: int = 100) -> tuple[dict, float, float, np.ndarray]:
    """Stages 4 and 5: the reference's chain on one trajectory estimate:
    lap-scaled drift-aware metric proposals unioned with the appearance
    proposals, verification, the consistency filter, the calibrated
    solve.  Returns (the record's entry, ATE in, ATE after the backend,
    the optimized poses or None without a closure)."""
    cands = union_closure_candidates(
        propose_loop_closures(
            traj, min_gap=min_gap, radius=8.0, stride=4,
            max_candidates=16 * laps, min_candidates=2 * laps),
        cands_app)
    found = []
    t0 = time.perf_counter()
    for (i, j) in cands:
        z = measure(frame_ids[i], frame_ids[j])
        if z is not None:
            found.append((i, j, *z))
    verify_wall = time.perf_counter() - t0

    def remeasure(a, b):
        return measure(frame_ids[a], frame_ids[b])

    used = filter_consistent_closures(traj, found, remeasure=remeasure)
    t0 = time.perf_counter()
    opt = None
    if used:
        opt = run_pose_graph_backend(traj, used, consistency_filter=False,
                                     device=device)
        ate_pg = float(ate_rmse(opt[:, :3, 3], gt[:, :3, 3]))
    else:
        ate_pg = float("nan")
    ate_in = float(ate_rmse(traj[:, :3, 3], gt[:, :3, 3]))
    out = {
        "closures_proposed": len(cands),
        "closures_verified": len(found),
        "closures_used": len(used),
        "closures_used_per_lap": round(len(used) / laps, 2),
        "verify_wall_s": round(verify_wall, 1),
        "solve_wall_s": round(time.perf_counter() - t0, 1),
        f"ate_{label}_m": round(ate_in, 3),
        "ate_posegraph_m": round(ate_pg, 3)}
    return out, ate_in, ate_pg, opt


def inject_drift(poses: np.ndarray) -> np.ndarray:
    """The reference's drift: the relative motions recomposed with a
    yaw bias of DRIFT_YAW_DEG and a scale of DRIFT_SCALE per frame."""
    yaw = np.radians(DRIFT_YAW_DEG)
    dR = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]])
    drifted = [poses[0]]
    for k in range(len(poses) - 1):
        rel = np.linalg.inv(poses[k]) @ poses[k + 1]
        rel[:3, :3] = rel[:3, :3] @ dR
        rel[:3, 3] *= DRIFT_SCALE
        drifted.append(drifted[-1] @ rel)
    return np.stack(drifted)


def _stage(name: str, entry: dict) -> None:
    print(json.dumps({name: entry}), flush=True)


def run(frames: int = 2048, checkpoint_at: int = 1024,
        device="cuda:0", skip_checkpoint: bool = False) -> dict:
    """All five stages on `device`; returns the record and prints one
    JSON line per stage."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("endurance_run_torch: no CUDA device; pass "
                           "device='cpu' for a run on the CPU")
    precision.enforce_fp32()
    if not precision.fp32_enforced():
        raise RuntimeError("TF32 is not off")
    spec = endurance_spec(frames)
    port = {"card": bench_torch.card_line(dev), "torch": torch.__version__,
            "device": str(dev), "launches": {}, "verify_calls": {},
            "verify_s": {}, "solves": {}}
    rec = {"frames": frames, "backend": str(dev)}

    # ---- 1. sequence
    t0 = time.perf_counter()
    seq = render_sequence(spec)
    rec["gen_wall_s"] = round(time.perf_counter() - t0, 1)
    cfg = endurance_config()

    # ---- 2. straight-through VO
    before = kernel_launches()
    vo, rec["vo"] = vo_stage(seq, cfg, dev)
    port["launches"]["vo"] = launches_since(before)
    _stage("vo", rec["vo"])

    # ---- 3. checkpoint/resume equivalence
    if skip_checkpoint:
        rec["checkpoint_resume"] = {"skipped": True}
    else:
        before = kernel_launches()
        with tempfile.TemporaryDirectory(prefix="endurance_") as workdir:
            rec["checkpoint_resume"] = resume_stage(
                seq, cfg, dev, checkpoint_at, vo["poses"], workdir)
        port["launches"]["checkpoint_resume"] = launches_since(before)
    _stage("checkpoint_resume", rec["checkpoint_resume"])
    if not rec["checkpoint_resume"].get("equivalent", True):
        raise SystemExit("resume NOT equivalent (max dev "
                         f"{rec['checkpoint_resume']['max_pose_deviation']})")

    # ---- 4. the backend on the VO trajectory
    poses, ids = vo["poses"], vo["frame_ids"]
    gt = seq.gt_poses[ids]
    laps = laps_of(spec)
    measure = ClosureMemo(seq, cfg, dev)
    t0 = time.perf_counter()
    cands_app = appearance_candidates(seq, ids, laps)
    port["appearance_s"] = time.perf_counter() - t0

    def leg(name, traj, label):
        before = kernel_launches()
        calls0, secs0 = measure.calls, measure.seconds
        with SolveTimes(dev) as solves:
            out = backend_leg(traj, label, ids, gt, laps, cands_app,
                              measure, dev)
        port["launches"][name] = launches_since(before)
        port["verify_calls"][name] = measure.calls - calls0
        port["verify_s"][name] = measure.seconds - secs0
        port["solves"][name] = solves.solves
        return out

    rec["pose_graph"], _, _, _ = leg("pose_graph", poses, "vo")
    rec["pose_graph"]["ate_vo_m"] = rec["vo"]["ate_rmse_m"]
    _stage("pose_graph", rec["pose_graph"])

    # ---- 5. the backend under injected drift
    hd, ate_drift, ate_hd, _ = leg("pose_graph_high_drift",
                                   inject_drift(poses), "drifted")
    hd["injected"] = INJECTED
    hd["recovered_pct"] = (
        round(100.0 * (1.0 - ate_hd / ate_drift), 1)
        if np.isfinite(ate_hd) else None)
    rec["pose_graph_high_drift"] = hd
    _stage("pose_graph_high_drift", hd)
    rec["port"] = port
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--checkpoint-at", type=int, default=1024)
    ap.add_argument("--tag", default="torch_h100")
    ap.add_argument("--skip-checkpoint", action="store_true",
                    help="skip stage 3 (resume equivalence)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)
    if args.tag in REFERENCE_TAGS:
        print(f"endurance_run_torch: ENDURANCE_{args.tag}.json is the JAX "
              f"package's record; choose another --tag", file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        print("endurance_run_torch: no CUDA device; pass --device cpu for a "
              "run on the CPU", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    rec = run(args.frames, args.checkpoint_at, args.device,
              args.skip_checkpoint)
    out = REPO / f"ENDURANCE_{args.tag}.json"
    out.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {out} ({time.perf_counter() - t0:.1f} s; "
          f"{rec['port']['card']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
