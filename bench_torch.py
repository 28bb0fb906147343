#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: per-frame throughput on one card.

    python3 bench_torch.py                # on cuda:0
    python3 bench_torch.py --device cpu   # on the CPU, plain versions

The port's counterpart of `bench.py`: the same scene, the same six legs
and the single-frame serving loop, and as its last line on stdout one
JSON object with exactly `bench.py`'s keys in `bench.py`'s order and by
its formulas (`vs_baseline` is frames/s over the reference's 10 Hz).

  * `combined` (the headline `value`): the full odometry step
    (`odometry_step`: RANSAC ground plane, tracklet-depth association,
    pose GN, window BA) on every frame, from the state after one warm-up
    pass over the frames; `combined_fast` the same with
    `fast_rasterization=True`, from its own state;
  * `depth_assoc`: `fit_ground_plane_ransac` + `estimate_depths` per
    frame, `depth_assoc_fast` with fast rasterization;
  * the serving loop: one step at a time, the pose read back to the host
    after each (`single_dispatch_frame_ms`, the median);
  * `pose_gn`: `estimate_pose_gn` per frame on fixed landmarks;
    `window_ba`: `run_ba` on one window of `ba_window` frames at a time.

Each leg runs one whole warm-up pass (it builds the kernels on first use
and fills the caching allocator), then N_REPS timed reps: the host clock
around the leg, ended by one host read of a checksum that folds in every
frame's outputs.  The port runs as it is: eager, one host sync per
odometry step (vo/pipeline.py's read of its branch predicates), no other
read inside a leg but the serving loop's.  RANSAC draws from one
`torch.Generator` per leg, seeded with SEED at the start of every rep,
so that every rep does the same work; the draws stay inside the timed
region.  A leg whose `gather_neighbors` launches are not one per
`estimate_depths` or `odometry_step` call raises (0 on the CPU).

Card, per-leg median/min/max seconds, launch counts and the run's wall
time go to stderr.  Without a card the script refuses to run unless
asked for the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch import precision
from mono_lidar_depth_tpu_torch.core import neighbors
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.io.kitti import make_synthetic_scan, pad_cloud
from mono_lidar_depth_tpu_torch.vo.ba import BAProblem, run_ba
from mono_lidar_depth_tpu_torch.vo.pose import estimate_pose_gn

N_REPS = 3  # timed reps per leg
SEED = 0  # of the scene's numpy generator and of every leg's RANSAC draws
POINTS = 120_000  # points of each synthetic scan, as bench.py draws them
SERVING_STEPS_PER_REP = 10  # the serving loop runs this many steps per rep
BASELINE_FPS = 10.0  # KITTI's frame rate, the reference's real-time claim
SPREAD_OK = 0.10  # (max - min) / median of every leg under this
KITTI_CAMERA = dict(width=1226, height=370, focal_length=707.0, cx=601.8,
                    cy=183.1)
R_LC = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float32)
T_LC = np.array([0.0, -0.08, 0.27], dtype=np.float32)

# RANSAC randomness of a leg: one generator for every frame, or frame
# k's pre-drawn indices at position k.
LegRng = Union[torch.Generator, Sequence[RansacDraws]]


class Scene(NamedTuple):
    """bench.py's scene on the host, array for array."""

    cfg: T.DepthEstimatorConfig
    clouds: np.ndarray  # [F, P, 3] f32, each padded to cfg.max_points
    valids: np.ndarray  # [F, P] bool
    ids: np.ndarray  # [F, M] int32, persistent track ids
    ids_valid: np.ndarray  # [F, M] bool, all valid
    uv_new: np.ndarray  # [F, M, 2] f32, drifting features
    uv_prev: np.ndarray  # [F, M, 2] f32, frame 0 is its own previous
    stamp: np.ndarray  # [F] f32, 0.1 s apart
    lm: np.ndarray  # [M, 3] f32, landmarks of the pose_gn and window_ba legs


def bench_scene(n_frames: int = 96, points: int = POINTS,
                cfg: Optional[T.DepthEstimatorConfig] = None) -> Scene:
    """bench.py's scene, drawn as bench.py draws it from
    `np.random.default_rng(SEED)`: `n_frames` distinct synthetic scans of
    `points` points, persistent tracks drifting over the KITTI image,
    then the landmarks.  `cfg` defaults to the JAX package's defaults,
    which is what bench.py runs where the reference's parameters.yaml is
    absent; region growing is always off, as there."""
    cfg = (cfg or T.DepthEstimatorConfig()).replace(
        do_use_depth_segmentation=False)
    M = cfg.max_features
    rng = np.random.default_rng(SEED)
    clouds, valids = zip(*(pad_cloud(scan, len(scan), cfg.max_points)
                           for scan in (make_synthetic_scan(rng, points)
                                        for _ in range(n_frames))))
    base_uv = rng.uniform([8, 8], [1218, 362], (M, 2))
    drift = rng.normal(0.0, 1.5, (n_frames, M, 2))
    uv_new = np.clip(base_uv[None] + np.cumsum(drift, axis=0),
                     [1, 1], [1225, 369]).astype(np.float32)
    uv_prev = np.concatenate([uv_new[:1], uv_new[:-1]], axis=0)
    lm = rng.uniform([-20, -5, 5], [20, 5, 60], (M, 3)).astype(np.float32)
    return Scene(
        cfg=cfg, clouds=np.stack(clouds), valids=np.stack(valids),
        ids=np.broadcast_to(np.arange(M, dtype=np.int32), (n_frames, M)),
        ids_valid=np.ones((n_frames, M), dtype=bool), uv_new=uv_new,
        uv_prev=uv_prev,
        stamp=np.arange(n_frames, dtype=np.float32) * np.float32(0.1),
        lm=lm)


def scene_frames(sc: Scene, device) -> T.FrameInput:
    """The scene's frames on `device`, every field with a leading frame
    axis (`rng` is given per leg)."""
    return T.FrameInput(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                          for x in (sc.clouds, sc.valids, sc.ids,
                                    sc.ids_valid, sc.uv_new, sc.uv_prev,
                                    sc.stamp)), rng=None)


def camera_and_extrinsics(device) -> tuple[T.PinholeCamera, T.SE3]:
    """bench.py's KITTI camera and lidar-to-camera transform."""
    return T.PinholeCamera(**KITTI_CAMERA), T.SE3(
        torch.from_numpy(R_LC).to(device), torch.from_numpy(T_LC).to(device))


def frame_at(frames: T.FrameInput, k: int, rng: LegRng) -> T.FrameInput:
    """Frame k of the stacked frames, with its RANSAC source."""
    return T.FrameInput(*(x[k] for x in frames[:7]),
                        rng=rng if isinstance(rng, torch.Generator)
                        else rng[k])


# ------------------------------------------------------------ leg bodies
# No host read in any of them: each returns its checksum on the device.

def ground_plane(cfg, cloud, valid, rng):
    """bench.py's RANSAC call: the ground plane of one cloud, drawn from a
    generator or from pre-drawn `RansacDraws`."""
    gen, (sub_idx, picks) = ((rng, (None, None))
                             if isinstance(rng, torch.Generator)
                             else (None, rng))
    return T.fit_ground_plane_ransac(
        cloud, valid, gen, sub_idx=sub_idx, picks=picks,
        distance_threshold=cfg.ransac_plane_distance_treshold,
        num_hypotheses=cfg.ransac_num_hypotheses,
        subsample=cfg.ransac_subsample_points,
        use_refinement=cfg.ransac_plane_use_refinement,
        refinement_threshold=cfg.ransac_plane_refinement_treshold)


def depth_frame(cfg, cam, lidar_to_cam, frame: T.FrameInput):
    """bench.py's `depth_frame`: the ground plane of the frame's cloud,
    then `estimate_depths` of its newest features (all valid)."""
    gp = ground_plane(cfg, frame.cloud, frame.cloud_valid, frame.rng)
    return T.estimate_depths(cfg, cam, lidar_to_cam, frame.cloud,
                             frame.cloud_valid, frame.uv_new,
                             frame.ids_valid, gp)


def depth_leg(cfg, cam, lidar_to_cam, frames: T.FrameInput, rng: LegRng):
    """Legs 1 and 1b: `depth_frame` on every frame.  Returns (checksum,
    the frames' DepthEstimates)."""
    acc = torch.zeros((), device=frames.cloud.device)
    outs = []
    for k in range(frames.cloud.shape[0]):
        out = depth_frame(cfg, cam, lidar_to_cam, frame_at(frames, k, rng))
        acc = acc + (out.depths.sum() + out.codes.sum()
                     + out.counters.sum()).to(torch.float32)
        outs.append(out)
    return acc, outs


def combined_leg(cfg, ocfg, cam, lidar_to_cam, state, frames: T.FrameInput,
                 rng: LegRng):
    """Legs 2 and 2b: `odometry_step` on every frame from `state`.
    Returns (state after the last frame, checksum, [(R_cw, t_cw, diag)])."""
    acc = torch.zeros((), device=frames.cloud.device)
    poses = []
    for k in range(frames.cloud.shape[0]):
        state, R_cw, t_cw, diag = T.odometry_step(
            cfg, ocfg, cam, lidar_to_cam, state, frame_at(frames, k, rng))
        acc = acc + (R_cw.sum() + t_cw.sum() + diag.sum())
        poses.append((R_cw, t_cw, diag))
    return state, acc, poses


def pose_gn_leg(cam, lm, uv_new, usable):
    """`estimate_pose_gn` of every frame's features against the fixed
    landmarks, from the identity.  Returns (checksum, [PoseEstimate])."""
    kw = dict(dtype=lm.dtype, device=lm.device)
    eye, zero = torch.eye(3, **kw), torch.zeros(3, **kw)
    acc = torch.zeros((), **kw)
    outs = []
    for k in range(uv_new.shape[0]):
        est = estimate_pose_gn(cam, lm, uv_new[k], usable[k], R_init=eye,
                               t_init=zero)
        acc = acc + est.translation.sum() + est.rotation.sum()
        outs.append(est)
    return acc, outs


def window_ba_leg(cam, ocfg, lm, uv_new):
    """`run_ba` on the windows uv_new[k:k + ba_window], each from identity
    poses, 12 m depth priors and every observation on.  Returns
    (checksum, [BAProblem after the iterations])."""
    W, M, dev = ocfg.ba_window, lm.shape[0], lm.device
    on = torch.ones((W, M), dtype=torch.bool, device=dev)
    # The window's constant fields, made once (XLA hoists them out of
    # bench.py's scan).  Its costs are never read there, so XLA drops
    # them: compute_cost=False does the same here.
    const = dict(R=torch.eye(3, device=dev).repeat(W, 1, 1),
                 t=torch.zeros((W, 3), device=dev), landmarks=lm,
                 obs_mask=on, depth_prior=torch.full((W, M), 12.0, device=dev),
                 depth_mask=on, fixed=torch.arange(W, device=dev) == W - 1,
                 lm_valid=torch.ones(M, dtype=torch.bool, device=dev))
    acc = torch.zeros((), device=dev)
    outs = []
    for k in range(uv_new.shape[0] - W):
        res = run_ba(cam, BAProblem(obs_uv=uv_new[k:k + W], **const),
                     iters=ocfg.ba_iters, depth_weight=ocfg.depth_weight,
                     compute_cost=False)
        acc = acc + res.problem.t.sum()
        outs.append(res.problem)
    return acc, outs


def serving_loop(cfg, ocfg, cam, lidar_to_cam, state, frames: T.FrameInput,
                 gen: torch.Generator, steps: int) -> list[float]:
    """One `odometry_step` at a time over frames k % F, the pose read back
    to the host inside the loop, as a strict 1-frame-in / 1-pose-out
    server must.  Returns the seconds of each step."""
    F = frames.cloud.shape[0]
    secs = []
    for k in range(steps):
        t0 = time.perf_counter()
        state, R_cw, t_cw, diag = T.odometry_step(
            cfg, ocfg, cam, lidar_to_cam, state, frame_at(frames, k % F, gen))
        t_cw.cpu()
        secs.append(time.perf_counter() - t0)
    return secs


# ---------------------------------------------------------------- timing

def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or the CPU."""
    if device.type != "cuda":
        return "cpu (plain versions of the kernels)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _timed_reps(fn, n: int) -> dict:
    """bench.py's `_timed_reps`: fn() n times, each ended by one host read
    of the checksum it returns; seconds per rep."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        float(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    return {"median_s": med, "min_s": ts[0], "max_s": ts[-1],
            "spread_frac": (ts[-1] - ts[0]) / med if med > 0 else 0.0}


def _counted(name: str, calls: int, device: torch.device, fn):
    """fn() with the gather launches counted from 0: one per
    `estimate_depths` / `odometry_step` call on the card, none on the
    CPU, where the plain version runs.  Returns (fn(), launches)."""
    neighbors.launches = 0
    out = fn()
    got = neighbors.launches
    want = calls if device.type == "cuda" else 0
    if got != want:
        raise RuntimeError(f"{name}: {got} gather_neighbors launches for "
                           f"{calls} calls on {device}, want {want}")
    return out, got


def run(device, n_frames: int = 96,
        cfg: Optional[T.DepthEstimatorConfig] = None, reps: int = N_REPS
        ) -> tuple[dict, dict]:
    """Run every leg on `device` at the given size and print the JSON
    line.  Returns (that line's dict, gather launches per leg)."""
    t_run = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device; pass device='cpu' "
                           "for a run on the CPU")
    precision.enforce_fp32()
    if not precision.fp32_enforced():
        raise RuntimeError("TF32 is not off")
    ocfg = T.OdometryConfig()
    if n_frames <= ocfg.ba_window:
        raise ValueError(f"n_frames must exceed ba_window = {ocfg.ba_window}")
    sc = bench_scene(n_frames, cfg=cfg)
    cfg, M = sc.cfg, sc.cfg.max_features
    cfg_fast = cfg.replace(fast_rasterization=True)
    cam, l2c = camera_and_extrinsics(dev)
    frames = scene_frames(sc, dev)
    lm = torch.from_numpy(sc.lm).to(dev)
    gen = torch.Generator(device=dev)
    card = card_line(dev)
    _log(card)
    _log(f"bench_torch: {n_frames} frames of {POINTS} points (padded to "
         f"{cfg.max_points}), {M} features, grid {cfg.image_height}x"
         f"{cfg.image_width}, RANSAC {cfg.ransac_num_hypotheses}x"
         f"{cfg.ransac_subsample_points}, {reps} timed reps per leg, on "
         f"{dev}")

    def reseeded():
        return gen.manual_seed(SEED)

    def timed(body):
        """One warm-up pass of body (it builds the kernels on first use
        and fills the caching allocator), then `reps` timed passes."""
        float(body())
        return _timed_reps(body, reps)

    def depth(c):
        return timed(lambda: depth_leg(c, cam, l2c, frames, reseeded())[0])

    def combined(c):
        """The warm-up pass runs from the initial state; the timed passes
        run from the state it leaves, which is also returned."""
        st0 = T.OdometryState.create(c, ocfg, M, 12, dev)
        warm, acc, _ = combined_leg(c, ocfg, cam, l2c, st0, frames,
                                    reseeded())
        float(acc)
        return warm, _timed_reps(lambda: combined_leg(
            c, ocfg, cam, l2c, warm, frames, reseeded())[1], reps)

    launches = {}
    calls = (reps + 1) * n_frames
    r_depth, launches["depth_assoc"] = _counted(
        "depth_assoc", calls, dev, lambda: depth(cfg))
    r_depth_fast, launches["depth_assoc_fast"] = _counted(
        "depth_assoc_fast", calls, dev, lambda: depth(cfg_fast))
    (state_warm, r_odo), launches["combined"] = _counted(
        "combined", calls, dev, lambda: combined(cfg))
    (_, r_odo_fast), launches["combined_fast"] = _counted(
        "combined_fast", calls, dev, lambda: combined(cfg_fast))

    steps = SERVING_STEPS_PER_REP * reps

    def serve():
        serving_loop(cfg, ocfg, cam, l2c, state_warm, frames, reseeded(), 1)
        return serving_loop(cfg, ocfg, cam, l2c, state_warm, frames,
                            reseeded(), steps)

    singles, launches["serving"] = _counted("serving", steps + 1, dev, serve)
    single_ms = float(np.median(singles)) * 1e3

    usable = torch.ones((n_frames, M), dtype=torch.bool, device=dev)
    r_gn, launches["pose_gn"] = _counted("pose_gn", 0, dev, lambda: timed(
        lambda: pose_gn_leg(cam, lm, frames.uv_new, usable)[0]))
    r_ba, launches["window_ba"] = _counted("window_ba", 0, dev, lambda: timed(
        lambda: window_ba_leg(cam, ocfg, lm, frames.uv_new)[0]))

    depth_fps = n_frames / r_depth["median_s"]
    depth_fast_fps = n_frames / r_depth_fast["median_s"]
    odo_fps = n_frames / r_odo["median_s"]
    odo_fast_fps = n_frames / r_odo_fast["median_s"]
    gn_ms = r_gn["median_s"] / n_frames * 1e3
    ba_ms = r_ba["median_s"] / (n_frames - ocfg.ba_window) * 1e3

    legs = {"combined": r_odo, "depth_assoc": r_depth,
            "depth_assoc_fast": r_depth_fast, "combined_fast": r_odo_fast,
            "pose_gn": r_gn, "window_ba": r_ba}
    for name, r in legs.items():
        _log(f"bench_torch: {name}: median {r['median_s']:.6f} s, min "
             f"{r['min_s']:.6f} s, max {r['max_s']:.6f} s per pass; "
             f"gather_neighbors launches {launches[name]}")
    _log(f"bench_torch: serving loop: {steps} steps, median "
         f"{single_ms:.3f} ms, min {1e3 * min(singles):.3f} ms, max "
         f"{1e3 * max(singles):.3f} ms; gather_neighbors launches "
         f"{launches['serving']}")
    spreads = {f"spread_pct_{k}": round(100.0 * r["spread_frac"], 1)
               for k, r in legs.items()}
    worst = max(r["spread_frac"] for r in legs.values())
    result = {
        "metric": "frames_per_s_per_chip_depth_assoc_plus_ba",
        "value": round(odo_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(odo_fps / BASELINE_FPS, 2),
        "depth_assoc_fps": round(depth_fps, 2),
        "depth_assoc_vs_baseline": round(depth_fps / BASELINE_FPS, 2),
        "depth_assoc_fast_fps": round(depth_fast_fps, 2),
        "combined_fast_fps": round(odo_fast_fps, 2),
        "single_dispatch_frame_ms": round(single_ms, 2),
        "stage_ms_depth_assoc": round(1e3 / depth_fps, 2),
        "stage_ms_odometry_full": round(1e3 / odo_fps, 2),
        "stage_ms_pose_gn": round(gn_ms, 2),
        "stage_ms_window_ba": round(ba_ms, 2),
        "timing_reps": reps,
        "timing_spread_ok": bool(worst <= SPREAD_OK),
        **spreads,
    }
    _log(f"bench_torch: wall {time.perf_counter() - t_run:.1f} s [{card}]")
    print(json.dumps(result), flush=True)
    return result, launches


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        print("bench_torch: no CUDA device; pass --device cpu for a run on "
              "the CPU", file=sys.stderr)
        return 1
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
