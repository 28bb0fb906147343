#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines:

  1. device  — the card's name and power limit; TF32 is off.
  2. build   — nvcc builds the kernel library from csrc/ (sm_90a).
  3. kernels — every kernel of the main path against its plain PyTorch
               version on the card, bit-exact, at the main path's
               shapes and edge starts; the device time of both from
               torch.profiler, and their wrapper time (CUDA events
               around back-to-back calls, host launch cost included).
  4. main    — `prime_state` then FRAMES odometry steps at the full
               KITTI size (131,072-point cloud, 2,048 features,
               384x1248 grid, 1,024 RANSAC hypotheses over 6,000
               points, 2,048-slot track table of length 12), with the
               launch counts of the kernels reset just before and read
               just after; outputs finite, every step's codes in range
               and counted, success share above its floor, everything
               on the card.
  5. agree   — a small metric world run on the card and on the CPU
               (the plain versions) from the same RANSAC draws: poses
               and codes agree, poses track the ground truth.

The kernels' JSON record and the card line (nvidia-smi's name and power
limit) come just before the last line, which is {"ok": true, "device":
{...}}.  Any failure raises and the exit code is not 0.  There is no CPU
run: without CUDA the script exits with 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

FRAMES = 8  # odometry steps of the main-path run
SEED = 0  # seed of the main-path scene and RANSAC generator
REPLACES = "mono_lidar_depth_tpu/core/pallas_windows.py:95"
SOURCE = "mono_lidar_depth_tpu_torch/csrc/windows.cu"
# Share of Success + SuccessRoad codes over all association outcomes of
# the main-path run: 0.2892 measured on an H100 80GB HBM3 at 700 W
# (PERF.md); the floor sits below it.
SUCCESS_FLOOR = 0.2
KITTI_CAMERA = dict(width=1226, height=370, focal_length=707.0, cx=601.8,
                    cy=183.1)
R_LC = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float32)
T_LC = np.array([0.0, -0.08, 0.27], dtype=np.float32)


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50) -> float:
    """Mean CUDA-event milliseconds of fn() over `reps` back-to-back runs,
    warm: the wrapper's time, host launch cost included."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, kernel: str | None = None, reps: int = 20) -> float:
    """Mean device milliseconds per fn() call from torch.profiler: the
    kernels whose name contains `kernel`, or every device activity fn
    starts (kernels, copies, fills) when `kernel` is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (kernel is None or kernel in e.key)]
    us = sum(e.self_device_time_total for e in rows)
    check(us > 0, f"the profiler saw no device time for {kernel or fn}")
    return us / 1e3 / reps


def tensors_of(tree):
    """Every tensor leaf of a nested tuple/NamedTuple."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from tensors_of(x)


# --------------------------------------------------------------- phase 3

def window_starts(rng, H, W, Ky, Kx, N):
    """Random interior starts, then the edge starts: the lane-tile
    offsets 0/1/127 from 0, 128, 256 and the last tile, sx = 0,
    sx = W-Kx, sy = H-Ky, and starts past the far edge."""
    sy = list(rng.integers(0, H - Ky + 1, N))
    sx = list(rng.integers(0, W - Kx + 1, N))
    edges = []
    for base in (0, 128, 256, (W - Kx) // 128 * 128):
        for off in (0, 1, 127):
            if 0 <= base + off <= W - Kx:
                edges.append((int(rng.integers(0, H - Ky + 1)), base + off))
    edges += [(0, 0), (H - Ky, W - Kx), (H - Ky, 0), (0, W - Kx),
              (H, W + 5)]
    for i, (y, x) in enumerate(edges):
        sy[i], sx[i] = y, x
    return (np.asarray(sy, np.int32), np.asarray(sx, np.int32))


def phase_kernels(card: str) -> dict:
    import torch
    from mono_lidar_depth_tpu_torch.core import windows

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    H, W, N = 384, 1248, 2048
    cases = [(2, H, W, 11, 8), (2, H, W, 15, 14), (3, H, W, 11, 8),
             (3, H, W, 15, 14), (2, H, 1280, 11, 8), (1, H, W, 12, 12)]
    worst = 0.0
    step_ms = step_plain_ms = 0.0
    for C, h, w, Ky, Kx in cases:
        stack = torch.from_numpy(
            rng.normal(size=(C, h, w)).astype(np.float32)).to(dev)
        sy, sx = (torch.from_numpy(a).to(dev)
                  for a in window_starts(rng, h, w, Ky, Kx, N))
        got = windows.slice_windows_cuda(stack, sy, sx, Ky, Kx)
        torch.cuda.synchronize()
        want = windows.slice_windows_reference(stack, sy, sx, Ky, Kx)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"window kernel differs from the plain version at "
              f"C={C} {h}x{w} {Ky}x{Kx}: max |err| {err}")
        worst = max(worst, err)

        def kernel():
            return windows.slice_windows_cuda(stack, sy, sx, Ky, Kx)

        def plain():
            return windows.slice_windows_reference(stack, sy, sx, Ky, Kx)

        ms, plain_ms = (device_ms(kernel, "slice_windows_kernel"),
                        device_ms(plain))
        wrap_ms, wrap_plain_ms = time_ms(kernel), time_ms(plain)
        out_mb = N * C * Ky * Kx * 4 / 1e6
        log(f"phase 3 kernels: slice_windows C={C} {h}x{w} N={N} "
            f"window {Ky}x{Kx}: bit-exact; device time kernel {ms:.4f} ms "
            f"({out_mb / ms:.1f} GB/s of output), plain {plain_ms:.4f} ms; "
            f"wrapper time (CUDA events, back-to-back calls) kernel "
            f"{wrap_ms:.4f} ms, plain {wrap_plain_ms:.4f} ms [{card}]")
        if C == 2 and w == W:  # the main path's shapes, 2 frames each
            step_ms += 2 * ms
            step_plain_ms += 2 * plain_ms
    log(f"phase 3 kernels: per odometry step (2 frames x windows 11x8 + "
        f"15x14, C=2), device time: kernel {step_ms:.4f} ms, plain "
        f"{step_plain_ms:.4f} ms [{card}]")
    return {"max_abs_err": worst, "ms": step_ms, "plain_ms": step_plain_ms}


# --------------------------------------------------------------- phase 4

class Scene(NamedTuple):
    """The main path's configuration and inputs, on the card."""

    cfg: object  # DepthEstimatorConfig
    ocfg: object  # OdometryConfig
    cam: object  # PinholeCamera
    lidar_to_cam: object  # SE3
    state: object  # OdometryState, not primed yet
    cloud0: object  # the cloud prime_state installs
    valid0: object
    gen: object  # torch.Generator of the RANSAC draws
    inputs: list  # one FrameInput per odometry step


def bench_scene(frames: int = FRAMES) -> Scene:
    """The reference defaults at the full KITTI size, the KITTI camera
    and extrinsics, and bench.py's scene: distinct 120,000-point
    synthetic clouds and persistent drifting tracks from SEED, made in
    bulk and moved to the card before the run."""
    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.io.kitti import (make_synthetic_scan,
                                                     pad_cloud)

    dev = torch.device("cuda")
    cfg = T.DepthEstimatorConfig(do_use_depth_segmentation=False)
    ocfg = T.OdometryConfig()
    M = cfg.max_features
    rng = np.random.default_rng(SEED)
    clouds = [pad_cloud(s, len(s), cfg.max_points) for s in
              (make_synthetic_scan(rng, 120000) for _ in range(frames + 1))]
    base_uv = rng.uniform([8, 8], [1218, 362], (M, 2))
    drift = rng.normal(0.0, 1.5, (frames + 1, M, 2))
    uv = np.clip(base_uv[None] + np.cumsum(drift, axis=0), [1, 1],
                 [1225, 369]).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.arange(M, dtype=torch.int32, device=dev)
    ids_valid = torch.ones(M, dtype=torch.bool, device=dev)
    inputs = [T.FrameInput(
        cloud=torch.from_numpy(clouds[k][0]).to(dev),
        cloud_valid=torch.from_numpy(clouds[k][1]).to(dev),
        ids=ids, ids_valid=ids_valid,
        uv_new=torch.from_numpy(uv[k]).to(dev),
        uv_prev=torch.from_numpy(uv[k - 1]).to(dev),
        stamp=torch.tensor(0.1 * k, device=dev), rng=gen)
        for k in range(1, frames + 1)]
    scene = Scene(
        cfg=cfg, ocfg=ocfg, cam=T.PinholeCamera(**KITTI_CAMERA),
        lidar_to_cam=T.SE3(torch.from_numpy(R_LC).to(dev),
                           torch.from_numpy(T_LC).to(dev)),
        state=T.OdometryState.create(cfg, ocfg, M, 12, dev),
        cloud0=torch.from_numpy(clouds[0][0]).to(dev),
        valid0=torch.from_numpy(clouds[0][1]).to(dev), gen=gen,
        inputs=inputs)
    torch.cuda.synchronize()
    return scene


def prime(sc: Scene):
    """The odometry state with the scene's first cloud installed."""
    import mono_lidar_depth_tpu_torch as T

    return sc.state._replace(tracklets=T.prime_state(
        sc.cfg, sc.cam, sc.lidar_to_cam, sc.state.tracklets, sc.cloud0,
        sc.valid0, sc.gen))


def phase_main(card: str) -> int:
    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core import windows
    from mono_lidar_depth_tpu_torch.obs.stats import success_rates
    from mono_lidar_depth_tpu_torch.tracks.table import match_tracks

    sc = bench_scene()
    cfg, M = sc.cfg, sc.cfg.max_features
    log(f"phase 4 main: cloud {cfg.max_points} points, {M} features, grid "
        f"{cfg.image_height}x{cfg.image_width}, RANSAC "
        f"{cfg.ransac_num_hypotheses}x{cfg.ransac_subsample_points}, track "
        f"table {M}x12, {FRAMES} frames")

    windows.launches = 0  # counts the main path's launches only
    t0 = time.perf_counter()
    state = prime(sc)
    step_ms, outs, outcomes, counters = [], [], [], []
    for frame in sc.inputs:
        # Outcomes this step must count: one per valid new-frame feature
        # and one per previous-frame feature of a new track.
        _, is_new = match_tracks(state.tracklets.table, frame.ids,
                                 frame.ids_valid)
        outcomes.append(frame.ids_valid.sum() + is_new.sum())
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, R_cw, t_cw, diag = T.odometry_step(
            cfg, sc.ocfg, sc.cam, sc.lidar_to_cam, state, frame)
        stop.record()
        outs.append((R_cw, t_cw, diag))
        counters.append(state.tracklets.counters)
        step_ms.append((start, stop))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = windows.launches
    step_ms = [a.elapsed_time(b) for a, b in step_ms]

    check(launches == 4 * FRAMES,
          f"window kernel launched {launches} times, want {4 * FRAMES}")
    leaves = list(tensors_of((state, outs, counters)))
    check(all(x.is_cuda for x in leaves), "a main-path tensor left the GPU")
    for k, (R_cw, t_cw, diag) in enumerate(outs):
        check(bool(torch.isfinite(R_cw).all() & torch.isfinite(t_cw).all()
                   & torch.isfinite(diag).all()),
              f"frame {k}: non-finite pose or diagnostics")
        det = float(torch.linalg.det(R_cw.double()))
        check(abs(det - 1.0) < 1e-3, f"frame {k}: det(R_cw) = {det}")
    check(bool(torch.isfinite(state.tracklets.table.depth).all()),
          "non-finite depth in the track table")
    # The counters are a histogram of each step's codes over 21 bins: a
    # valid lane's code outside [0, 20] either fails the histogram's
    # index_add_ or falls into its dropped bin.  So per-step counts that
    # are all >= 0 and add up to the step's outcomes show that every
    # code of this run lies in [0, 20] and was counted once.
    steps = torch.diff(torch.stack(counters), dim=0,
                       prepend=torch.zeros_like(counters[0])[None])
    want = torch.stack(outcomes).cpu().numpy()
    steps = steps.cpu().numpy()
    check(bool((steps >= 0).all()), "a negative per-step count")
    check(np.array_equal(steps.sum(1), want),
          f"per-step counts {steps.sum(1).tolist()} != outcomes "
          f"{want.tolist()}")
    total = counters[-1].cpu().numpy()
    rates = success_rates(total)
    check(rates["success_rate_all"] > SUCCESS_FLOOR,
          f"success share {rates['success_rate_all']:.4f} <= floor "
          f"{SUCCESS_FLOOR}")
    t_last = outs[-1][1].cpu().numpy()
    log(f"phase 4 main: {FRAMES} odometry steps ok: poses finite, "
        f"det(R)=1, every step's codes in [0,20] and counted "
        f"({int(total.sum())} outcomes), success share "
        f"{rates['success_rate_all']:.4f} (lidar-covered "
        f"{rates['success_rate_lidar_covered']:.4f}) > floor "
        f"{SUCCESS_FLOOR}, window-kernel launches {launches} == 4 x "
        f"{FRAMES}, all tensors on {leaves[0].device}; last t_cw {t_last}")
    log(f"phase 4 main: per-frame odometry step (CUDA events) median "
        f"{float(np.median(step_ms)):.3f} ms, first {step_ms[0]:.3f} ms, "
        f"all {[round(x, 3) for x in step_ms]}; prime + {FRAMES} steps "
        f"wall {wall:.3f} s [{card}]")
    log("phase 4 main: outcome counters " + json.dumps(
        [int(c) for c in total]))
    return launches


# --------------------------------------------------------------- phase 5

def _small_world(rng, F, M, P, cam):
    """A metric world (ground + facades) seen from a camera driving 1 m
    per frame with a slight yaw: clouds in the lidar frame, persistent
    feature tracks with 0.2 px noise, and the true camera centers."""
    n_g = 3000
    ground = np.stack([rng.uniform(-12, 12, n_g),
                       1.5 + 0.01 * rng.normal(size=n_g),
                       rng.uniform(2, 80, n_g)], 1)
    walls = [ground]
    for side in (-8.0, 8.0):
        n = 1500
        walls.append(np.stack([side + 0.02 * rng.normal(size=n),
                               rng.uniform(-4, 1.3, n),
                               rng.uniform(2, 80, n)], 1))
    world = np.concatenate(walls).astype(np.float32)
    lm = world[rng.choice(len(world), M, replace=False)]
    out, centers = [], []
    R_wc, c = np.eye(3), np.zeros(3)
    yaw = 0.01
    dR = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                   [-math.sin(yaw), 0, math.cos(yaw)]])
    for _ in range(F):
        R_cw, t_cw = R_wc.T, -R_wc.T @ c
        p_cam = world @ R_cw.T + t_cw
        cloud = np.zeros((P, 3), np.float32)
        n = min(len(p_cam), P)
        cloud[:n] = (p_cam @ R_LC)[:n]  # camera -> lidar frame (T_LC ~ 0)
        valid = np.zeros(P, bool)
        valid[:n] = True
        l_cam = lm @ R_cw.T + t_cw
        z = np.maximum(l_cam[:, 2], 1e-3)
        uv = np.stack([cam["focal_length"] * l_cam[:, 0] / z + cam["cx"],
                       cam["focal_length"] * l_cam[:, 1] / z + cam["cy"]],
                      1) + 0.2 * rng.normal(size=(M, 2))
        vis = ((l_cam[:, 2] > 1) & (uv[:, 0] > 2)
               & (uv[:, 0] < cam["width"] - 2) & (uv[:, 1] > 2)
               & (uv[:, 1] < cam["height"] - 2))
        out.append((cloud, valid, uv.astype(np.float32), vis))
        centers.append(c.copy())
        R_wc = R_wc @ dR
        c = c + R_wc @ np.array([0.0, 0.0, 1.0])
    return out, np.stack(centers)


def phase_agree(card: str) -> None:
    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws

    cam = dict(width=640, height=480, focal_length=500.0, cx=320.0, cy=240.0)
    P, M, F = 8192, 256, 8
    cfg = T.DepthEstimatorConfig(
        max_points=P, max_features=M, image_width=640, image_height=480,
        ransac_num_hypotheses=256, ransac_subsample_points=2048)
    ocfg = T.OdometryConfig(ba_window=5, ba_iters=5)
    rng = np.random.default_rng(SEED + 7)
    world, centers = _small_world(rng, F, M, P, cam)
    draws = [(rng.integers(0, P - 1, cfg.ransac_subsample_points),
              rng.integers(0, cfg.ransac_subsample_points,
                           (cfg.ransac_num_hypotheses, 3)))
             for _ in range(F)]

    def run(dev):
        lidar_to_cam = T.SE3(torch.from_numpy(R_LC).to(dev),
                             torch.zeros(3, device=dev))
        camera = T.PinholeCamera(**cam)
        state = T.OdometryState.create(cfg, ocfg, M, 8, dev)
        ids = torch.arange(M, dtype=torch.int32, device=dev)
        poses, all_codes = [], []
        for k in range(1, F):
            cloud, valid, uv, vis = world[k]
            _, _, uv_prev, vis_prev = world[k - 1]
            sub_idx, picks = draws[k]
            frame = T.FrameInput(
                cloud=torch.from_numpy(cloud).to(dev),
                cloud_valid=torch.from_numpy(valid).to(dev), ids=ids,
                ids_valid=torch.from_numpy(vis & vis_prev).to(dev),
                uv_new=torch.from_numpy(uv).to(dev),
                uv_prev=torch.from_numpy(uv_prev).to(dev),
                stamp=torch.tensor(float(k), device=dev),
                rng=RansacDraws(torch.from_numpy(sub_idx).to(dev),
                                torch.from_numpy(picks).to(dev)))
            codes = T.process_frame(cfg, camera, lidar_to_cam,
                                    state.tracklets, frame)[2]
            state, R_cw, t_cw, _ = T.odometry_step(
                cfg, ocfg, camera, lidar_to_cam, state, frame)
            poses.append((R_cw.cpu().numpy(), t_cw.cpu().numpy()))
            all_codes.append(codes.cpu().numpy())
        return poses, np.concatenate(all_codes)

    gpu_poses, gpu_codes = run(torch.device("cuda"))
    cpu_poses, cpu_codes = run(torch.device("cpu"))
    agree = float(np.mean(gpu_codes == cpu_codes))
    dR = max(float(np.abs(a[0] - b[0]).max())
             for a, b in zip(gpu_poses, cpu_poses))
    dt = max(float(np.abs(a[1] - b[1]).max())
             for a, b in zip(gpu_poses, cpu_poses))
    # The first processed frame has no previous-frame depths, so its
    # motion is unobservable; measure the path after that transient.
    s = 3
    est = np.stack([-R.T @ t for R, t in gpu_poses])[s:]
    gt = centers[1 + s:]
    gt_len = float(np.linalg.norm(gt[-1] - gt[0]))
    path_err = abs(float(np.linalg.norm(est[-1] - est[0])) - gt_len) / gt_len
    log(f"phase 5 agree: small world {F - 1} frames, card vs CPU: codes "
        f"agree {agree:.4f}, max |dR| {dR:.2e}, max |dt| {dt:.2e} m; path "
        f"length vs truth {100 * path_err:.2f}% off [{card}]")
    check(agree >= 0.99, f"card/CPU code agreement {agree:.4f} < 0.99")
    # fp32 sums run in other orders on the card than on the CPU; measured
    # |dR| 5.7e-6, |dt| 6.4e-4 m over the 7-frame, ~7 m drive.
    check(dR <= 1e-3 and dt <= 5e-3,
          f"card/CPU poses differ: |dR| {dR:.2e}, |dt| {dt:.2e}")
    check(path_err < 0.05, f"path length {100 * path_err:.2f}% off truth")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; there is no CPU run",
              file=sys.stderr)
        return 1
    from mono_lidar_depth_tpu_torch import kernels, precision

    name = torch.cuda.get_device_name(0)
    card = card_line()
    check(precision.fp32_enforced(), "TF32 is not off")
    log(f"phase 1 device: {name}, {torch.cuda.device_count()} visible, "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")
    log(card)

    t0 = time.perf_counter()
    kernels.library()
    info = kernels.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase 2 build: {info['path']} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s); ptxas: {' | '.join(ptxas)}")

    kern = phase_kernels(card)
    launches = phase_main(card)
    phase_agree(card)

    # ms / plain_ms: device time of the 4 window extractions of one
    # odometry step.
    log(json.dumps({"kernels": [{
        "name": "slice_windows", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"]}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
