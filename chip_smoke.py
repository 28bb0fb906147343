#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines:

  1. device  — the card's name and power limit; TF32 is off.
  2. build   — nvcc builds the kernel libraries from csrc/ (sm_90a),
               one process per source, all started together; the LK
               kernel must not spill.
  3. kernels — every kernel of the main paths against its plain PyTorch
               version on the card at the main paths' shapes: the window
               crop bit-exact at edge starts; the fused Lucas-Kanade
               passes (both passes over a 4-level KITTI pyramid, one
               launch) within LK_TOL_PX on each pass and equal to the
               plain version to the bit, with features on and past the
               borders of every level, at the main patch and at every
               other patch size the kernel is built for; the fused
               neighbor gather bit-exact on every field on rasterized
               synthetic scans, for one and two frames, one and two
               scales, with and without the index plane, unequal
               feature counts, a 1280-wide grid, an odd window pair,
               dense made-up stacks, and features on, at and past every
               border and at NaN and infinite positions; the device time of
               each from torch.profiler, their wrapper time (CUDA events
               around back-to-back calls, host launch cost included) and
               one library call as a yardstick: for the crop one
               advanced-indexing gather on index tensors made
               beforehand, for the LK passes one `grid_sample` of the
               same patch taps per level and iteration, for the neighbor gather the four
               indexing gathers of its crops alone.
  4. main    — `prime_state` then FRAMES odometry steps at the full
               KITTI size (131,072-point cloud, 2,048 features,
               384x1248 grid, 1,024 RANSAC hypotheses over 6,000
               points, 2,048-slot track table of length 12), with the
               launch counts of the kernels reset just before and read
               just after (one neighbor gather per step, no window
               crop, no tracker kernel); outputs finite, every step's codes in range and
               counted, success share above its floor, everything on
               the card; no host sync inside the neighbor gather, and
               exactly one in a whole step (vo/pipeline.py's read of its
               two branch predicates).
  5. agree   — a small metric world run on the card and on the CPU
               (the plain versions) from the same RANSAC draws: poses
               and codes agree, poses track the ground truth.
  6. images  — the image-fed path at the full KITTI size: IMAGE_FRAMES
               frames of the synthetic sequence (1226x370 images, 32x900
               lidar scans) rendered in memory, then `init_tracker` and
               per frame `track_frame` + `odometry_step` through
               `frame_inputs`, with every kernel's launch count read
               after every frame (1 LK launch and 1 gate per
               `track_frame`, 1 neighbor gather per step, no crop); state on the card, no host sync inside
               `track_frame`, ids persistent, poses finite and on the
               ground truth's path, the same frames through
               `eval_vo_sequence` with the same poses and launch counts,
               and the card in agreement with the CPU's plain versions
               frame by frame.
  7. sequence — the chunked sequence evaluators (RANSAC and semantic
               plane, each also with region growing), checkpoint and
               resume, and the loader, on phase 6's frames.
  8. posegraph — config 4 at the KITTI size: `eval_vo_sequence` over a
               LOOP_FRAMES-frame rendered loop, then closure proposal
               (metric and appearance), verification of every candidate
               (per direction one device call that launches exactly 1
               `lk_track`, 1 `zncc_gate` and 1 `gather_neighbors` and
               never waits for the host) and `run_pose_graph_backend`,
               without and with injected drift (ATE must fall, below 0.7x
               under drift); the first CPU_PAIRS pairs and the backend on
               the CPU too; then `optimize_pose_graph` at KITTI-00 scale
               (4541 poses): ms per GN iteration and per stage, host syncs
               per GN iteration (at most one per 8 PCG iterations), peak
               memory, and the card against the CPU.
  9. dist    — the distributed layer (mono_lidar_depth_tpu_torch/dist/) at
               the KITTI shapes of __graft_entry_torch__.dryrun_multichip:
               DIST_RANKS spawned ranks sharing the card over gloo run the
               frame-parallel association (one frame and exactly one
               `gather_neighbors` launch per rank; codes and counters equal
               to the single-process run to the bit), the landmark-sharded
               BA and the edge-sharded 4541-pose graph (within the bars of
               the single-process runs, the same PCG iterations on every
               rank); then a world of one NCCL rank, whose distributed BA
               and pose graph equal group=None to the bit; ms, all_reduce
               calls and host syncs per BA and per GN iteration, single
               against distributed.
 10. bench   — bench_torch.run at BENCH_FRAMES frames and one rep (bench.py's
               keys, one gather launch per estimate_depths / odometry step);
               then fast rasterization on frames 0-1 of its scene, card
               against CPU: the raster bit-equal from the same points_cam
               and uv, codes from the same RANSAC draws, and for each lane
               whose codes differ, where its cascade parts between the two
               devices, step by step (`_cascade_split`), with the port's
               triangle, RANSAC refit and road plane fit replayed op by op
               on both from the CPU's inputs (`_op_chain`).
 11. endurance — scripts/endurance_run_torch.run at ENDURANCE_FRAMES frames of
               the 384x128 multi-lap loop (one lap and its revisits), the
               checkpoint at ENDURANCE_CHECKPOINT: the record's keys are
               scripts/endurance_run.py's, the resume is bit-equal, a
               closure is verified and used, the backend's ATE is no
               higher than the VO's, and exactly one gather_neighbors,
               lk_track and zncc_gate launch per VO step and per
               verification direction.
 12. parity  — scripts/make_parity_record_torch.run: its stages 2-4b in
               process at PARITY_FRAMES frames (config 2's six modes, config
               3's three re-initialized runs and the persisted one, configs
               4 and 4b), its subprocess legs at their smallest (the density
               sweep at one density, veto on and off; the scaling table at
               PARITY_RANKS; the 2-process demo): the record's keys are
               scripts/make_parity_record.py's and its three scripts' (read
               from their sources), every success share in (0, 1), every ATE
               finite, no failed leg, the demo's match, each kernel's
               launches exact per stage; then road_veto_off, production and
               persisted landmarks, card against CPU over the first
               PARITY_AGREE_FRAMES frames (codes at phase 7's bar, poses at
               phase 6's); config 3 at PARITY_FRAMES frames on the card and
               on the CPU from the card's draws, ATEs within
               PARITY_ATE_BAR, and one step at a time from the card's carry
               (counts equal, poses at phase 6's bar).

The kernels' JSON record and the card line (nvidia-smi's name and power
limit) come just before the last line, which is {"ok": true, "device":
{...}}.  Any failure raises and the exit code is not 0.  There is no CPU
run: without CUDA the script exits with 1.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import NamedTuple

import numpy as np

FRAMES = 8  # odometry steps of the main-path run
SEED = 0  # seed of the main-path scene and RANSAC generator
IMAGE_FRAMES = 9  # rendered frames of the image-fed run (8 steps)
SEQ_CHUNK = 4  # frames per chunk of the sequence evaluators in phase 7
RESUME_AT = 5  # phase 7 stops before this frame, checkpoints and resumes
REPLACES = "mono_lidar_depth_tpu/core/pallas_windows.py:95"
SOURCE = "mono_lidar_depth_tpu_torch/csrc/windows.cu"
LK_SOURCE = "mono_lidar_depth_tpu_torch/csrc/lk_track.cu"
GATHER_SOURCE = "mono_lidar_depth_tpu_torch/csrc/gather_neighbors.cu"
GATE_SOURCE = "mono_lidar_depth_tpu_torch/csrc/zncc_gate.cu"
# The tracker's settings on the image-fed path (the eval harness's).
LEVELS, PATCH, LK_ITERS, MIN_DET = 4, 9, 8, 1e-4
# The other patch sizes held against the plain version (no timing): with
# PATCH they reach every odd patch the kernel is built for from 5 on, and
# both orders of its sums (patches 13 and 15 sum 4 floats at a time).
OTHER_PATCHES = (5, 7, 11, 13, 15)
# The fused LK passes against their plain version: every elementwise step
# is the plain version's, in its order, and every sum runs in the order of
# torch.sum on the card, so the two agree to the bit (checked).  The bars
# stand for what the tracker needs: lanes `ok` in both must end within
# LK_TOL_PX of each other on each pass, and `ok` must agree on LK_OK_SHARE
# of the lanes.
LK_TOL_PX = 1e-3
LK_OK_SHARE = 0.999
# The tracker's gate thresholds (track_features' defaults, which
# track_frame leaves alone).
MIN_NCC, FB_THRESHOLD = 0.6, 1.0
# The fused gate against its plain version: every elementwise step is the
# plain version's to the bit and the five patch sums run in another order.
# `ncc` must lie within GATE_TOL of the plain one; `ok` must be equal on
# every lane whose plain `ncc` and forward-backward error are farther than
# GATE_TOL from their thresholds, and on GATE_OK_SHARE of all lanes.  A
# lane whose patches are flat has a denominator under the 1e-8 floor of
# `_zncc` up to rounding, so its `ncc` is rounding noise over that floor
# in either version: such lanes (plain denominator under GATE_FLAT_DEN)
# are held to |ncc| <= GATE_FLAT_NCC in both and not compared.
GATE_TOL = 1e-5
GATE_OK_SHARE = 0.999
GATE_FLAT_DEN, GATE_FLAT_NCC = 1e-6, 2e-4
# Share of the 2,048 lanes that `track_frame` emits per frame on the
# synthetic sequence: the floor sits just under the measured minimum.
EMIT_FLOOR = 0.6
# Published peaks of one H100 SXM: device memory rate and fp32 rate
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# Share of Success + SuccessRoad codes over all association outcomes of
# the main-path run: 0.2892 measured on an H100 80GB HBM3 at 700 W
# (PERF.md); the floor sits below it.
SUCCESS_FLOOR = 0.2
# Phase 8: config 4 as PARITY_r5.md ran it (scripts/make_parity_record.py):
# the 220-frame synthetic loop, here at the KITTI size; candidates are the
# union of the metric and the appearance proposer; leg 4b injects 0.5
# deg/frame of yaw and 8% of scale into the VO poses.  (The 84-frame loop
# of tests/test_kitti_synthetic.py turns 4.3 deg per frame, a 53 px flow at
# 1226x370 that the tracker's pyramid does not reach: RPE 3.7 deg per
# frame on the card.)  The first CPU_PAIRS pairs the card accepted that
# are true revisits (ground truth within REVISIT_M metres; two pairs 32
# frames apart verified too, and the filter dropped them), the first
# pair it rejected and the backend run on the CPU too.
LOOP_FRAMES = 220
LOOP_PROPOSE = dict(min_gap=30, radius=8.0, stride=2, max_candidates=12)
LOOP_DRIFT = (0.5, 1.08)  # yaw deg per frame, scale per frame
CPU_PAIRS = 3
REVISIT_M = 4.0
# Card vs CPU on the same inputs and draws: a closure's Z_R (rad), Z_t (m)
# and w6 (the bars of tests/test_torch_closures.py against JAX); the
# backend's positions (share of the extent) and rotations (rad) after its
# 20 fp32 GN iterations.
CLOSURE_TOL = (2e-3, 2e-2, 2e-2)
BACKEND_TOL = (1e-3, 5e-3)
# The KITTI-00-scale graph (__graft_entry__.py) and its solve; card vs
# CPU positions (share of the extent) and rotations (rad), the bars of
# tests/test_torch_pose_graph.py against JAX.  Two GN iterations (four
# until phase 11 was added) keep the whole script near its earlier length:
# one iteration's PCG exits early, the other runs its 250.
KITTI00_POSES = 4541
PG_GN_ITERS, PG_CG_ITERS = 2, 250
KITTI00_TOL = (1e-6, 2e-4)
# Phase 9: the three sharded programs of __graft_entry_torch__'s dryrun at
# its KITTI shapes, on DIST_RANKS gloo ranks sharing the card (one frame
# and 1,024 landmarks each) and on one NCCL rank; BA against the single-
# process run at tests/test_dist.py's bars (final cost rtol, R, t,
# landmarks), the pose graph at KITTI00_TOL.  The dryrun's observations are
# exact, so its final BA cost is near 0 (2.5e-5 from 1.19e5) and rounding
# noise relative to itself: the cost bar is rtol or DIST_BA_COST_ATOL of
# the initial cost, whichever is larger.  The pose graph runs one GN
# iteration (two until phase 12 was added): each takes ~10 s at 4541 poses
# in each of the four solves.
DIST_RANKS = 2
DIST_BA_ITERS = 3
DIST_PG = dict(gn_iters=1, cg_iters=10)
DIST_BA_TOL = (1e-3, 1e-4, 1e-3, 1e-2)
DIST_BA_COST_ATOL = 1e-9
DIST_TIMED_ITERS = 5  # BA iterations per timing
BENCH_FRAMES = 8  # frames of phase 10's bench_torch run
ENDURANCE_FRAMES = 256  # phase 11: one 220-frame lap and 36 revisit frames
ENDURANCE_CHECKPOINT = 128  # phase 11 checkpoints here and resumes
# Phase 12: scripts/make_parity_record_torch.run at make_parity_record.py's
# --quick size; its sweep at PARITY_SWEEP (frames, lidar rows), veto on and
# off; its scaling table at PARITY_RANKS; then road_veto_off, production
# and persisted landmarks card against CPU over PARITY_AGREE_FRAMES frames,
# and config 3 one step at a time over its PARITY_FRAMES frames (each frame
# on the CPU from the card's carry), at phase 7's code bar and phase 6's
# pose bar (|dR|, |dt| m).
PARITY_FRAMES = 60
PARITY_SWEEP = (24, 20)
PARITY_RANKS = (1, 2)
PARITY_AGREE_FRAMES = 8
PARITY_CODE_BAR = 1.0  # card vs CPU; measured 1.00000 with the float64 fits
PARITY_POSE_BAR = (1e-3, 5e-3)
PARITY_ATE_BAR = 0.01  # m, config 3's ATE card vs CPU from the card's draws


def check_no_spills(build_log: str, source: str) -> None:
    """Fail if ptxas reported a spill for any kernel of `source` in the
    build log (kernels.build_info["log"]); a cached build has no log."""
    if build_log == "(cached)":
        return
    section = build_log.split(f"[{source}]", 1)[1].split("\n[", 1)[0]
    kernel, spills, bad = "?", 0, []
    for ln in section.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
        elif "spill" in ln:
            spills += 1
            if "0 bytes spill stores, 0 bytes spill loads" not in ln:
                bad.append(f"{kernel}: {ln.strip()}")
    check(spills > 0, f"no ptxas report for {source}")
    check(not bad, f"{source} spills registers: {bad}")


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


# Set once torch.profiler has returned three traces in a row without any
# device record: it was seen to stay that way for the rest of a process.
_profiler_lost = False


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per fn() call without the profiler:
    `reps` calls captured into one CUDA graph, its replay timed with CUDA
    events.  No host launch cost, but the gaps between the graph's nodes
    count, so it reads a little above the kernels' own time."""
    import torch

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, kernel: str | None = None, reps: int = 20) -> float:
    """Mean device milliseconds per fn() call from torch.profiler: the
    kernels whose name contains `kernel`, or every device activity fn
    starts (kernels, copies, fills) when `kernel` is None.  If the
    profiler stops returning device records, from `graph_ms` instead."""
    global _profiler_lost
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A trace this short now and then comes back with no device
    # records at all; such a trace is taken again, at most twice.
    for attempt in range(0 if _profiler_lost else 3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (kernel is None or kernel in e.key)]
        us = sum(e.self_device_time_total for e in rows)
        if us > 0:
            return us / 1e3 / reps
        log(f"device_ms: profiler trace {attempt + 1} for "
            f"{kernel or fn.__name__} held no device records")
        time.sleep(0.5)
    if not _profiler_lost:
        _profiler_lost = True
        log("device_ms: torch.profiler returns no device records any more; "
            "every device time from here on is the CUDA-event time of a "
            "CUDA-graph replay of the same calls (gaps between the graph's "
            "nodes included, host launch cost not)")
    ms = graph_ms(fn, reps)
    check(ms > 0, f"no device time for {kernel or fn}")
    return ms


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
             (3, H, W, 15, 14), (2, H, 1280, 11, 8), (1, H, W, 12, 12),
             # the tracker's former ZNCC crops: finest level 370x1226, pad 10
             (1, 390, 1246, 10, 10)]
    worst = 0.0
    # Sums over the 4 depth-path crops that one odometry step made before
    # the fused neighbor gather took them over (printed for comparison).
    step_ms = step_plain_ms = step_bound_ms = step_lib_ms = 0.0
    record = {}
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

        # Library yardstick: the one advanced-indexing gather, on index
        # tensors made outside the timed call; never called by the port.
        rows = (sy.long().clamp(0, h - Ky)[:, None]
                + torch.arange(Ky, device=dev))[:, :, None]
        cols = (sx.long().clamp(0, w - Kx)[:, None]
                + torch.arange(Kx, device=dev))[:, None, :]

        def library():
            return stack[:, rows, cols]  # [C, N, Ky, Kx]

        check(torch.equal(library().permute(1, 0, 2, 3), got),
              "the library gather differs from the window kernel")
        ms, plain_ms, lib_ms = (device_ms(kernel, "slice_windows_kernel"),
                                device_ms(plain), device_ms(library))
        wrap_ms, wrap_plain_ms = time_ms(kernel), time_ms(plain)
        out_mb = N * C * Ky * Kx * 4 / 1e6
        # Bound: a pure copy, so bytes: the stack and the starts read
        # once, the windows written once, over the device-memory rate.
        bound = ((C * h * w + 2 * N + N * C * Ky * Kx) * 4
                 / PEAK_BYTES_S * 1e3)
        log(f"phase 3 kernels: slice_windows C={C} {h}x{w} N={N} "
            f"window {Ky}x{Kx}: bit-exact; device time kernel {ms:.4f} ms "
            f"({out_mb / ms:.1f} GB/s of output), plain {plain_ms:.4f} ms, "
            f"bound {bound:.5f} ms by bytes, one indexing gather on ready "
            f"indices {lib_ms:.4f} ms; wrapper time (CUDA events, back-to-back calls) kernel "
            f"{wrap_ms:.4f} ms, plain {wrap_plain_ms:.4f} ms [{card}]")
        if (C, h, w) == (1, 390, 1246):  # the 2 crops zncc_gate replaces
            record = {"ms": 2 * ms, "plain_ms": 2 * plain_ms,
                      "bound_ms": 2 * bound, "library_ms": 2 * lib_ms}
        if C == 2 and w == W:  # the former depth-path shapes, 2 frames each
            step_ms += 2 * ms
            step_plain_ms += 2 * plain_ms
            step_bound_ms += 2 * bound
            step_lib_ms += 2 * lib_ms
    log(f"phase 3 kernels: slice_windows, the 2 ZNCC crops of one "
        f"track_frame that zncc_gate replaces (C=1 390x1246 10x10), device "
        f"time: kernel {record['ms']:.4f} ms, plain "
        f"{record['plain_ms']:.4f} ms, bound {record['bound_ms']:.5f} ms, "
        f"indexing gather on ready indices {record['library_ms']:.4f} ms; "
        f"the 4 depth-path crops of one odometry step that gather_neighbors "
        f"replaces (2 frames x windows 11x8 + 15x14, C=2): kernel "
        f"{step_ms:.4f} ms, plain {step_plain_ms:.4f} ms, bound "
        f"{step_bound_ms:.5f} ms, indexing gather {step_lib_ms:.4f} ms "
        f"[{card}]")
    return {"max_abs_err": worst, **record}


def border_centres(H, W, patch):
    """Patch centres within the clamp slack of each edge, on it and past
    it, in u, in v and in both."""
    slack = (patch - 1) // 2 + 1
    edge_x = [-slack - 2.5, -slack + 0.5, -0.25, 0.0, 0.6, W - 1.5, W - 1.0,
              W - 0.3, W - 1 + slack - 0.2, W + slack + 3.0]
    edge_y = [-slack - 2.5, -slack + 0.5, -0.25, 0.0, 0.6, H - 1.5, H - 1.0,
              H - 0.3, H - 1 + slack - 0.2, H + slack + 3.0]
    return ([(x, H / 2 + 0.37) for x in edge_x]
            + [(W / 2 + 0.71, y) for y in edge_y]
            + list(zip(edge_x, edge_y)) + list(zip(edge_x, edge_y[::-1])))


def lk_lanes(rng, pyr, N, patch=PATCH):
    """Start positions and forward guesses for the LK passes at the finest
    level of a pyramid on the card: detected corners, uniform random
    positions, and the border cases of every level scaled up to the
    finest; each guess is its start moved by a normal 1 px."""
    import torch
    from mono_lidar_depth_tpu_torch.tracker import harris

    H, W = pyr[0].shape
    corners, _ = harris.detect_features(pyr[0], N, cell_size=4, border=2)
    uv = rng.uniform([0, 0], [W - 1, H - 1], (N, 2))
    uv[: N // 2] = corners.cpu().numpy()[: N // 2]
    edges = [(x * 2 ** lvl, y * 2 ** lvl) for lvl, img in enumerate(pyr)
             for x, y in border_centres(*img.shape, patch)]
    uv[N - len(edges):] = edges
    guess = uv + rng.normal(0.0, 1.0, (N, 2))
    return (torch.from_numpy(uv.astype(np.float32)).to(pyr[0].device),
            torch.from_numpy(guess.astype(np.float32)).to(pyr[0].device))


def lk_bound_ms(shapes, N, patch=PATCH) -> tuple[float, float]:
    """The two least times the card could take for both LK passes over
    pyramids of these level shapes: the bytes they must move (both
    pyramids, uv and guess read once; uv_f, uv_b, ok_f and ok_b written
    once) over the device-memory rate, and their fp32 operations over the
    fp32 peak.  The bound is the larger."""
    nbytes = sum(2 * H * W * 4 for H, W in shapes) + N * (2 * 8 + 2 * 9)
    taps = patch * patch
    # per pass, level and feature: blend 9 ops per sample; gradients 4 and
    # their products 6 per tap; per iteration and tap: blend 9, residual
    # 1, two products 4.
    flops = 2 * len(shapes) * N * ((patch + 2) ** 2 * 9 + taps * 10
                                   + LK_ITERS * taps * 14)
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_S * 1e3


def same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def lk_compare(pyr0, pyr1, uv, guess, patch: int) -> float:
    """Both LK passes through the kernel and through their plain version
    on the same inputs: checks the bars on each pass and that all four
    outputs are the plain version's to the bit (the kernel sums in
    torch.sum's order on the card).  Returns max |uv - plain| over both
    passes on the lanes `ok` in both."""
    import torch
    from mono_lidar_depth_tpu_torch.tracker import klt

    args = (pyr0, pyr1, uv, guess, patch, LK_ITERS, MIN_DET)
    got = klt._track_passes_cuda(*args)
    torch.cuda.synchronize()
    want = klt._track_passes_reference(*args)
    torch.cuda.synchronize()
    H, W = pyr0[0].shape
    where = f"lk_track {len(pyr0)} levels from {H}x{W} patch {patch}"
    worst, notes = 0.0, []
    for name, g_uv, g_ok, w_uv, w_ok in (
            ("forward", got[0], got[1], want[0], want[1]),
            ("backward", got[2], got[3], want[2], want[3])):
        check(bool(torch.isfinite(g_uv).all()), f"{where}: non-finite "
                                                f"{name} uv")
        both = g_ok & w_ok
        ok_share = float((g_ok == w_ok).float().mean())
        err = (g_uv - w_uv).abs().amax(dim=1)[both]
        pass_worst = float(err.max())
        notes.append(f"{name}: ok lanes kernel {int(g_ok.sum())} plain "
                     f"{int(w_ok.sum())}, ok equal on {ok_share:.5f}, on "
                     f"lanes ok in both max |uv - plain| {pass_worst:.3e} "
                     f"px, share within {LK_TOL_PX} px "
                     f"{float((err <= LK_TOL_PX).float().mean()):.5f}")
        check(ok_share >= LK_OK_SHARE,
              f"{where} {name}: ok agrees on {ok_share:.5f} < {LK_OK_SHARE}")
        check(pass_worst <= LK_TOL_PX,
              f"{where} {name}: max |uv - plain| {pass_worst:.3e} px > "
              f"{LK_TOL_PX}")
        worst = max(worst, pass_worst)
    bits = all(same_bits(a, b) for a, b in zip(got, want))
    moved = float((want[0] - guess).norm(dim=1)[want[1]].median())
    log(f"phase 3 kernels: {where} N={uv.shape[0]} iters {LK_ITERS}: "
        f"{'; '.join(notes)}; median forward move from the guess "
        f"{moved:.3f} px; all four outputs equal to the plain version's to "
        f"the bit: {bits}")
    check(bits, f"{where}: the kernel differs from the plain version in "
          f"its bits under torch {torch.__version__} ({'; '.join(notes)}). "
          f"With the bars met, suspect torch.sum's order on the card: "
          f"csrc/lk_track.cu's TapOrder mirrors torch 2.11's Reduce.cuh")
    return worst


def phase_lk(card: str, img0: np.ndarray, img1: np.ndarray) -> dict:
    """The fused LK passes against their plain version on the 4-level
    pyramid of the rendered frame pair, at the main patch and at every
    other patch the kernel is built for, and the cost of one
    track_frame's LK work."""
    import torch
    import torch.nn.functional as F
    from mono_lidar_depth_tpu_torch.eval.kitti_eval import _dev_img
    from mono_lidar_depth_tpu_torch.tracker import klt

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    N = 2048
    pyr0 = klt.build_pyramid(_dev_img(torch.from_numpy(img0).to(dev)),
                             LEVELS)
    pyr1 = klt.build_pyramid(_dev_img(torch.from_numpy(img1).to(dev)),
                             LEVELS)
    uv, guess = lk_lanes(rng, pyr0, N)
    per_patch = {PATCH: lk_compare(pyr0, pyr1, uv, guess, PATCH)}

    def kernel(iters=LK_ITERS):
        return klt._track_passes_cuda(pyr0, pyr1, uv, guess, PATCH, iters,
                                      MIN_DET)

    def plain():
        return klt._track_passes_reference(pyr0, pyr1, uv, guess, PATCH,
                                           LK_ITERS, MIN_DET)

    ms = device_ms(kernel, "lk_track_kernel")
    ms0 = device_ms(lambda: kernel(0), "lk_track_kernel")
    plain_ms = device_ms(plain, reps=5)
    wrap_ms, wrap_plain_ms = time_ms(kernel), time_ms(plain, reps=5)
    # Library yardstick: per level one grid_sample of the N x 81 patch
    # taps (the sampling of ONE iteration), 2 passes x LK_ITERS times;
    # never called by the port.
    r = (PATCH - 1) // 2
    off = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)
    lib_ms = 0.0
    for lvl, img in enumerate(pyr1):
        H, W = img.shape
        at = guess / 2 ** lvl
        px = at[:, None, None, 0] + off[None, None, :]
        py = at[:, None, None, 1] + off[None, :, None]
        grid = torch.stack([(2 * px / (W - 1) - 1).expand(N, PATCH, PATCH),
                            (2 * py / (H - 1) - 1).expand(N, PATCH, PATCH)],
                           dim=-1).reshape(1, N, PATCH * PATCH, 2)

        def library(img=img, grid=grid):
            return F.grid_sample(img[None, None], grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)

        lib_ms += 2 * LK_ITERS * device_ms(library)
    shapes = [tuple(p.shape) for p in pyr0]
    by_bytes, by_ops = lk_bound_ms(shapes, N)
    bound = max(by_bytes, by_ops)
    by = "bytes" if by_bytes >= by_ops else "operations"
    log(f"phase 3 kernels: lk_track, one launch for both passes over "
        f"{LEVELS} levels {shapes}, N={N}, patch {PATCH}, {LK_ITERS} "
        f"iterations: device time kernel {ms:.4f} ms (template stages "
        f"alone, iters 0: {ms0:.4f} ms; one iteration round of all "
        f"{2 * LEVELS} levels {(ms - ms0) / LK_ITERS:.5f} ms), plain "
        f"{plain_ms:.4f} ms, bound {bound:.5f} ms by {by} (bytes "
        f"{by_bytes:.5f}, operations {by_ops:.5f}); grid_sample of the "
        f"iterations' taps alone (2 x {LEVELS} x {LK_ITERS} calls) "
        f"{lib_ms:.4f} ms; wrapper time (CUDA events, back-to-back calls) "
        f"kernel {wrap_ms:.4f} ms, plain {wrap_plain_ms:.4f} ms [{card}]")
    for patch in OTHER_PATCHES:
        uv_p, guess_p = lk_lanes(rng, pyr0, N, patch)
        per_patch[patch] = lk_compare(pyr0, pyr1, uv_p, guess_p, patch)
    log(f"phase 3 kernels: lk_track per patch, max |uv - plain| on lanes ok "
        f"in both (both passes; each run equal to the plain version to the "
        f"bit): { {p: f'{w:.3e}' for p, w in sorted(per_patch.items())} }")
    return {"max_abs_err": max(per_patch.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def gather_features(rng, H, W, N, scales):
    """Feature positions for the neighbor gather: uniform over the grid
    and a margin around it, then the border cases of every scale (centres
    inside, on and past each edge by less and by more than the half size,
    in u, in v and in both) and NaN and infinite positions."""
    uv = rng.uniform([-12, -12], [W + 12, H + 12], (N, 2))
    edges = []
    for hx, hy, _ in scales:
        ex = [-50.0, -hx - 0.5, -hx, -0.3, 0.0, 0.4, hx - 0.1, hx,
              W - 1 - hx, W - 1 - hx + 0.2, W - 1.0, W - 0.5, float(W),
              W + hx, W + 50.0]
        ey = [-50.0, -hy - 0.5, -hy, -0.3, 0.0, 0.4, hy - 0.1, hy,
              H - 1 - hy, H - 1 - hy + 0.2, H - 1.0, H - 0.5, float(H),
              H + hy, H + 50.0]
        edges += ([(x, H / 2 + 0.37) for x in ex]
                  + [(W / 2 + 0.71, y) for y in ey]
                  + list(zip(ex, ey)) + list(zip(ex, ey[::-1])))
    nan, inf = float("nan"), float("inf")
    edges += [(nan, 10.0), (10.0, nan), (nan, nan), (inf, 5.0), (-inf, 5.0),
              (5.0, inf), (5.0, -inf)]
    check(len(edges) < N, "too few lanes for the border cases")
    uv[N - len(edges):] = edges
    return uv.astype(np.float32)


def gather_bound_ms(stacks, uvs, scales, with_indices
                    ) -> tuple[float, float, float]:
    """The two least times the card could take for one neighbor gather:
    its bytes (every stack and feature set read once; per scale and lane
    mask, flags, z, points and, when asked, indices of every window cell
    and the count written once) over the device-memory rate, and its fp32
    operations (about 15 per cell: unpack, two pinhole products, masks)
    over the fp32 peak.  The bound is the larger.  Also returns the MB
    written."""
    N = sum(uv.shape[0] for uv in uvs)
    cells = sum(Ky * Kx for _, _, (Ky, Kx) in scales)
    per_cell = 1 + 1 + 4 + 12 + (4 if with_indices else 0)
    written = N * cells * per_cell + N * 4 * len(scales)
    read = sum(s.numel() for s in stacks) * 4 + N * 8
    return ((read + written) / PEAK_BYTES_S * 1e3,
            15 * N * cells / PEAK_FP32_S * 1e3, written / 1e6)


def gather_compare(what, stacks, uvs, cam, scales, with_indices) -> float:
    """One neighbor gather through the kernel and through its plain
    version on the same inputs: every field of every scale must be equal
    to the bit; returns max |difference| over the float fields."""
    import torch
    from mono_lidar_depth_tpu_torch.core import neighbors

    got = neighbors.gather_stacks_cuda(stacks, uvs, cam, scales,
                                       with_indices)
    torch.cuda.synchronize()
    want = neighbors.gather_stacks_reference(stacks, uvs, cam, scales,
                                             with_indices)
    torch.cuda.synchronize()
    check(len(got) == len(want) == len(scales), f"{what}: scales returned")
    worst, cells, hits, ground = 0.0, 0, 0, 0
    for k, (g, w) in enumerate(zip(got, want)):
        for name in neighbors.NeighborSet._fields:
            a, b = getattr(g, name), getattr(w, name)
            check((a is None) == (b is None) == (
                name == "indices" and not with_indices),
                f"{what}: scale {k} field {name} present in one only")
            if a is None:
                continue
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{what}: scale {k} field {name} is {a.dtype} "
                  f"{tuple(a.shape)}, plain {b.dtype} {tuple(b.shape)}")
            if a.is_floating_point():
                worst = max(worst, float((a - b).abs().max()))
            check(torch.equal(a, b),
                  f"{what}: scale {k} field {name} differs from the plain "
                  f"version in {int((a != b).sum())} places")
        cells += w.mask.numel()
        hits += int(w.mask.sum())
        ground += int(w.flags.sum())
    check(0 < ground < hits < cells,
          f"{what}: the scene has {hits} neighbors, {ground} on the ground, "
          f"in {cells} cells")
    log(f"phase 3 kernels: gather_neighbors {what}: "
        f"{[tuple(s.shape) for s in stacks]} stacks, "
        f"{[uv.shape[0] for uv in uvs]} features, windows "
        f"{[w for _, _, w in scales]}, indices {with_indices}: every field "
        f"bit-exact; {hits} neighbors ({ground} ground-flagged) in {cells} "
        f"cells")
    return worst


def phase_gather(card: str) -> dict:
    """The fused neighbor gather against its plain version on rasterized
    synthetic scans, at the main path's shapes and around them."""
    import torch
    import bench_torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core import neighbors
    from mono_lidar_depth_tpu_torch.io.kitti import (make_synthetic_scan,
                                                     pad_cloud)
    from mono_lidar_depth_tpu_torch.tracks.pipeline import _ground_plane

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cam, l2c = bench_torch.camera_and_extrinsics(dev)
    N = 2048

    def frames_of(cfg, count):
        out = []
        for _ in range(count):
            scan = make_synthetic_scan(rng, 120000)
            cloud, valid = (torch.from_numpy(a).to(dev) for a in
                            pad_cloud(scan, len(scan), cfg.max_points))
            gp = _ground_plane(cfg, cloud, valid, gen)
            out.append(T.rasterize_cloud(cfg, cam, l2c, cloud, valid, gp))
        return out

    def features(cfg, n, scales):
        return torch.from_numpy(gather_features(
            rng, cfg.image_height, cfg.image_width, n, scales)).to(dev)

    cfg = T.DepthEstimatorConfig()
    hx, hy = (cfg.pixelarea_search_witdh * 0.5,
              cfg.pixelarea_search_height * 0.5)
    scales = [(hx, hy, cfg.primary_window),
              (hx * cfg.road_search_scale_x, hy * cfg.road_search_scale_y,
               cfg.road_window)]
    frames = frames_of(cfg, 2)
    uvs = [features(cfg, N, scales), features(cfg, N, scales)]
    stacks = neighbors.frame_stacks(frames, False)
    stacks3 = neighbors.frame_stacks(frames, True)

    worst = gather_compare("main path", stacks, uvs, cam, scales, False)
    worst = max(
        worst,
        gather_compare("with indices", stacks3, uvs, cam, scales, True),
        gather_compare("one frame", stacks[:1], uvs[:1], cam, scales, False),
        gather_compare("one frame, one scale, indices", stacks3[1:], uvs[1:],
                       cam, scales[:1], True),
        gather_compare("unequal feature counts", stacks,
                       [uvs[0], features(cfg, 777, scales)], cam, scales,
                       False))
    # An odd window pair: one narrower than a warp's round of 32 cells
    # with an odd size, one wider than 32 cells.
    odd = [(1.0, 2.0, (5, 3)), (19.5, 4.0, (9, 40))]
    worst = max(worst, gather_compare(
        "odd windows", stacks3, [features(cfg, N, odd), features(cfg, N, odd)],
        cam, odd, True))
    # Dense made-up stacks: most cells occupied, column 0 and row 0 too
    # (a rasterized scan leaves them empty), which is where the NaN
    # positions look.
    dense = []
    for _ in range(2):
        hit = rng.random((384, 1248)) < 0.7
        z = rng.uniform(1.0, 60.0, hit.shape) * np.where(
            rng.random(hit.shape) < 0.3, -1.0, 1.0)
        packed = (rng.integers(0, 4096, hit.shape) * 4096.0
                  + rng.integers(0, 4096, hit.shape))
        idx = np.where(hit, rng.integers(0, cfg.max_points, hit.shape), -1)
        dense.append(torch.from_numpy(np.stack(
            [np.where(hit, z, 0.0), np.where(hit, packed, 0.0),
             idx]).astype(np.float32)).to(dev))
    worst = max(worst, gather_compare("dense stacks", dense, uvs, cam,
                                      scales, True))
    wide = T.DepthEstimatorConfig(image_width=1280)
    wide_frames = frames_of(wide, 2)
    worst = max(worst, gather_compare(
        "grid 384x1280", neighbors.frame_stacks(wide_frames, False),
        [features(wide, N, scales), features(wide, N, scales)], cam, scales,
        False))

    # ---- times at the main path's shapes
    def kernel(sc=scales):
        return neighbors.gather_stacks_cuda(stacks, uvs, cam, sc, False)

    def plain():
        return neighbors.gather_stacks_reference(stacks, uvs, cam, scales,
                                                 False)

    # Library yardstick: the four crops alone, one advanced-indexing
    # gather each on index tensors made outside the timed call; the
    # decode has no library call.  Never called by the port.
    H, W = cfg.image_height, cfg.image_width
    ready = []
    for stack, uv in zip(stacks, uvs):
        for half_x, half_y, (Ky, Kx) in scales:
            x0 = torch.nan_to_num(torch.clamp(uv[:, 0] - half_x, 0, W)).long()
            y0 = torch.nan_to_num(torch.clamp(uv[:, 1] - half_y, 0, H)).long()
            rows = (y0.clamp(max=H - Ky)[:, None]
                    + torch.arange(Ky, device=dev))[:, :, None]
            cols = (x0.clamp(max=W - Kx)[:, None]
                    + torch.arange(Kx, device=dev))[:, None, :]
            ready.append((stack, rows, cols))

    def library():
        return [stack[:, rows, cols] for stack, rows, cols in ready]

    name = "gather_neighbors_kernel"
    ms = device_ms(kernel, name)
    ms_small = device_ms(lambda: kernel(scales[:1]), name)
    ms_large = device_ms(lambda: kernel(scales[1:]), name)
    ms_one = device_ms(lambda: neighbors.gather_stacks_cuda(
        stacks[:1], uvs[:1], cam, scales, False), name)
    ms_idx = device_ms(lambda: neighbors.gather_stacks_cuda(
        stacks3, uvs, cam, scales, True), name)
    plain_ms = device_ms(plain, reps=5)
    lib_ms = device_ms(library)
    wrap_ms, wrap_plain_ms = time_ms(kernel), time_ms(plain, reps=5)
    by_bytes, by_ops, out_mb = gather_bound_ms(stacks, uvs, scales, False)
    bound = max(by_bytes, by_ops)
    log(f"phase 3 kernels: gather_neighbors per odometry step (2 frames x "
        f"{N} features, {H}x{W}, windows {scales[0][2]} + {scales[1][2]}, "
        f"C=2), device time: kernel {ms:.4f} ms in one launch "
        f"({out_mb / ms:.1f} GB/s of output), bound {bound:.5f} ms by "
        f"{'bytes' if by_bytes >= by_ops else 'operations'} (bytes "
        f"{by_bytes:.5f}, operations {by_ops:.5f}), plain version (crops, "
        f"decode chain, concatenation) {plain_ms:.4f} ms, the four indexing "
        f"gathers of the crops alone {lib_ms:.4f} ms; the kernel on the small "
        f"scale alone {ms_small:.4f} ms, on the large alone {ms_large:.4f} "
        f"ms, on one frame with both scales {ms_one:.4f} ms, with the index "
        f"plane (C=3) {ms_idx:.4f} ms; wrapper time (CUDA events, "
        f"back-to-back calls) kernel {wrap_ms:.4f} ms, plain "
        f"{wrap_plain_ms:.4f} ms [{card}]")
    # ---- the form that region growing launches: one frame, both scales,
    # the index plane as a third plane (C=3), twice per odometry step
    one3, one_uv = stacks3[:1], uvs[:1]

    def kernel_rg():
        return neighbors.gather_stacks_cuda(one3, one_uv, cam, scales, True)

    def plain_rg():
        return neighbors.gather_stacks_reference(one3, one_uv, cam, scales,
                                                 True)

    ready3 = [(one3[0], rows, cols) for _, rows, cols in ready[:len(scales)]]

    def library_rg():
        return [stack[:, rows, cols] for stack, rows, cols in ready3]

    rg_ms = device_ms(kernel_rg, name)
    rg_plain_ms = device_ms(plain_rg, reps=5)
    rg_lib_ms = device_ms(library_rg)
    rg_stack_ms = device_ms(lambda: neighbors.frame_stacks(frames[:1], True))
    rg_bytes, rg_ops, rg_mb = gather_bound_ms(one3, one_uv, scales, True)
    idx_bytes, idx_ops, _ = gather_bound_ms(stacks3, uvs, scales, True)
    log(f"phase 3 kernels: gather_neighbors with the index plane, as "
        f"region growing launches it (1 frame x {N} features, {H}x{W}, "
        f"windows {scales[0][2]} + {scales[1][2]}, C=3), device time per "
        f"launch: kernel {rg_ms:.4f} ms ({rg_mb / rg_ms:.1f} GB/s of output), "
        f"bound {max(rg_bytes, rg_ops):.5f} ms by "
        f"{'bytes' if rg_bytes >= rg_ops else 'operations'} (bytes "
        f"{rg_bytes:.5f}, operations {rg_ops:.5f}), plain version "
        f"{rg_plain_ms:.4f} ms, the two indexing gathers of its crops alone "
        f"{rg_lib_ms:.4f} ms; building the C=3 stack (cat of planes and "
        f"grid) {rg_stack_ms:.4f} ms; an odometry step launches it twice: "
        f"kernel {2 * rg_ms:.4f} ms, bound {2 * max(rg_bytes, rg_ops):.5f} "
        f"ms; the two-frame C=3 form {ms_idx:.4f} ms against a bound of "
        f"{max(idx_bytes, idx_ops):.5f} ms [{card}]")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": lib_ms,
            "indices_form": {
                "shape": f"1 frame x {N} features, C=3, with_indices",
                "ms": rg_ms, "plain_ms": rg_plain_ms,
                "bound_ms": max(rg_bytes, rg_ops),
                "bound_by": "bytes" if rg_bytes >= rg_ops else "operations",
                "library_ms": rg_lib_ms, "two_frames_ms": ms_idx,
                "two_frames_bound_ms": max(idx_bytes, idx_ops)}}


def gate_lanes(rng, H, W, N, patch, tracked):
    """The gate's inputs for N lanes as numpy arrays (uv, uv_f, uv_b,
    valid, ok_f, ok_b): first the `tracked` lanes as they are (the results
    of a real forward and backward pass), then random positions whose
    forward-backward error straddles its threshold, and last the special
    lanes: `border_centres`, tracked positions on and beside the in-image
    limits, backward errors on and beside the threshold, NaN and infinite
    coordinates in each of the three position arrays."""
    uv = rng.uniform([0, 0], [W - 1, H - 1], (N, 2))
    uv_f = uv + rng.normal(0.0, 1.0, (N, 2))
    uv_b = uv + rng.normal(0.0, 0.7, (N, 2))
    flags = [rng.random(N) < 0.9 for _ in range(3)]
    n = len(tracked[0])
    uv[:n], uv_f[:n], uv_b[:n] = tracked[:3]
    for flag, real in zip(flags, tracked[3:]):
        flag[:n] = real
    special = [(e, (e[0] + 0.4, e[1] - 0.3), (e[0] + 0.1, e[1]))
               for e in border_centres(H, W, patch)]
    c = (W / 2 + 0.25, H / 2 + 0.5)
    f32 = np.float32
    nan, inf = float("nan"), float("inf")
    for lim_x, lim_y in ((1.0, c[1]), (W - 2.0, c[1]), (c[0], 1.0),
                         (c[0], H - 2.0)):
        for toward in (None, -inf, inf):  # on the limit, one float beside
            special.append((c, tuple(
                float(lim if toward is None
                      else np.nextafter(f32(lim), f32(toward)))
                for lim in (lim_x, lim_y)), c))
    one = FB_THRESHOLD
    for d in (one, float(np.nextafter(f32(one), f32(0))),
              float(np.nextafter(f32(one), f32(2))), 0.6):
        special.append((c, (c[0] + 1, c[1]), (c[0] + d, c[1])))
        special.append((c, (c[0] + 1, c[1]), (c[0] + 0.8 * d, c[1] - 0.6 * d)))
    for bad in (nan, inf, -inf):
        for k in range(3):
            for axis in range(2):
                lane = [list(c), [c[0] + 1, c[1]], list(c)]
                lane[k][axis] = bad
                special.append(tuple(map(tuple, lane)))
        special.append(((bad, bad),) * 3)
    check(n + len(special) < N, "too few lanes for the special cases")
    for i, (a, b, back) in enumerate(special, N - len(special)):
        uv[i], uv_f[i], uv_b[i] = a, b, back
        for flag in flags:
            flag[i] = True  # the special lanes pass or fail on merit
    return (uv.astype(f32), uv_f.astype(f32), uv_b.astype(f32), *flags)


def tracked_gate_lanes(rng, pyr0, pyr1, N, patch, n_tracked=1400):
    """The gate's inputs on the card for the finest level of two pyramids:
    corners tracked forward and backward over all their levels, then
    `gate_lanes`' other cases."""
    import torch
    from mono_lidar_depth_tpu_torch.tracker import harris, klt

    H, W = pyr0[0].shape
    uv, valid = harris.detect_features(pyr0[0], n_tracked, cell_size=4,
                                       border=2)
    uv_f, ok_f, uv_b, ok_b = klt._track_passes(pyr0, pyr1, uv, None, patch,
                                               LK_ITERS, MIN_DET)
    tracked = [x.cpu().numpy() for x in (uv, uv_f, uv_b, valid, ok_f, ok_b)]
    return [torch.from_numpy(x).to(uv.device) for x in
            gate_lanes(rng, H, W, N, patch, tracked)]


def gate_compare(prev, nxt, lanes, patch: int) -> float:
    """The gate through the kernel and through its plain version on the
    same inputs: checks the bars and returns max |ncc - plain| over the
    lanes that are compared."""
    import torch
    from mono_lidar_depth_tpu_torch.tracker import klt

    H, W = prev.shape
    uv, uv_f, uv_b = lanes[:3]
    N = uv.shape[0]
    got_ok, got_ncc = klt._track_gate_cuda(prev, nxt, *lanes, patch, MIN_NCC,
                                           FB_THRESHOLD)
    torch.cuda.synchronize()
    want_ok, want_ncc = klt._track_gate_reference(prev, nxt, *lanes, patch,
                                                  MIN_NCC, FB_THRESHOLD)
    # the plain version's denominator and forward-backward error, from
    # its own parts
    a = klt._bilinear_patches(prev, uv, patch)
    b = klt._bilinear_patches(nxt, uv_f, patch)
    am = a - torch.mean(a, dim=1, keepdim=True)
    bm = b - torch.mean(b, dim=1, keepdim=True)
    den = torch.sqrt(torch.sum(am * am, dim=1) * torch.sum(bm * bm, dim=1))
    d = uv_b - uv
    fb_err = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    torch.cuda.synchronize()
    what = f"zncc_gate {H}x{W} N={N} patch {patch}"
    check(got_ok.dtype == torch.bool and got_ncc.dtype == torch.float32
          and got_ok.shape == want_ok.shape == got_ncc.shape == (N,),
          f"{what}: output types or shapes")
    nan_lane = torch.isnan(uv).any(1) | torch.isnan(uv_f).any(1)
    check(torch.equal(torch.isnan(want_ncc), nan_lane)
          and torch.equal(torch.isnan(got_ncc), nan_lane),
          f"{what}: ncc is not NaN exactly on the lanes with a NaN "
          f"coordinate in uv or uv_f")
    bad = ~(torch.isfinite(uv).all(1) & torch.isfinite(uv_f).all(1)
            & torch.isfinite(uv_b).all(1))
    check(int(bad.sum()) >= 21 and not bool(got_ok[bad].any())
          and not bool(want_ok[bad].any()),
          f"{what}: a lane with a non-finite coordinate passed")
    flat = den < GATE_FLAT_DEN
    held = ~nan_lane & ~flat
    worst = float((got_ncc - want_ncc).abs()[held].max())
    flat_worst = (float(torch.cat([got_ncc[flat], want_ncc[flat]]).abs()
                        .max()) if bool(flat.any()) else 0.0)
    decided = ~(((want_ncc - MIN_NCC).abs() <= GATE_TOL)
                | ((fb_err - FB_THRESHOLD).abs() <= GATE_TOL))
    equal = got_ok == want_ok
    share = float(equal.float().mean())
    log(f"phase 3 kernels: {what}: ok lanes kernel {int(got_ok.sum())} plain "
        f"{int(want_ok.sum())}, ok equal on {share:.5f} of all lanes and on "
        f"{int(equal[decided].sum())} of the {int(decided.sum())} lanes "
        f"farther than {GATE_TOL} from a threshold; max |ncc - plain| "
        f"{worst:.3e} on {int(held.sum())} lanes, {int(flat.sum())} flat "
        f"lanes with |ncc| <= {flat_worst:.2e}, {int(nan_lane.sum())} NaN "
        f"lanes NaN in both, {int(bad.sum())} non-finite lanes rejected")
    check(worst <= GATE_TOL, f"{what}: max |ncc - plain| {worst:.3e} > "
                             f"{GATE_TOL}")
    check(flat_worst <= GATE_FLAT_NCC,
          f"{what}: |ncc| {flat_worst:.2e} on a flat lane")
    check(bool(equal[decided].all()),
          f"{what}: ok differs on {int((~equal[decided]).sum())} lanes away "
          f"from the thresholds")
    check(share >= GATE_OK_SHARE, f"{what}: ok agrees on {share:.5f} < "
                                  f"{GATE_OK_SHARE}")
    check(0 < int(want_ok.sum()) < N - int(bad.sum()),
          f"{what}: the gate passes {int(want_ok.sum())} of {N} lanes")
    return worst


def gate_bound_ms(H, W, N, patch) -> tuple[float, float]:
    """The two least times the card could take for one gate: its bytes
    (both images, three positions and three flags per lane read once, ok
    and ncc written once) over the device-memory rate, and its fp32
    operations (per patch tap: blend 9, mean 1, centring 1, three
    products 6, index arithmetic not counted: about 20 with the sums'
    butterflies, for two patches) over the fp32 peak.  The bound is the
    larger."""
    nbytes = 2 * H * W * 4 + N * (3 * 8 + 3) + N * 5
    flops = N * 2 * patch * patch * 20
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_S * 1e3


def phase_gate(card: str, img0: np.ndarray, img1: np.ndarray) -> dict:
    """The fused acceptance gate against its plain version on the rendered
    frame pair: at the main path's shape on the results of a real forward
    and backward LK pass, then at every other patch size and on the
    coarsest level."""
    import torch
    import torch.nn.functional as F
    from mono_lidar_depth_tpu_torch.eval.kitti_eval import _dev_img
    from mono_lidar_depth_tpu_torch.tracker import klt

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    N = 2048
    pyr0 = klt.build_pyramid(_dev_img(torch.from_numpy(img0).to(dev)),
                             LEVELS)
    pyr1 = klt.build_pyramid(_dev_img(torch.from_numpy(img1).to(dev)),
                             LEVELS)

    def lanes_of(lvl, patch, n_tracked=1400):
        return tracked_gate_lanes(rng, pyr0[lvl:], pyr1[lvl:], N, patch,
                                  n_tracked)

    prev, nxt = pyr0[0], pyr1[0]
    H, W = prev.shape
    lanes = lanes_of(0, PATCH)
    worst = gate_compare(prev, nxt, lanes, PATCH)

    def kernel():
        return klt._track_gate_cuda(prev, nxt, *lanes, PATCH, MIN_NCC,
                                    FB_THRESHOLD)

    def plain():
        return klt._track_gate_reference(prev, nxt, *lanes, PATCH, MIN_NCC,
                                         FB_THRESHOLD)

    # Library yardstick: the sampling alone, one grid_sample per patch set
    # (N x 81 taps each) on grids made outside the timed call; no
    # correlation, no gate.  Never called by the port.
    r = (PATCH - 1) // 2
    off = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)

    def grid_of(centres):
        centres = torch.nan_to_num(centres, nan=0.0, posinf=1e6, neginf=-1e6)
        px = centres[:, None, None, 0] + off[None, None, :]
        py = centres[:, None, None, 1] + off[None, :, None]
        return torch.stack(
            [(2 * px / (W - 1) - 1).expand(N, PATCH, PATCH),
             (2 * py / (H - 1) - 1).expand(N, PATCH, PATCH)],
            dim=-1).reshape(1, N, PATCH * PATCH, 2)

    grid0, grid1 = grid_of(lanes[0]), grid_of(lanes[1])

    def library():
        return (F.grid_sample(prev[None, None], grid0, mode="bilinear",
                              padding_mode="border", align_corners=True),
                F.grid_sample(nxt[None, None], grid1, mode="bilinear",
                              padding_mode="border", align_corners=True))

    # grid_sample clamps the sample point and the plain version each tap,
    # which is the same inside the image: hold the yardstick to the plain
    # patches there, so that it times the same sampling.
    inside = ((lanes[0] > r + 1).all(1) & (lanes[0][:, 0] < W - r - 2)
              & (lanes[0][:, 1] < H - r - 2))
    lib_err = float((library()[0][0, 0][inside]
                     - klt._bilinear_patches(prev, lanes[0], PATCH)[inside]
                     ).abs().max())
    check(lib_err <= 1e-3, f"grid_sample patches differ from the plain "
                           f"patches by {lib_err:.2e}")

    ms = device_ms(kernel, "zncc_gate_kernel")
    # One block of 4 lanes: a launch and one chain of dependent rounds,
    # which is what the full launch's time is mostly made of.
    few = [x[:4].contiguous() for x in lanes]
    ms_few = device_ms(lambda: klt._track_gate_cuda(
        prev, nxt, *few, PATCH, MIN_NCC, FB_THRESHOLD), "zncc_gate_kernel")
    plain_ms = device_ms(plain, reps=10)
    lib_ms = device_ms(library)
    wrap_ms, wrap_plain_ms = time_ms(kernel), time_ms(plain, reps=10)
    by_bytes, by_ops = gate_bound_ms(H, W, N, PATCH)
    bound = max(by_bytes, by_ops)
    by = "bytes" if by_bytes >= by_ops else "operations"
    log(f"phase 3 kernels: zncc_gate per track_frame ({H}x{W}, N={N}, patch "
        f"{PATCH}), device time: kernel {ms:.4f} ms in one launch (on 4 lanes alone "
        f"{ms_few:.4f} ms), plain "
        f"version (2 edge pads, 2 crops, blends, correlation, gate) "
        f"{plain_ms:.4f} ms, bound {bound:.5f} ms by {by} (bytes "
        f"{by_bytes:.5f}, operations {by_ops:.5f}), two grid_sample calls "
        f"for the taps alone {lib_ms:.4f} ms (within {lib_err:.1e} of the "
        f"plain patches inside the image); wrapper time (CUDA events, "
        f"back-to-back calls) kernel {wrap_ms:.4f} ms, plain "
        f"{wrap_plain_ms:.4f} ms [{card}]")

    # The kernel's other instantiations at the finest level, and the main
    # patch on the coarsest (correctness only).
    for patch in OTHER_PATCHES:
        worst = max(worst, gate_compare(prev, nxt, lanes_of(0, patch), patch))
    small = LEVELS - 1
    worst = max(worst, gate_compare(pyr0[small], pyr1[small],
                                    lanes_of(small, PATCH, 600), PATCH))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


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
    """bench_torch's scene (bench.py's: the reference defaults at the full
    KITTI size, the KITTI camera and extrinsics, distinct 120,000-point
    synthetic clouds and persistent drifting tracks from SEED) over
    frames + 1 frames, moved to the card in bulk before the run: frame
    0's cloud is the one prime_state installs, frames 1..frames are the
    odometry steps, all drawing RANSAC from one generator."""
    import torch
    import bench_torch
    import mono_lidar_depth_tpu_torch as T

    dev = torch.device("cuda")
    bench = bench_torch.bench_scene(frames + 1)
    cfg, ocfg = bench.cfg, T.OdometryConfig()
    cam, lidar_to_cam = bench_torch.camera_and_extrinsics(dev)
    stacked = bench_torch.scene_frames(bench, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scene = Scene(
        cfg=cfg, ocfg=ocfg, cam=cam, lidar_to_cam=lidar_to_cam,
        state=T.OdometryState.create(cfg, ocfg, cfg.max_features, 12, dev),
        cloud0=stacked.cloud[0], valid0=stacked.cloud_valid[0], gen=gen,
        inputs=[bench_torch.frame_at(stacked, k, gen)
                for k in range(1, frames + 1)])
    torch.cuda.synchronize()
    return scene


def prime(sc: Scene):
    """The odometry state with the scene's first cloud installed."""
    import mono_lidar_depth_tpu_torch as T

    return sc.state._replace(tracklets=T.prime_state(
        sc.cfg, sc.cam, sc.lidar_to_cam, sc.state.tracklets, sc.cloud0,
        sc.valid0, sc.gen))


def phase_main(card: str) -> dict:
    import warnings

    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core import neighbors, windows
    from mono_lidar_depth_tpu_torch.obs.stats import success_rates
    from mono_lidar_depth_tpu_torch.tracker import klt
    from mono_lidar_depth_tpu_torch.tracks.table import match_tracks

    sc = bench_scene()
    cfg, M = sc.cfg, sc.cfg.max_features
    log(f"phase 4 main: cloud {cfg.max_points} points, {M} features, grid "
        f"{cfg.image_height}x{cfg.image_width}, RANSAC "
        f"{cfg.ransac_num_hypotheses}x{cfg.ransac_subsample_points}, track "
        f"table {M}x12, {FRAMES} frames")

    neighbors.launches = 0  # count the main path's launches only
    windows.launches = klt.launches = klt.gate_launches = 0
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
    launches, crops = neighbors.launches, windows.launches
    tracker = klt.launches + klt.gate_launches
    step_ms = [a.elapsed_time(b) for a, b in step_ms]

    check(launches == FRAMES and crops == 0 and tracker == 0,
          f"{launches} gather_neighbors, {crops} slice_windows and {tracker} "
          f"tracker-kernel launches in {FRAMES} steps, want {FRAMES}, 0, 0")
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
        f"{SUCCESS_FLOOR}, gather_neighbors launches {launches} == "
        f"{FRAMES} (one per step), slice_windows launches {crops}, all "
        f"tensors on {leaves[0].device}; last t_cw {t_last}")
    log(f"phase 4 main: per-frame odometry step (CUDA events) median "
        f"{float(np.median(step_ms)):.3f} ms, first {step_ms[0]:.3f} ms, "
        f"all {[round(x, 3) for x in step_ms]}; prime + {FRAMES} steps "
        f"wall {wall:.3f} s [{card}]")
    log("phase 4 main: outcome counters " + json.dumps(
        [int(c) for c in total]))

    # No host sync inside the fused depth pair's neighbor gather, and
    # exactly one in a whole step: where vo/pipeline.py reads its two
    # branch predicates.
    last, tr = sc.inputs[-1], state.tracklets
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as in_gather:
            warnings.simplefilter("always")
            neighbors.gather_neighbors_two_scales(
                tr.frame_last, sc.cam, last.uv_new, 3.0, 4.5, 2.0, 1.5,
                cfg.primary_window, cfg.road_window, with_indices=False)
            neighbors.gather_neighbors_frames(
                [tr.frame_last, tr.frame_last], [last.uv_prev, last.uv_new],
                sc.cam, [(3.0, 4.5, cfg.primary_window)], with_indices=True)
        with warnings.catch_warnings(record=True) as in_step:
            warnings.simplefilter("always")
            T.odometry_step(cfg, sc.ocfg, sc.cam, sc.lidar_to_cam, state,
                            last)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    def syncs(caught):
        return [f"{w.filename.rsplit('/', 2)[-2]}/"
                f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                for w in caught if "synchroniz" in str(w.message)]

    check(not syncs(in_gather),
          f"the neighbor gather synchronized with the host: "
          f"{syncs(in_gather)[:3]}")
    step_syncs = syncs(in_step)
    check(len(step_syncs) == 1 and step_syncs[0].startswith("vo/pipeline.py:"),
          f"one odometry step synchronized with the host at {step_syncs}; "
          f"want exactly one place, in vo/pipeline.py")
    log(f"phase 4 main: no host sync inside the neighbor gather (sync debug "
        f"mode); one odometry step synchronizes with the host once, at "
        f"{step_syncs[0]}")
    return {"gather_neighbors": launches, "slice_windows": crops}


# --------------------------------------------------------------- phase 5

def _small_world(rng, F, M, P, cam):
    """A metric world (ground + facades) seen from a camera driving 1 m
    per frame with a slight yaw: clouds in the lidar frame, persistent
    feature tracks with 0.2 px noise, and the true camera centers."""
    from bench_torch import R_LC

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
    import bench_torch
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
        lidar_to_cam = T.SE3(torch.from_numpy(bench_torch.R_LC).to(dev),
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


# --------------------------------------------------------------- phase 6

def _numpy_draws(rng, cfg, n_valid: int):
    """RANSAC draws of one frame made with numpy, so that the card and
    the CPU fit the same hypotheses."""
    return (rng.integers(0, max(n_valid, 1), cfg.ransac_subsample_points),
            rng.integers(0, cfg.ransac_subsample_points,
                         (cfg.ransac_num_hypotheses, 3)))


def phase_images(card: str, seq, render_s: float) -> dict:
    import warnings

    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.convert import (state_from_numpy,
                                                    state_to_numpy)
    from mono_lidar_depth_tpu_torch.core import neighbors, windows
    from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
    from mono_lidar_depth_tpu_torch.eval.kitti_eval import (_dev_img,
                                                            _frame_rng,
                                                            _frame_seed)
    from mono_lidar_depth_tpu_torch.io.kitti import pad_cloud
    from mono_lidar_depth_tpu_torch.tracker import frontend, klt
    from mono_lidar_depth_tpu_torch.vo.metrics import rpe_stats

    dev = torch.device("cuda")
    cfg = T.DepthEstimatorConfig()
    ocfg = T.OdometryConfig()
    N = cfg.max_features
    cam = seq.camera
    l2c = seq.lidar_to_cam(dev)
    steps = len(seq) - 1
    log(f"phase 6 images: {len(seq)} frames {cam.width}x{cam.height} "
        f"rendered in {render_s:.2f} s, scans of "
        f"{[len(x) for x in seq.raw_scans][:3]}.. points padded to "
        f"{cfg.max_points}, {N} tracker lanes, cell 16, {LEVELS} levels, "
        f"patch {PATCH}, {LK_ITERS} iterations")

    # ---- the main path: frame_inputs -> odometry_step, counts per frame
    state = T.OdometryState.create(cfg, ocfg, N, 12, dev)
    prime: list = []
    frames = T.frame_inputs(seq, cfg, prime=prime, pyramid_levels=LEVELS,
                            device=dev, seed=SEED)
    kernel_names = ("lk_track", "zncc_gate", "slice_windows",
                    "gather_neighbors")

    def launched():
        return (klt.launches, klt.gate_launches, windows.launches,
                neighbors.launches)

    def reset_counts():
        klt.launches = klt.gate_launches = 0
        windows.launches = neighbors.launches = 0

    reset_counts()
    counts, events, inputs, outs = [], [], [], []
    t0 = time.perf_counter()
    for k in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        frame, f = next(frames)
        after_track = launched()
        if k == 0:
            state = state._replace(tracklets=T.prime_state(
                cfg, cam, l2c, state.tracklets, prime[0][0], prime[0][1],
                _frame_rng(_frame_seed(SEED, 0), dev)))
        ev[1].record()
        state, R_cw, t_cw, diag = T.odometry_step(cfg, ocfg, cam, l2c, state,
                                                  frame)
        ev[2].record()
        counts.append(after_track + launched())
        events.append(ev)
        inputs.append(frame)
        outs.append((R_cw, t_cw, diag))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = launched()
    check(next(frames, None) is None, "frame_inputs yielded too many frames")

    # counts: cumulative launches of `kernel_names` after track_frame and
    # after the step
    c = np.asarray(counts)
    before = np.concatenate([[[0, 0, 0, 0]], c[:-1, 4:]])
    in_track, in_step = c[:, :4] - before, c[:, 4:] - c[:, :4]
    check(bool((in_track == [1, 1, 0, 0]).all()
               and (in_step == [0, 0, 0, 1]).all()),
          f"launches {kernel_names} per frame: track_frame "
          f"{in_track.tolist()}, want [1, 1, 0, 0]; odometry_step "
          f"{in_step.tolist()}, want [0, 0, 0, 1]")
    leaves = list(tensors_of((state, outs, inputs)))
    check(all(x.is_cuda for x in leaves), "an image-path tensor left the GPU")

    emit = [float(f.ids_valid.float().mean()) for f in inputs]
    check(min(emit[1:]) > EMIT_FLOOR,
          f"emitted share of lanes {emit} <= floor {EMIT_FLOOR}")
    kept = []
    for a, b in zip(inputs[:-1], inputs[1:]):
        same = a.ids_valid & b.ids_valid & (a.ids == b.ids)
        check(bool((a.uv_new[same] == b.uv_prev[same]).all()),
              "an emitted id's uv_prev is not its previous uv_new")
        kept.append(int(same.sum()))
    check(min(kept) > 0, "no track id persisted from one frame to the next")
    for k, (R_cw, t_cw, diag) in enumerate(outs):
        check(bool(torch.isfinite(R_cw).all() & torch.isfinite(t_cw).all()
                   & torch.isfinite(diag).all()),
              f"image frame {k}: non-finite pose or diagnostics")
        det = float(torch.linalg.det(R_cw.double()))
        check(abs(det - 1.0) < 1e-3, f"image frame {k}: det(R_cw) = {det}")
    R = torch.stack([o[0] for o in outs]).cpu().numpy().astype(np.float64)
    t = torch.stack([o[1] for o in outs]).cpu().numpy().astype(np.float64)
    poses = np.tile(np.eye(4), (steps, 1, 1))
    poses[:, :3, :3] = R.transpose(0, 2, 1)
    poses[:, :3, 3] = -np.einsum("fij,fj->fi", R.transpose(0, 2, 1), t)
    gt = seq.gt_poses[1:]
    # The first processed frame has no previous-frame depths, so its
    # motion is unobservable; measure the path after that transient.
    s = 3
    est_len = float(np.linalg.norm(poses[-1, :3, 3] - poses[s, :3, 3]))
    gt_len = float(np.linalg.norm(gt[-1, :3, 3] - gt[s, :3, 3]))
    path_err = abs(est_len - gt_len) / gt_len
    rpe = rpe_stats(poses[s:], gt[s:])
    ms_in = [e[0].elapsed_time(e[1]) for e in events]
    ms_step = [e[1].elapsed_time(e[2]) for e in events]
    log(f"phase 6 images: {steps} frames ok: per frame 1 lk_track "
        f"+ 1 zncc_gate + 0 slice_windows launches in track_frame and 1 "
        f"gather_neighbors in odometry_step (totals "
        f"{dict(zip(kernel_names, total))}), all tensors on "
        f"{leaves[0].device}; emitted share "
        f"of lanes {[round(x, 4) for x in emit]} > floor {EMIT_FLOOR} from "
        f"the second frame on; ids kept frame to frame {kept}; diag "
        f"[tracks, inliers, err px] of the last frame "
        f"{[round(float(x), 3) for x in outs[-1][2]]}")
    log(f"phase 6 images: path length after frame {s + 1}: "
        f"{est_len:.4f} m vs truth {gt_len:.4f} m ({100 * path_err:.2f}% "
        f"off); RPE trans {rpe['trans_rmse']:.4f} m rot "
        f"{rpe['rot_rmse_deg']:.4f} deg per frame")
    check(path_err < 0.05, f"image path length {100 * path_err:.2f}% off")
    log(f"phase 6 images: per frame (CUDA events) upload + track_frame "
        f"median {float(np.median(ms_in[1:])):.3f} ms, all "
        f"{[round(x, 3) for x in ms_in]} (the first holds init_tracker and "
        f"prime_state); odometry step median "
        f"{float(np.median(ms_step)):.3f} ms, all "
        f"{[round(x, 3) for x in ms_step]}; {steps} frames wall "
        f"{wall:.3f} s [{card}]")

    # ---- the same frames through the sequence entry point
    reset_counts()
    t0 = time.perf_counter()
    res = T.eval_vo_sequence(seq, cfg, ocfg, max_tracks=N, max_length=12,
                             verbose=False, device=dev, seed=SEED)
    eval_s = time.perf_counter() - t0
    check(launched() == total,
          f"eval_vo_sequence launched {launched()} kernels {kernel_names}, "
          f"the frame loop {total}")
    check(res["frames"] == steps and res["frame_ids"] == list(
        range(1, len(seq))), f"eval_vo_sequence frames {res['frame_ids']}")
    # The same per-frame seeds as the loop above, so the same RANSAC
    # draws; the bars are phase 5's.
    dR = float(np.abs(res["poses"][:, :3, :3] - poses[:, :3, :3]).max())
    dt = float(np.abs(res["poses"][:, :3, 3] - poses[:, :3, 3]).max())
    check(dR <= 1e-3 and dt <= 5e-3,
          f"eval_vo_sequence poses differ from the frame loop's: |dR| "
          f"{dR:.2e}, |dt| {dt:.2e}")
    full = rpe_stats(poses, gt)
    check(abs(res["rpe_trans_rmse"] - full["trans_rmse"]) <= 5e-3,
          f"eval_vo_sequence RPE {res['rpe_trans_rmse']:.4f} m, the frame "
          f"loop's {full['trans_rmse']:.4f} m")
    log(f"phase 6 images: eval_vo_sequence over the same frames in "
        f"{eval_s:.3f} s: {klt.launches} lk_track + {klt.gate_launches} "
        f"zncc_gate + {windows.launches} slice_windows + "
        f"{neighbors.launches} gather_neighbors launches as the frame loop; "
        f"poses against the "
        f"loop's max |dR| {dR:.2e}, max |dt| {dt:.2e} m; over all {steps} "
        f"frames ATE {res['ate_rmse']:.4f} m, RPE trans "
        f"{res['rpe_trans_rmse']:.4f} m (loop {full['trans_rmse']:.4f} m) "
        f"rot {res['rpe_rot_rmse_deg']:.4f} deg [{card}]")

    # ---- track_frame alone, and no host sync inside it
    imgs = [_dev_img(torch.from_numpy(seq.image(i)).to(dev))
            for i in range(len(seq))]
    tstate = frontend.init_tracker(imgs[0], N, levels=LEVELS)
    tstates = [tstate]
    for img in imgs[1:3]:
        tstate, _ = frontend.track_frame(tstate, img)
        tstates.append(tstate)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            frontend.track_frame(tstates[2], imgs[3])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    check(not syncs, f"track_frame synchronized with the host: {syncs[:3]}")
    track_ms = time_ms(lambda: frontend.track_frame(tstates[2], imgs[3]),
                       reps=10)
    log(f"phase 6 images: track_frame alone, no host sync inside (sync "
        f"debug mode), wrapper time over 10 back-to-back calls "
        f"{track_ms:.3f} ms [{card}]")

    # ---- the card against the CPU's plain versions, frame by frame: the
    # CPU tracker starts every frame from the card's tracker state, and
    # both odometry chains take the same numpy RANSAC draws.
    rng = np.random.default_rng(SEED + 11)
    cpu = torch.device("cpu")
    l2c_cpu = seq.lidar_to_cam(cpu)
    scans = list(seq.scans(cfg.max_points))
    clouds = [pad_cloud(x, n, cfg.max_points) for x, n in scans]
    draws = [_numpy_draws(rng, cfg, n) for _, n in scans]

    def prime_on(d, l2c_d):
        st = T.OdometryState.create(cfg, ocfg, N, 12, d)
        return st._replace(tracklets=T.prime_state(
            cfg, cam, l2c_d, st.tracklets,
            torch.from_numpy(clouds[0][0]).to(d),
            torch.from_numpy(clouds[0][1]).to(d),
            RansacDraws(*(torch.from_numpy(a).to(d) for a in draws[0]))))

    def frame_on(d, out, k):
        return T.FrameInput(
            cloud=torch.from_numpy(clouds[k][0]).to(d),
            cloud_valid=torch.from_numpy(clouds[k][1]).to(d),
            ids=out.ids, ids_valid=out.valid, uv_new=out.uv_new,
            uv_prev=out.uv_prev,
            stamp=torch.tensor(float(seq.times[k]), device=d),
            rng=RansacDraws(*(torch.from_numpy(a).to(d) for a in draws[k])))

    g_state, c_state = prime_on(dev, l2c), prime_on(cpu, l2c_cpu)
    tstate = tstates[0]
    ok_agree, uv_err, dR, dt = [], [], 0.0, 0.0
    t0 = time.perf_counter()
    for k in range(1, len(seq)):
        c_tstate = state_from_numpy(state_to_numpy(tstate), cpu)
        tstate, g_out = frontend.track_frame(tstate, imgs[k])
        _, c_out = frontend.track_frame(c_tstate, imgs[k].cpu())
        g_valid = g_out.valid.cpu()
        ok_agree.append(float((g_valid == c_out.valid).float().mean()))
        both = g_valid & c_out.valid
        uv_err.append(float((g_out.uv_new.cpu() - c_out.uv_new)
                            .abs().amax(dim=1)[both].max()))
        g_state, gR, gt_, _ = T.odometry_step(cfg, ocfg, cam, l2c, g_state,
                                              frame_on(dev, g_out, k))
        c_state, cR, ct, _ = T.odometry_step(cfg, ocfg, cam, l2c_cpu,
                                             c_state, frame_on(cpu, c_out, k))
        dR = max(dR, float((gR.cpu() - cR).abs().max()))
        dt = max(dt, float((gt_.cpu() - ct).abs().max()))
    log(f"phase 6 images: card vs CPU plain versions over {steps} frames "
        f"({time.perf_counter() - t0:.1f} s): emitted lanes agree "
        f"{[round(x, 5) for x in ok_agree]}, max |uv| difference on lanes "
        f"emitted by both {[float(f'{x:.2e}') for x in uv_err]} px, poses "
        f"max |dR| {dR:.2e}, max |dt| {dt:.2e} m [{card}]")
    check(min(ok_agree) >= 0.99,
          f"card/CPU emitted-lane agreement {min(ok_agree):.5f} < 0.99")
    check(max(uv_err) <= 1e-2,
          f"card/CPU tracked positions differ by {max(uv_err):.2e} px")
    check(dR <= 1e-3 and dt <= 5e-3,
          f"card/CPU image-path poses differ: |dR| {dR:.2e}, |dt| {dt:.2e}")
    return dict(zip(kernel_names, total))


# --------------------------------------------------------------- phase 7

def _span_gap(a, b) -> str:
    """The relative gaps between two triangles' spans (corners [3, 3]) as
    `max_spanning_triangle` ranks them: the squared longest side, then the
    third corner's sum of squared legs; a gap at rounding level is a tie
    that either device may break either way."""
    def spans(c):
        c = np.asarray(c, np.float64)
        return (((c[0] - c[1]) ** 2).sum(),
                ((c[2] - c[0]) ** 2).sum() + ((c[2] - c[1]) ** 2).sum())

    gaps = [abs(x - y) / max(x, y, 1e-30) for x, y in zip(spans(a), spans(b))]
    return f"{gaps[0]:.1e}/{gaps[1]:.1e}"


class _GateMargins:
    """While open, records what the primary path of the depth cascade
    (its first histogram and `_segment_depth` call of a `process_frame`)
    decided on, per lane: the window's neighbor count, the histogram
    segment's point count and lower bin border, the planarity score (the
    least cross-product norm of the triangle's unit edges) minus its
    threshold, the depth's distance inside the local interval [min z -
    tol, max z + tol] of the segment (negative: outside), and the
    triangle's corners."""

    def __enter__(self):
        import torch
        from mono_lidar_depth_tpu_torch.core import depth_estimator as DE
        from mono_lidar_depth_tpu_torch.core import planefit as PF

        self.module, self.rec = DE, {}
        self.real = (DE.check_planar, DE._apply_depth_gates,
                     DE.filter_points_min_dist_blob)
        real_planar, real_gates, real_hist = self.real

        def hist(z, mask, *args):
            out = real_hist(z, mask, *args)
            if "seg" not in self.rec:
                self.rec["neighbors"] = mask.sum(-1).cpu().numpy()
                self.rec["seg"] = out.seg_mask.sum(-1).cpu().numpy()
                self.rec["bin"] = out.lower.cpu().numpy()
            return out

        def planar(corners, threshold):
            if "planar" not in self.rec:
                c1, c2, c3 = corners[:, 0], corners[:, 1], corners[:, 2]
                e1, e2 = PF._unit(c2 - c1), PF._unit(c3 - c1)
                e3 = PF._unit(c3 - c2)
                score = torch.stack([PF.norm3(PF.cross3(a, b)) for a, b in
                                     ((e1, e2), (e1, e3), (e2, e3))]).amin(0)
                self.rec["planar"] = (score - threshold).cpu().numpy()
                self.rec["corners"] = corners.cpu().numpy()
            return real_planar(corners, threshold)

        def gates(cfg, depth, neighbor_depths, seg_mask):
            if "local" not in self.rec:
                inf = float("inf")
                lo = torch.where(seg_mask, neighbor_depths, inf).amin(-1)
                hi = torch.where(seg_mask, neighbor_depths, -inf).amax(-1)
                tol = ((hi - lo) * cfg.treshold_depth_local_value
                       if cfg.treshold_depth_local_valuetype == 1
                       else cfg.treshold_depth_local_value)
                self.rec["local"] = torch.minimum(
                    depth - (lo - tol), hi + tol - depth).cpu().numpy()
            return real_gates(cfg, depth, neighbor_depths, seg_mask)

        (DE.check_planar, DE._apply_depth_gates,
         DE.filter_points_min_dist_blob) = planar, gates, hist
        return self

    def __exit__(self, *exc):
        (self.module.check_planar, self.module._apply_depth_gates,
         self.module.filter_points_min_dist_blob) = self.real

    def of_new_frame(self, n: int) -> dict:
        """The new frame's lanes: the last n of the pair's joined lanes."""
        return {k: v[-n:] for k, v in self.rec.items()}


def _sync_places(caught) -> list:
    return [f"{w.filename.rsplit('/', 2)[-2]}/"
            f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message)]


def _plane_angle_offset(a, b) -> tuple[float, float]:
    """Angle (degrees) between two planes' unit normals and the difference
    of their offsets (metres)."""
    cos = float(np.clip(abs(np.dot(a[:3], b[:3])), -1.0, 1.0))
    return math.degrees(math.acos(cos)), abs(abs(float(a[3]))
                                             - abs(float(b[3])))


def phase_sequence(card: str, seq) -> dict:
    """The chunked sequence evaluators, the semantic ground plane and region
    growing at the full size, on the frames phase 6 rendered."""
    import os
    import tempfile
    import warnings

    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core import neighbors, windows
    from mono_lidar_depth_tpu_torch.core import row_segmentation as rowseg
    from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
    from mono_lidar_depth_tpu_torch.core.result_types import (
        DepthResultType as R)
    from mono_lidar_depth_tpu_torch.eval import kitti_eval
    from mono_lidar_depth_tpu_torch.io import native
    from mono_lidar_depth_tpu_torch.io.kitti import KittiSequence, pad_cloud
    from mono_lidar_depth_tpu_torch.io.synthetic_dataset import VelodyneOrder
    from mono_lidar_depth_tpu_torch.tracker import klt
    from mono_lidar_depth_tpu_torch.tracks.pipeline import (
        _frame_ground_plane, _ground_plane)

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = T.DepthEstimatorConfig()
    cfg_rg = T.DepthEstimatorConfig(do_use_depth_segmentation=True)
    ocfg = T.OdometryConfig()
    N = cfg.max_features
    cam, l2c = seq.camera, seq.lidar_to_cam(dev)
    steps = len(seq) - 1
    vseq = VelodyneOrder(seq)
    kw = dict(max_tracks=N, max_length=12, verbose=False, device=dev,
              seed=SEED)
    kernel_names = ("lk_track", "zncc_gate", "slice_windows",
                    "gather_neighbors")

    def launched():
        return (klt.launches, klt.gate_launches, windows.launches,
                neighbors.launches)

    def timed(fn):
        """(result, CUDA-event ms, launches of `kernel_names`) of fn()."""
        before = launched()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return (out, start.elapsed_time(stop),
                tuple(b - a for a, b in zip(before, launched())))

    # ---- main paths, with the launch counts set to 0 just before and
    # read just after: the sequence entry points
    old_chunk = kitti_eval._CHUNK_FRAMES
    kitti_eval._CHUNK_FRAMES = SEQ_CHUNK  # a first, a full and a tail chunk
    klt.launches = klt.gate_launches = 0
    windows.launches = neighbors.launches = 0
    torch.cuda.reset_peak_memory_stats()
    depth = {}
    for name, s_, c_, mode in (("ransac", seq, cfg, "ransac"),
                               ("semantic", seq, cfg, "semantic"),
                               ("region growing, ransac", vseq, cfg_rg,
                                "ransac"),
                               ("region growing, semantic", vseq, cfg_rg,
                                "semantic")):
        per_frame = 2 if c_.do_use_depth_segmentation else 1
        out, ms, counts = timed(lambda: T.eval_depth_sequence(
            s_, c_, plane_mode=mode, **kw))
        check(counts == (steps, steps, 0, per_frame * steps),
              f"eval_depth_sequence ({name}) launched {counts} "
              f"{kernel_names} in {steps} frames, want 1 + 1 + 0 "
              f"+ {per_frame} per frame")
        check(out["frames"] == steps and sum(out["counters"]) == out[
            "total_points"] > 0, f"eval_depth_sequence ({name}): {out}")
        depth[name] = out
        rg = out["counters"][int(R.SuccessRegionGrowing)]
        log(f"phase 7 sequence: eval_depth_sequence {name}, {steps} frames "
            f"in chunks of {SEQ_CHUNK}: {ms / steps:.3f} ms per frame (CUDA "
            f"events, upload and tracker included), {per_frame} "
            f"gather_neighbors launch(es) per frame"
            f"{' with the index plane' if per_frame == 2 else ''}, success "
            f"share {out['success_rate_all']:.4f} (lidar-covered "
            f"{out['success_rate_lidar_covered']:.4f}), "
            f"SuccessRegionGrowing {rg} "
            f"({rg / max(out['total_points'], 1):.4f}), counters "
            f"{out['counters']} [{card}]")
        check((rg > 0) == (per_frame == 2),
              f"{name}: {rg} SuccessRegionGrowing outcomes")
    dev_time = T.measure_depth_device_time(seq, cfg, max_tracks=N,
                                           max_length=12, device=dev,
                                           seed=SEED)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"phase 7 sequence: measure_depth_device_time (chunks staged first, "
        f"one warm run, CUDA events): {dev_time['device_ms_per_frame']:.3f} "
        f"ms per frame over {dev_time['frames']} frames; peak device memory "
        f"so far {peak_mb:.1f} MB [{card}]")

    vo4, ms4, c4 = timed(lambda: T.eval_vo_sequence(seq, cfg, ocfg, **kw))
    kitti_eval._CHUNK_FRAMES = 256
    vo256, ms256, c256 = timed(lambda: T.eval_vo_sequence(seq, cfg, ocfg,
                                                          **kw))
    kitti_eval._CHUNK_FRAMES = SEQ_CHUNK
    want = (steps, steps, 0, steps)
    check(c4 == want and c256 == want,
          f"eval_vo_sequence launched {c4} and {c256}, want {want}")
    check(np.array_equal(vo4["poses"], vo256["poses"])
          and np.array_equal(vo4["diag"], vo256["diag"]),
          f"eval_vo_sequence in chunks of {SEQ_CHUNK} and of 256: poses "
          f"differ by {np.abs(vo4['poses'] - vo256['poses']).max():.3e}")
    part1, _, _ = timed(lambda: T.eval_vo_sequence(
        seq, cfg, ocfg, max_frames=RESUME_AT, return_carry=True, **kw))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "carry.npz")
        t0 = time.perf_counter()
        T.save_checkpoint(path, part1["carry"], {"next_frame": RESUME_AT})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        fresh = (T.init_tracker(torch.zeros((cam.height, cam.width),
                                            device=dev), N, levels=LEVELS),
                 T.OdometryState.create(cfg, ocfg, N, 12, dev))
        t0 = time.perf_counter()
        carry, meta = T.load_checkpoint(path, fresh)
        load_s = time.perf_counter() - t0
    check(meta == {"next_frame": RESUME_AT}, f"checkpoint metadata {meta}")
    check(all(x.is_cuda for x in tensors_of(carry)),
          "a restored leaf is not on the card")
    part2, _, _ = timed(lambda: T.eval_vo_sequence(
        seq, cfg, ocfg, start_frame=RESUME_AT, init_carry=carry, **kw))
    stitched = np.concatenate([part1["poses"], part2["poses"]])
    check(part1["frame_ids"] + part2["frame_ids"] == vo4["frame_ids"]
          and np.array_equal(stitched, vo4["poses"]),
          f"resumed at frame {RESUME_AT}: stitched poses differ from the "
          f"uninterrupted run's")
    main_counts = dict(zip(kernel_names, launched()))
    kitti_eval._CHUNK_FRAMES = old_chunk
    log(f"phase 7 sequence: eval_vo_sequence over {steps} frames in chunks "
        f"of {SEQ_CHUNK} ({ms4 / steps:.3f} ms per frame) and of 256 "
        f"({ms256 / steps:.3f} ms per frame): poses and diagnostics "
        f"bit-identical, ATE {vo4['ate_rmse']:.4f} m, RPE trans "
        f"{vo4['rpe_trans_rmse']:.4f} m; stopped after frame "
        f"{RESUME_AT - 1}, carry saved ({size} bytes, {save_s * 1e3:.1f} ms), "
        f"loaded ({load_s * 1e3:.1f} ms) and resumed at frame {RESUME_AT}: "
        f"stitched poses bit-identical; launches of this phase's main paths "
        f"{main_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB [{card}]")

    # ---- comparisons from here on (their launches are not counted)
    def frame_loop(s_, c_, with_sem):
        """`frame_inputs` + `process_frame`: (counters, inputs)."""
        state = T.TrackletDepthState.create(c_, N, 12, dev)
        prime: list = []
        inputs = []
        for frame, f in T.frame_inputs(s_, c_, prime=prime,
                                       pyramid_levels=LEVELS,
                                       use_semantics=with_sem, device=dev,
                                       seed=SEED):
            if f == 1:
                state = T.prime_state(
                    c_, cam, l2c, state, prime[0][0], prime[0][1],
                    kitti_eval._frame_rng(kitti_eval._frame_seed(SEED, 0),
                                          dev), semantic=prime[0][2])
            state, _, _ = T.process_frame(c_, cam, l2c, state, frame)
            inputs.append(frame)
        return state.counters.cpu().numpy().tolist(), inputs, prime

    loops = {}
    for name, s_, c_, with_sem in (
            ("ransac", seq, cfg, False), ("semantic", seq, cfg, True),
            ("region growing, ransac", vseq, cfg_rg, False),
            ("region growing, semantic", vseq, cfg_rg, True)):
        counters, inputs, prime = frame_loop(s_, c_, with_sem)
        check(counters == depth[name]["counters"],
              f"eval_depth_sequence ({name}) counters "
              f"{depth[name]['counters']} != the frame loop's {counters}")
        loops[name] = (inputs, prime)
    log("phase 7 sequence: the counters of all four eval_depth_sequence "
        "runs equal the per-frame loop's (frame_inputs + process_frame) "
        "exactly")

    # the plane itself, at a refinement threshold of 0.3 m (at the default
    # 10.2 m the semantic refit spans the whole scene, walls included)
    cfg03 = T.DepthEstimatorConfig(ransac_plane_refinement_treshold=0.3)
    cloud0, valid0, sem0 = loops["semantic"][1][0]
    gp_sem = _frame_ground_plane(cfg03, cam, l2c, cloud0, valid0, None, sem0)
    gp_ran = _ground_plane(cfg03, cloud0, valid0,
                           torch.Generator(device=dev).manual_seed(SEED))
    c_sem, c_ran = gp_sem.coeffs.cpu().numpy(), gp_ran.coeffs.cpu().numpy()
    angle, offset = _plane_angle_offset(c_sem, c_ran)
    inliers = int(gp_sem.inlier_mask.sum())
    log(f"phase 7 sequence: frame 0's semantic plane at 0.3 m: coeffs "
        f"{[round(float(x), 4) for x in c_sem]} (lidar frame), {inliers} "
        f"inliers; RANSAC plane of the same cloud "
        f"{[round(float(x), 4) for x in c_ran]}: {angle:.3f} deg and "
        f"{offset:.4f} m apart")
    check(bool(gp_sem.ok) and abs(c_sem[2]) > 0.99 and inliers > 100,
          f"semantic plane {c_sem} with {inliers} inliers")
    check(angle < 2.0 and offset < 0.1,
          f"semantic and RANSAC planes {angle:.3f} deg, {offset:.4f} m apart")

    # the index plane at the region-growing path's own shapes, bit for bit
    rg_inputs, _ = loops["region growing, ransac"]
    last = rg_inputs[-1]
    gp = _ground_plane(cfg_rg, last.cloud, last.cloud_valid,
                       torch.Generator(device=dev).manual_seed(SEED))
    frame_cloud = T.rasterize_cloud(cfg_rg, cam, l2c, last.cloud,
                                    last.cloud_valid, gp)
    hx, hy = (cfg.pixelarea_search_witdh * 0.5,
              cfg.pixelarea_search_height * 0.5)
    scales = [(hx, hy, cfg.primary_window),
              (hx * cfg.road_search_scale_x, hy * cfg.road_search_scale_y,
               cfg.road_window)]
    stacks = neighbors.frame_stacks([frame_cloud], True)
    uv = last.uv_new.contiguous()
    got = neighbors.gather_stacks_cuda(stacks, [uv], cam, scales, True)
    want_nb = neighbors.gather_stacks_reference(stacks, [uv], cam, scales,
                                                True)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want_nb)):
        for field in neighbors.NeighborSet._fields:
            check(torch.equal(getattr(g, field), getattr(w, field)),
                  f"region-growing gather, scale {k}: {field} differs from "
                  f"the plain version")
    hits = int((got[0].indices >= 0).sum())
    check(got[0].indices.dtype == torch.int32 and hits > 1000,
          f"index plane: {hits} neighbors")
    # argmin over all-inf rows takes the first entry on the card as on the
    # CPU (grow_regions' adjacent-row search relies on it)
    inf_rows = torch.full((64, 32), float("inf"), device=dev)
    inf_rows[::2, 7] = 1.0
    inf_rows[::2, 19] = 1.0
    check(torch.equal(torch.argmin(inf_rows, dim=1).cpu(),
                      torch.argmin(inf_rows.cpu(), dim=1)),
          "argmin ties resolve differently on the card")
    log(f"phase 7 sequence: the gather at the region-growing path's shapes "
        f"(1 frame, {N} features, {tuple(stacks[0].shape)} stack, windows "
        f"{scales[0][2]} + {scales[1][2]}, with_indices): every field equal "
        f"to the plain version bit for bit, {hits} indexed neighbors in the "
        f"primary window")

    # ---- region growing on: one host sync per odometry step, none inside
    # the new functions; 2 gather launches per step, 1 per
    # estimate_depths_from_frame
    state = T.OdometryState.create(cfg_rg, ocfg, N, 12, dev)
    _, prime = loops["region growing, ransac"]
    state = state._replace(tracklets=T.prime_state(
        cfg_rg, cam, l2c, state.tracklets, prime[0][0], prime[0][1],
        torch.Generator(device=dev).manual_seed(SEED)))
    per_step = []
    for frame in rg_inputs:
        before = neighbors.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state, R_cw, t_cw, diag = T.odometry_step(
                    cfg_rg, ocfg, cam, l2c, state, frame)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        places = _sync_places(caught)
        check(len(places) == 1 and places[0].startswith("vo/pipeline.py:"),
              f"an odometry step with region growing synchronized at "
              f"{places}; want exactly one place, in vo/pipeline.py")
        per_step.append(neighbors.launches - before)
        check(bool(torch.isfinite(R_cw).all() & torch.isfinite(t_cw).all()),
              "region growing: non-finite pose")
    check(per_step == [2] * steps,
          f"gather_neighbors launches per odometry step with region "
          f"growing: {per_step}, want 2 each")
    before = neighbors.launches
    K = cam.intrinsics(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rows = rowseg.segment_rows(frame_cloud, cfg_rg.max_scan_rows)
            seeds = torch.gather(got[0].indices, 1, torch.argmin(torch.where(
                got[0].mask, got[0].z, float("inf")), dim=1)[:, None])[:, 0]
            grown = rowseg.grow_regions(rows, seeds, got[0].mask.any(1), uv)
            T.fit_ground_plane_semantic(
                cloud0, valid0, sem0, l2c.rotation, l2c.translation, K)
            est = T.estimate_depths_from_frame(cfg_rg, cam, l2c, frame_cloud,
                                               uv, last.ids_valid, gp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    places = _sync_places(caught)
    check(not places, f"segment_rows, grow_regions, "
                      f"fit_ground_plane_semantic or the estimator "
                      f"synchronized with the host at {places}")
    check(neighbors.launches - before == 1,
          f"estimate_depths_from_frame with region growing launched "
          f"{neighbors.launches - before} gathers, want 1")
    n_rows = int(rows.num_rows)
    status = grown.status.cpu().numpy()
    rg_lanes = int((est.codes == int(R.SuccessRegionGrowing)).sum())
    check(n_rows >= 16 and (status == 1).sum() > 0 and rg_lanes > 0,
          f"{n_rows} scan rows, {(status == 1).sum()} grown regions, "
          f"{rg_lanes} SuccessRegionGrowing lanes")
    log(f"phase 7 sequence: region growing on, {steps} full-size odometry "
        f"steps: one host sync per step (vo/pipeline.py), none inside segment_rows, grow_regions, "
        f"fit_ground_plane_semantic or estimate_depths_from_frame; 2 "
        f"gather_neighbors launches per odometry_step and per "
        f"process_frame, 1 per estimate_depths_from_frame; the last scan "
        f"has {n_rows} rows, grow status counts "
        f"{dict(zip(*map(list, np.unique(status, return_counts=True))))}, "
        f"{rg_lanes} SuccessRegionGrowing lanes of {N}")

    # ---- card against the CPU's plain versions, frame by frame, on the
    # region-growing and the semantic configuration (same tracker outputs,
    # same numpy RANSAC draws)
    rng = np.random.default_rng(SEED + 13)
    l2c_cpu = seq.lidar_to_cam(cpu)
    # The lidar grid is regular and the surfaces are planes, so the spans
    # that `max_spanning_triangle` compares come close to ties.  It ranks
    # them in float64 and the fits sum in an order their terms fix, so
    # the card picks the CPU's triangles and planes: every code equal
    # (measured: 16,384 of 16,384 in both configurations; before the
    # float64 rule 7 and 15 lanes differed); the differing pairs are
    # printed.
    for name, key, c_, with_sem, code_bar in (
            ("region growing", "region growing, ransac", cfg_rg, False,
             1.0),
            ("semantic", "semantic", cfg, True, 1.0)):
        inputs, prime = loops[key]
        draws = [_numpy_draws(rng, c_, int(prime[0][1].sum()))] + [
            _numpy_draws(rng, c_, int(f.cloud_valid.sum())) for f in inputs]

        def run(d, l2c_d):
            def on(x):
                return None if x is None else x.to(d)

            def rd(k):
                return RansacDraws(*(torch.from_numpy(a).to(d)
                                     for a in draws[k]))

            state = T.OdometryState.create(c_, ocfg, N, 12, d)
            state = state._replace(tracklets=T.prime_state(
                c_, cam, l2c_d, state.tracklets, on(prime[0][0]),
                on(prime[0][1]), rd(0), semantic=on(prime[0][2])))
            poses, codes, depths, margins = [], [], [], []
            for k, f in enumerate(inputs, 1):
                frame = T.FrameInput(*(on(x) for x in f[:7]), rng=rd(k),
                                     semantic=on(f.semantic))
                with _GateMargins() as gates:
                    _, dep, cod = T.process_frame(c_, cam, l2c_d,
                                                  state.tracklets, frame)
                margins.append(gates.of_new_frame(N))
                state, R_cw, t_cw, _ = T.odometry_step(c_, ocfg, cam, l2c_d,
                                                       state, frame)
                poses.append((R_cw.cpu().numpy(), t_cw.cpu().numpy()))
                codes.append(cod.cpu().numpy())
                depths.append(dep.cpu().numpy())
            return (poses, np.concatenate(codes), np.concatenate(depths),
                    {key: np.concatenate([m[key] for m in margins])
                     for key in margins[0]})

        t0 = time.perf_counter()
        g_poses, g_codes, g_depths, g_margin = run(dev, l2c)
        c_poses, c_codes, c_depths, c_margin = run(cpu, l2c_cpu)
        agree = float(np.mean(g_codes == c_codes))
        both = (g_codes == c_codes) & (c_depths > 0)
        rel_all = np.abs(g_depths - c_depths) / np.maximum(c_depths, 1e-30)
        # Depths are held by share, per success code.  A region is grown
        # by comparing f32 distances with caps, so a lane exactly at a cap
        # whose points the card rounds otherwise would grow another point
        # set: same code, another plane through four points a few
        # centimetres apart (measured before the float64 rule: 5 of 4,197
        # lanes beyond 5e-3; with it, every depth within 2.4e-7).
        by_code = {}
        for code in (R.Success, R.SuccessRegionGrowing, R.SuccessRoad):
            lanes = both & (c_codes == int(code))
            r = rel_all[lanes]
            by_code[code.name] = (
                int(lanes.sum()),
                float((r <= 5e-3).mean()) if len(r) else 1.0,
                float(r.max()) if len(r) else 0.0,
                float(np.median(r)) if len(r) else 0.0)
        dR = max(float(np.abs(a[0] - b[0]).max())
                 for a, b in zip(g_poses, c_poses))
        dt = max(float(np.abs(a[1] - b[1]).max())
                 for a, b in zip(g_poses, c_poses))
        rg = int((g_codes == int(R.SuccessRegionGrowing)).sum())
        shown = {k: (v[0], round(v[1], 5), float(f"{v[2]:.2e}"),
                     float(f"{v[3]:.1e}")) for k, v in by_code.items()}
        differ = g_codes != c_codes
        pairs, pair_counts = np.unique(
            np.stack([g_codes[differ], c_codes[differ]], 1), axis=0,
            return_counts=True)
        confusion = {f"{R(int(a)).name}/{R(int(b)).name}": int(n)
                     for (a, b), n in zip(pairs, pair_counts)}
        lanes = [
            f"{i // N}:{i % N} {R(int(g_codes[i])).name}/"
            f"{R(int(c_codes[i])).name} neighbors "
            f"{g_margin['neighbors'][i]}/{c_margin['neighbors'][i]} segment "
            f"{g_margin['seg'][i]}/{c_margin['seg'][i]} from "
            f"{g_margin['bin'][i]:.2f}/{c_margin['bin'][i]:.2f} m "
            f"planar {g_margin['planar'][i]:+.2e}/"
            f"{c_margin['planar'][i]:+.2e} local "
            f"{g_margin['local'][i]:+.2e}/{c_margin['local'][i]:+.2e} m "
            f"corners {np.abs(g_margin['corners'][i] - c_margin['corners'][i]).max():.1e} m "
            f"spans {_span_gap(g_margin['corners'][i], c_margin['corners'][i])}"
            for i in np.flatnonzero(differ)]
        log(f"phase 7 sequence: {name}, each differing lane (frame:lane "
            f"card/CPU code; card/CPU the primary path's window neighbors, "
            f"histogram segment points and its lower bin border; card/CPU "
            f"margins to the primary path's "
            f"gates: planarity score minus its threshold, the depth's "
            f"distance inside the local interval; how far apart the two "
            f"devices' triangles are, and the relative gaps between the "
            f"two triangles' spans, the two numbers max_spanning_triangle "
            f"maximizes: the squared longest side, then the third corner's "
            f"sum of squared legs): {' | '.join(lanes)} [{card}]")
        log(f"phase 7 sequence: card vs CPU plain versions, {name}, {steps} "
            f"frames ({time.perf_counter() - t0:.1f} s): codes agree "
            f"{agree:.5f} ({int(differ.sum())} of {differ.size} differ, "
            f"card/CPU: {confusion}); depths on agreeing successes, per "
            f"code (lanes, "
            f"share within 5e-3 relative, max, median): "
            f"{shown}; "
            f"{rg} SuccessRegionGrowing lanes on the card; poses max |dR| "
            f"{dR:.2e}, max |dt| {dt:.2e} m [{card}]")
        check(agree >= code_bar,
              f"{name}: card/CPU codes agree {agree:.5f} < {code_bar}")
        check(by_code["Success"][1] >= 0.999
              and by_code["SuccessRegionGrowing"][1] >= 0.99
              and by_code["SuccessRoad"][1] >= 0.98,
              f"{name}: card/CPU depths within 5e-3 on too few lanes: "
              f"{by_code}")
        check(dR <= 1e-3 and dt <= 5e-3,
              f"{name}: card/CPU poses differ: |dR| {dR:.2e}, |dt| {dt:.2e}")
        check((rg > 0) == (name == "region growing"),
              f"{name}: {rg} SuccessRegionGrowing lanes")

    # ---- the loader, without image files: scans, calibration, stamps and
    # poses written with numpy, read back through KittiSequence
    with tempfile.TemporaryDirectory() as tmp:
        seq_dir = os.path.join(tmp, "sequences", "07")
        os.makedirs(os.path.join(seq_dir, "velodyne"))
        os.makedirs(os.path.join(tmp, "poses"))
        for k, scan in enumerate(seq.raw_scans):
            scan.tofile(os.path.join(seq_dir, "velodyne", f"{k:06d}.bin"))
        np.savetxt(os.path.join(seq_dir, "times.txt"), seq.times, fmt="%.6f")
        np.savetxt(os.path.join(tmp, "poses", "07.txt"),
                   seq.gt_poses[:, :3, :].reshape(len(seq), 12), fmt="%.9e")
        with open(os.path.join(seq_dir, "calib.txt"), "w") as fh:
            for key in ("P0", "P1", "P2", "P3"):
                fh.write(f"{key}: " + " ".join(
                    f"{x:.12e}" for x in seq.P0.ravel()) + "\n")
            fh.write("Tr: " + " ".join(f"{x:.12e}" for x in seq.Tr.ravel())
                     + "\n")
        disk = KittiSequence(tmp, "07")
        reader = "native" if native.native_available() else "numpy"
        check(len(disk) == len(seq), f"loader: {len(disk)} scans")
        for (a, na), (b, nb) in zip(disk.scans(cfg.max_points),
                                    seq.scans(cfg.max_points)):
            check(na == nb and np.array_equal(a, b), "loader: a scan differs")
        check(tuple(disk.camera) == tuple(seq.camera),
              f"loader: camera {disk.camera}")
        got_l2c = disk.lidar_to_cam(dev)
        check(got_l2c.rotation.is_cuda
              and torch.equal(got_l2c.rotation, l2c.rotation)
              and torch.equal(got_l2c.translation, l2c.translation),
              "loader: lidar_to_cam differs")
        check(np.abs(disk.times - seq.times).max() <= 1e-6
              and np.abs(disk.gt_poses - seq.gt_poses).max() <= 1e-6,
              "loader: stamps or poses differ")
        check(disk.image(0) is None and disk.semantic(0) is None,
              "loader: an image where no file is")
    log(f"phase 7 sequence: KittiSequence on {len(seq)} scans written with "
        f"numpy ({reader} scan reader): length, scans, camera, lidar_to_cam "
        f"on the card, stamps and poses equal the in-memory sequence's")
    return main_counts


# --------------------------------------------------------------- phase 8

def _drift(poses, yaw_deg: float = 1.5, scale: float = 1.12):
    """tests/test_kitti_synthetic.py's drift: the relative motions of a
    trajectory recomposed with a constant yaw bias and scale error per
    frame."""
    yaw = math.radians(yaw_deg)
    dR = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                   [-math.sin(yaw), 0, math.cos(yaw)]])
    out = [poses[0]]
    for k in range(len(poses) - 1):
        rel = np.linalg.inv(poses[k]) @ poses[k + 1]
        rel[:3, :3] = rel[:3, :3] @ dR
        rel[:3, 3] *= scale
        out.append(out[-1] @ rel)
    return np.stack(out)


def _angle(Ra, Rb) -> float:
    """Largest rotation angle (rad) between two stacks of rotations, from
    the skew part of Ra^T Rb."""
    E = (np.asarray(Ra, np.float64).swapaxes(-1, -2)
         @ np.asarray(Rb, np.float64))
    return float((np.linalg.norm(E - E.swapaxes(-1, -2), axis=(-2, -1))
                  / (2 * math.sqrt(2))).max())


def kitti00_graph(device, seed: int = SEED):
    """The KITTI-00-scale pose graph of __graft_entry__.py (4541 poses on a
    straight chain, 20 closures of span 301, positions perturbed by 0.05
    m, pose 0 fixed), built with numpy from `seed`."""
    import __graft_entry_torch__ as G

    return G.kitti00_graph(np.random.default_rng(seed), device,
                           KITTI00_POSES)


def phase_posegraph(card: str) -> dict:
    """Config 4 at the KITTI size: VO over a rendered loop, closure
    proposal, verification (the three kernels again, one device call per
    direction) and the pose-graph backend, without and with injected
    drift; then the pose graph alone at KITTI-00 scale."""
    import warnings

    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core import neighbors, windows
    from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
    from mono_lidar_depth_tpu_torch.eval import kitti_eval
    from mono_lidar_depth_tpu_torch.tracker import klt
    from mono_lidar_depth_tpu_torch.vo import closures
    from mono_lidar_depth_tpu_torch.vo import pose_graph as pg
    from mono_lidar_depth_tpu_torch.vo.metrics import ate_rmse

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg, ocfg = T.DepthEstimatorConfig(), T.OdometryConfig()
    N = cfg.max_features
    kernel_names = ("lk_track", "zncc_gate", "slice_windows",
                    "gather_neighbors")
    per_direction = (1, 1, 0, 1)

    def launched():
        return (klt.launches, klt.gate_launches, windows.launches,
                neighbors.launches)

    t0 = time.perf_counter()
    seq = T.render_sequence(T.SyntheticSpec(frames=LOOP_FRAMES, step=0.55,
                                            loop=True), seed=SEED)
    render_s = time.perf_counter() - t0

    # Every verification direction's device call, as the main path makes
    # it: CUDA-event ms, kernel launches, host syncs inside.
    directions = []
    real_device = closures._closure_pose_device

    def recorded(*args, **kwargs):
        before = launched()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                start.record()
                out = real_device(*args, **kwargs)
                stop.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        directions.append((start.elapsed_time(stop),
                           tuple(b - a for a, b in zip(before, launched())),
                           _sync_places(caught)))
        return out

    solves = []  # closure edges of every solve of the backend
    real_opt = closures.optimize_pose_graph

    def counted(g, **kw):
        solves.append(g.edge_i.shape[0] - (g.R.shape[0] - 1))
        return real_opt(g, **kw)

    # ---- main path, counts from 0: VO, then both legs
    klt.launches = klt.gate_launches = 0
    windows.launches = neighbors.launches = 0
    closures._closure_pose_device = recorded
    closures.optimize_pose_graph = counted
    legs = {}
    try:
        t0 = time.perf_counter()
        vo = T.eval_vo_sequence(seq, cfg, ocfg, max_tracks=N, max_length=12,
                                verbose=False, device=dev, seed=SEED)
        vo_s = time.perf_counter() - t0
        vo_counts = launched()
        poses, ids = vo["poses"], vo["frame_ids"]
        gt = seq.gt_poses[ids]

        measured = {}

        def verify(a, b):  # each pair once: the legs share candidates
            if (a, b) not in measured:
                measured[a, b] = kitti_eval.closure_constraint_from_frames(
                    seq, cfg, ids[a], ids[b], max_features=N, device=dev)
            return measured[a, b]

        appearance = T.eval.propose_loop_closures_appearance(
            seq, ids, min_gap=LOOP_PROPOSE["min_gap"],
            stride=LOOP_PROPOSE["stride"],
            max_candidates=LOOP_PROPOSE["max_candidates"])
        for leg, traj, propose_kw in (
                ("4", poses, LOOP_PROPOSE),
                ("4b", _drift(poses, *LOOP_DRIFT),
                 dict(LOOP_PROPOSE, min_candidates=6))):
            cands = T.eval.union_closure_candidates(
                T.eval.propose_loop_closures(traj, **propose_kw),
                appearance)
            first = len(directions)
            t0 = time.perf_counter()
            found = []
            for i, j in cands:
                z = verify(i, j)
                if z is not None:
                    found.append((i, j, *z))
            verify_s = time.perf_counter() - t0
            del solves[:]
            t0 = time.perf_counter()
            opt = T.eval.run_pose_graph_backend(traj, found,
                                                remeasure=verify,
                                                device=dev)
            backend_s = time.perf_counter() - t0
            legs[leg] = dict(
                cands=cands, found=found, opt=opt, verify_s=verify_s,
                backend_s=backend_s, solves=list(solves),
                ate_before=ate_rmse(traj[:, :3, 3], gt[:, :3, 3]),
                ate_after=ate_rmse(opt[:, :3, 3], gt[:, :3, 3]),
                directions=len(directions) - first)
    finally:
        closures._closure_pose_device = real_device
        closures.optimize_pose_graph = real_opt
    main_counts = dict(zip(kernel_names, launched()))

    steps = len(ids)
    check(vo_counts == (steps, steps, 0, steps),
          f"eval_vo_sequence over the loop launched {vo_counts} "
          f"{kernel_names}, want {per_direction} per frame")
    for ms, counts, places in directions:
        check(counts == per_direction,
              f"a verification direction launched {counts} {kernel_names}, "
              f"want {per_direction}")
        check(not places, f"_closure_pose_device synchronized with the host "
                          f"at {places}")
    n_dir = len(directions)
    check(main_counts == dict(zip(kernel_names, (
        v + n_dir * d for v, d in zip(vo_counts, per_direction)))),
        f"phase 8 launches {main_counts}")
    dir_ms = [ms for ms, _, _ in directions]
    log(f"phase 8 posegraph: {LOOP_FRAMES} rendered frames of the loop at "
        f"{seq.camera.width}x{seq.camera.height} ({render_s:.1f} s on the "
        f"host), eval_vo_sequence {vo_s * 1e3 / steps:.3f} ms per frame "
        f"(host clock), ATE {vo['ate_rmse']:.4f} m, RPE "
        f"{vo['rpe_trans_rmse']:.4f} m / {vo['rpe_rot_rmse_deg']:.3f} deg "
        f"[{card}]")
    log(f"phase 8 posegraph: {n_dir} verification directions: "
        f"{per_direction} {kernel_names} launches and 0 host syncs inside "
        f"_closure_pose_device each; device call {np.median(dir_ms):.3f} ms "
        f"median (CUDA events; min {min(dir_ms):.3f}, max {max(dir_ms):.3f}); "
        f"launches of this phase's main paths {main_counts} [{card}]")
    for leg, r in legs.items():
        used = max(r["solves"]) if r["solves"] else 0
        log(f"phase 8 posegraph: leg {leg}: {len(r['cands'])} proposed "
            f"{[tuple(c) for c in r['cands']]}, {len(r['found'])} verified "
            f"{[c[:2] for c in r['found']]} "
            f"({r['verify_s'] * 1e3 / max(len(r['cands']), 1):.1f} ms per "
            f"candidate on the host clock, both directions and the host "
            f"reads, pairs measured for leg 4 taken again), "
            f"{used} used; backend {r['backend_s']:.2f} s, "
            f"{len(r['solves'])} solve(s); ATE {r['ate_before']:.4f} -> "
            f"{r['ate_after']:.4f} m [{card}]")
        check(len(r["found"]) >= 1, f"leg {leg}: no closure verified")
    check(legs["4"]["ate_after"] < legs["4"]["ate_before"],
          f"leg 4: ATE {legs['4']['ate_before']:.4f} -> "
          f"{legs['4']['ate_after']:.4f} m")
    check(legs["4b"]["ate_after"] < 0.7 * legs["4b"]["ate_before"],
          f"leg 4b: ATE {legs['4b']['ate_before']:.4f} -> "
          f"{legs['4b']['ate_after']:.4f} m, want < 0.7x")

    # ---- card against the CPU's plain versions, on the card's VO poses
    # and the same numpy RANSAC draws in every direction
    rng = np.random.default_rng(SEED + 8)
    draws = {}

    def same_draws(cloud_valid):
        n = int(cloud_valid.sum())
        if n not in draws:
            draws[n] = _numpy_draws(rng, cfg, n)
        return RansacDraws(*(torch.from_numpy(a).to(cloud_valid.device)
                             for a in draws[n]))

    # every direction's pose estimate, on the host, device by device
    estimates = []

    def kept(*args, **kwargs):
        out = real_device(*args, **kwargs)
        estimates.append(closures._to_host(out))
        return out

    real_rng = closures._closure_rng
    closures._closure_rng = same_draws
    closures._closure_pose_device = kept
    rows, diffs = [], []
    try:
        t0 = time.perf_counter()
        # True revisits (ground-truth positions within REVISIT_M): a
        # verification that locks onto another place is unstable by
        # nature, and the consistency filter exists for it; so values are
        # compared on true revisits, decisions on the first rejected
        # candidate too.
        accepted = [c[:2] for c in legs["4"]["found"]
                    if np.linalg.norm(gt[c[0], :3, 3] - gt[c[1], :3, 3])
                    < REVISIT_M]
        rejected = [c for c in legs["4"]["cands"]
                    if c not in [f[:2] for f in legs["4"]["found"]]]
        for i, j in accepted[:CPU_PAIRS] + rejected[:1]:
            got, dirs = [], []
            for d in (dev, cpu):
                del estimates[:]
                got.append(kitti_eval.closure_constraint_from_frames(
                    seq, cfg, ids[i], ids[j], max_features=N, device=d))
                dirs.append(list(estimates))
            revisit = (i, j) in accepted
            per_dir = [(int(a.num_inliers), int(b.num_inliers),
                        _angle(a.rotation, b.rotation),
                        float(np.abs(a.translation - b.translation).max()))
                       for a, b in zip(*dirs)]
            rows.append(f"{i},{j} ({'revisit' if revisit else 'rejected'}; "
                        f"accepted {got[0] is not None}/{got[1] is not None};"
                        f" per direction inliers card/CPU, |dR| rad, |dt| m: "
                        + "; ".join(f"{a}/{b}, {r:.1e}, {t:.1e}"
                                    for a, b, r, t in per_dir) + ")")
            check((got[0] is None) == (got[1] is None),
                  f"pair {i},{j}: accepted on one device only: {rows[-1]}")
            if got[0] is not None and revisit:
                diffs.append((_angle(got[0][0], got[1][0]),
                              float(np.abs(got[0][1] - got[1][1]).max()),
                              float(np.abs(got[0][2] - got[1][2]).max())))
        pairs_s = time.perf_counter() - t0
    finally:
        closures._closure_rng = real_rng
        closures._closure_pose_device = real_device
    t0 = time.perf_counter()
    opt_cpu = T.eval.run_pose_graph_backend(
        poses, legs["4"]["found"], remeasure=lambda a, b: measured[a, b],
        device=cpu)
    backend_cpu_s = time.perf_counter() - t0
    opt = legs["4"]["opt"]
    extent = float(np.ptp(opt[:, :3, 3], axis=0).max())
    d_pos = float(np.abs(opt[:, :3, 3] - opt_cpu[:, :3, 3]).max())
    d_rot = _angle(opt[:, :3, :3], opt_cpu[:, :3, :3])
    worst = tuple(max(d[k] for d in diffs) if diffs else 0.0 for k in range(3))
    log(f"phase 8 posegraph: card vs CPU on the card's VO poses with the "
        f"same numpy RANSAC draws ({pairs_s:.1f} s): {' | '.join(rows)}")
    log(f"phase 8 posegraph: card vs CPU: {len(diffs)} true revisits "
        f"accepted on both: Z_R {worst[0]:.2e} rad, Z_t {worst[1]:.2e} "
        f"m, w6 {worst[2]:.2e} at most; backend ({backend_cpu_s:.1f} s on "
        f"the CPU): positions {d_pos:.3e} m of a {extent:.1f} m extent, "
        f"rotations {d_rot:.2e} rad [{card}]")
    check(worst[0] <= CLOSURE_TOL[0] and worst[1] <= CLOSURE_TOL[1]
          and worst[2] <= CLOSURE_TOL[2],
          f"card/CPU closures differ: {worst}, bars {CLOSURE_TOL}")
    check(d_pos <= BACKEND_TOL[0] * extent and d_rot <= BACKEND_TOL[1],
          f"card/CPU backend: {d_pos:.3e} m, {d_rot:.2e} rad")

    # ---- the pose graph alone at KITTI-00 scale, each piece of a GN
    # iteration timed with CUDA events between synchronizations (those
    # syncs are chip_smoke.py's; the pose graph's own are counted)
    g = kitti00_graph(dev)
    stages = {"linearize": [], "chain_blocks": [], "factorize": [],
              "pcg": []}
    cg_iters = []
    wrapped = {"linearize": "_linearize", "chain_blocks": "_chain_blocks",
               "factorize": "_chain_preconditioner", "pcg": "_pcg"}
    saved = {name: getattr(pg, name) for name in wrapped.values()}

    def timer(label, fn):
        def run(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            res = fn(*args, **kwargs)
            b.record()
            torch.cuda.synchronize()
            stages[label].append(a.elapsed_time(b))
            if label == "pcg":
                cg_iters.append(res[1])
            return res
        return run

    for label, name in wrapped.items():
        setattr(pg, name, timer(label, saved[name]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            out = pg.optimize_pose_graph(g, gn_iters=PG_GN_ITERS,
                                         cg_iters=PG_CG_ITERS)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for name, fn in saved.items():
            setattr(pg, name, fn)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    places = [p for p in _sync_places(caught) if "chip_smoke.py" not in p]
    cg_iters = [int(n) for n in cg_iters]
    sync_bound = math.ceil(PG_CG_ITERS / pg._CG_CHECK)
    per_gn = len(places) / PG_GN_ITERS
    check(all(p.startswith("vo/pose_graph.py:") for p in places),
          f"optimize_pose_graph synchronized at {sorted(set(places))}")
    check(len(places) <= sync_bound * PG_GN_ITERS,
          f"optimize_pose_graph: {len(places)} host syncs in {PG_GN_ITERS} "
          f"GN iterations, want at most {sync_bound} each")
    total_ms = sum(sum(v) for v in stages.values())
    loops = [min(PG_CG_ITERS, max(pg._CG_CHECK, pg._CG_CHECK * math.ceil(
        n / pg._CG_CHECK))) for n in cg_iters]
    g_cpu = kitti00_graph(cpu)
    t0 = time.perf_counter()
    out_cpu = pg.optimize_pose_graph(g_cpu, gn_iters=PG_GN_ITERS,
                                     cg_iters=PG_CG_ITERS)
    cpu_s = time.perf_counter() - t0
    extent = float(np.ptp(g_cpu.t.numpy(), axis=0).max())
    d_pos = float(np.abs(out.t.cpu().numpy() - out_cpu.t.numpy()).max())
    d_rot = _angle(out.R.cpu().numpy(), out_cpu.R.numpy())
    cost0 = float(pg.graph_cost(g))
    cost1 = float(pg.graph_cost(out))
    log(f"phase 8 posegraph: KITTI-00 scale, {KITTI00_POSES} poses, "
        f"{g.edge_i.shape[0]} edges, gn_iters={PG_GN_ITERS}, "
        f"cg_iters={PG_CG_ITERS}: {total_ms / PG_GN_ITERS:.1f} ms per GN "
        f"iteration (the stages' CUDA events; {wall_s:.2f} s on the host "
        f"clock), "
        f"{per_gn:g} host syncs per GN iteration (bound {sync_bound}), peak "
        f"device memory {peak_mb:.1f} MB, cost {cost0:.4g} -> {cost1:.4g} "
        f"[{card}]")
    log(f"phase 8 posegraph: per GN iteration (ms): linearize "
        f"{[round(x, 2) for x in stages['linearize']]}, chain blocks "
        f"{[round(x, 2) for x in stages['chain_blocks']]}, factorization "
        f"scan {[round(x, 1) for x in stages['factorize']]}, PCG "
        f"{[round(x, 1) for x in stages['pcg']]} over {cg_iters} iterations "
        f"to the 1e-4 exit ({loops} run, "
        f"{[round(m / k, 3) for m, k in zip(stages['pcg'], loops)]} ms per "
        f"iteration) [{card}]")
    log(f"phase 8 posegraph: KITTI-00 scale card vs CPU ({cpu_s:.1f} s on "
        f"the CPU): positions {d_pos:.3e} m of a {extent:.1f} m extent, "
        f"rotations {d_rot:.2e} rad [{card}]")
    check(np.isfinite(out.t.cpu().numpy()).all() and cost1 < cost0,
          f"KITTI-00 scale solve: cost {cost0} -> {cost1}")
    check(d_pos <= KITTI00_TOL[0] * extent and d_rot <= KITTI00_TOL[1],
          f"KITTI-00 scale card/CPU: {d_pos:.3e} m, {d_rot:.2e} rad")
    return main_counts


# --------------------------------------------------------------- phase 9

def dist_rank(rank: int, n: int, device, single: bool) -> dict:
    """One rank of phase 9, spawned by `dist.launch.run_ranks`: the three
    sharded programs on the same inputs in every world (the frames, BA
    problem and graph of __graft_entry_torch__ from SEED), each timed with
    its all_reduce calls and host syncs.  In a world of one (`single`) the
    BA and the pose graph also run with group=None, and everything runs in
    deterministic mode (the pose graph's `index_add_` otherwise sums in
    another order on every run), so the two forms can be held to the bit.
    Returns numpy arrays and numbers."""
    import os
    import warnings

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as tdist
    import __graft_entry_torch__ as G
    from mono_lidar_depth_tpu_torch.core import neighbors
    from mono_lidar_depth_tpu_torch.dist import (
        distributed_ba, distributed_pose_graph, make_mesh,
        sharded_depth_association)
    from mono_lidar_depth_tpu_torch.dist.sharded import _landmark_block
    from mono_lidar_depth_tpu_torch.vo import pose_graph as pg
    from mono_lidar_depth_tpu_torch.vo.ba import ba_iteration, run_ba

    if single:
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = G._kitti_cfg()
    cam, l2c = G._calib(cfg, device)
    rng = np.random.default_rng(SEED)
    frames = G._frame_arrays(cfg, rng, DIST_RANKS, device)
    problem = G.ba_problem(cam, 1024 * DIST_RANKS, rng, device)
    graph = G.kitti00_graph(rng, device, KITTI00_POSES)
    mesh = make_mesh(n, device=device)
    mesh_lm = make_mesh(n, landmark_parallel=n, device=device)

    calls = [0]
    real_all_reduce = tdist.all_reduce

    def counting(*args, **kwargs):
        calls[0] += 1
        return real_all_reduce(*args, **kwargs)

    def measured(fn, per: int):
        """(fn(), host ms per unit to the end of the device work,
        all_reduce calls per unit, host syncs per unit)."""
        torch.cuda.synchronize()
        calls[0] = 0
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return res, ms / per, calls[0] / per, len(_sync_places(caught)) / per

    def host(x):
        return x.cpu().numpy()

    out = dict(backend=tdist.get_backend())
    tdist.all_reduce = counting
    counts = []
    real_pcg = pg._pcg

    def counted_pcg(*args, **kwargs):
        x, iterations = real_pcg(*args, **kwargs)
        counts.append(iterations)
        return x, iterations

    pg._pcg = counted_pcg
    try:
        if not single:  # ---- the association, counts from 0
            step = sharded_depth_association(cfg, cam, l2c, mesh)
            draws = G.frame_draws(cfg, frames[1])
            neighbors.launches = 0
            (d, c, cnt), ms, ar, sy = measured(
                lambda: step(*frames, draws), 1)
            out["assoc"] = dict(depths=host(d), codes=host(c),
                                counters=host(cnt), ms=ms, all_reduce=ar,
                                syncs=sy, launches=neighbors.launches)

        # ---- BA: the solve, then DIST_TIMED_ITERS iterations timed
        res = distributed_ba(cam, mesh_lm, iters=DIST_BA_ITERS)(problem)
        out["ba"] = (host(res.problem.R), host(res.problem.t),
                     host(res.problem.landmarks), float(res.initial_cost),
                     float(res.final_cost))
        block = _landmark_block(problem, mesh_lm)

        def iterate(group, pb):
            for _ in range(DIST_TIMED_ITERS):
                pb = ba_iteration(cam, pb, 2.0, 1.0, 0.5, 1e-4, group)
            return pb

        group = mesh_lm.get_group("landmark")
        iterate(group, block)
        out["ba_iter"] = measured(lambda: iterate(group, block),
                                  DIST_TIMED_ITERS)[1:]
        if single:
            one = run_ba(cam, problem, iters=DIST_BA_ITERS)
            out["ba_single"] = (host(one.problem.R), host(one.problem.t),
                                host(one.problem.landmarks),
                                float(one.initial_cost),
                                float(one.final_cost))
            iterate(None, problem)
            out["ba_iter_single"] = measured(lambda: iterate(None, problem),
                                             DIST_TIMED_ITERS)[1:]

        # ---- the pose graph
        solve = distributed_pose_graph(mesh, **DIST_PG)
        del counts[:]
        g, *m = measured(lambda: solve(graph), DIST_PG["gn_iters"])
        out["pg"] = (host(g.R), host(g.t), [int(k) for k in counts], *m)
        out["pg_cost"] = (float(pg.graph_cost(graph)), float(pg.graph_cost(g)))
        # one all_reduce of the matvec's [N, 6] sum alone, 20 in a row
        y, frame_group = graph.t.new_ones((KITTI00_POSES, 6)), mesh.get_group(
            "frame")
        out["ar"] = measured(lambda: [tdist.all_reduce(y, group=frame_group)
                                      for _ in range(20)], 20)[1:]
        if single:
            del counts[:]
            g, *m = measured(lambda: pg.optimize_pose_graph(graph, **DIST_PG),
                             DIST_PG["gn_iters"])
            out["pg_single"] = (host(g.R), host(g.t),
                                [int(k) for k in counts], *m)
    finally:
        tdist.all_reduce = real_all_reduce
        pg._pcg = real_pcg
    return out


def phase_dist(card: str) -> dict:
    """The distributed layer at the dryrun's KITTI shapes: DIST_RANKS gloo
    ranks on the one card against the single-process runs, and a world of
    one NCCL rank equal to group=None to the bit."""
    import torch
    import __graft_entry_torch__ as G
    from mono_lidar_depth_tpu_torch import estimate_depths
    from mono_lidar_depth_tpu_torch.core.ransac import fit_ground_plane_ransac
    from mono_lidar_depth_tpu_torch.dist.launch import run_ranks

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # the single-process association on the card, frame by frame
    cfg = G._kitti_cfg()
    cam, l2c = G._calib(cfg, dev)
    frames = G._frame_arrays(cfg, np.random.default_rng(SEED), DIST_RANKS,
                             dev)
    draws = G.frame_draws(cfg, frames[1])
    codes, depths, counters = [], [], 0
    for b in range(DIST_RANKS):
        gp = fit_ground_plane_ransac(
            frames[0][b], frames[1][b], sub_idx=draws.sub_idx[b],
            picks=draws.picks[b],
            distance_threshold=cfg.ransac_plane_distance_treshold,
            num_hypotheses=cfg.ransac_num_hypotheses,
            subsample=cfg.ransac_subsample_points,
            use_refinement=cfg.ransac_plane_use_refinement,
            refinement_threshold=cfg.ransac_plane_refinement_treshold)
        est = estimate_depths(cfg, cam, l2c, frames[0][b], frames[1][b],
                              frames[2][b], frames[3][b], gp)
        codes.append(est.codes.cpu().numpy())
        depths.append(est.depths.cpu().numpy())
        counters = counters + est.counters.cpu().numpy()
    codes, depths = np.stack(codes), np.stack(depths)

    t0 = time.perf_counter()
    one, = run_ranks(dist_rank, 1, (True,), timeout=600.0)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank, DIST_RANKS, (False,), timeout=600.0)
    ranks_s = time.perf_counter() - t0

    # ---- a world of one NCCL rank: group=None to the bit
    check(one["backend"] == "nccl", f"world of one ran {one['backend']}")
    for name, a, b in (("BA", one["ba"], one["ba_single"]),
                       ("pose graph", one["pg"][:2], one["pg_single"][:2])):
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"NCCL world of one: distributed {name} differs from "
              f"group=None")
    check(one["pg"][2] == one["pg_single"][2],
          f"PCG iterations {one['pg'][2]} against {one['pg_single'][2]}")

    # ---- DIST_RANKS gloo ranks against the single-process runs
    check(all(r["backend"] == "gloo" for r in ranks),
          f"{DIST_RANKS} ranks on one card ran {[r['backend'] for r in ranks]}")
    a = [r["assoc"] for r in ranks]
    launches = [x["launches"] for x in a]
    check(launches == [1] * DIST_RANKS,
          f"gather_neighbors launches per rank {launches}, want 1 (one "
          f"frame each)")
    check(np.array_equal(np.concatenate([x["codes"] for x in a]), codes),
          "sharded association codes differ from the single-process run")
    check(all(np.array_equal(x["counters"], counters) for x in a),
          f"sharded counters {[x['counters'] for x in a]} != {counters}")
    d_depth = float(np.abs(np.concatenate([x["depths"] for x in a])
                           - depths).max())
    check(int(counters.sum()) == DIST_RANKS * cfg.max_features,
          f"counters sum to {int(counters.sum())}")

    R, t, _, c0, c1 = ranks[0]["ba"]
    for r in ranks[1:]:
        check(np.array_equal(r["ba"][0], R) and np.array_equal(r["ba"][1], t)
              and r["ba"][3:] == (c0, c1), "BA poses differ between ranks")
    lm = np.concatenate([r["ba"][2] for r in ranks])
    sR, st, slm, sc0, sc1 = one["ba_single"]
    ba_err = (abs(c1 - sc1) / max(abs(sc1), DIST_BA_COST_ATOL / DIST_BA_TOL[0]
                                  * sc0),
              float(np.abs(R - sR).max()), float(np.abs(t - st).max()),
              float(np.abs(lm - slm).max()))
    check(ba_err[0] <= DIST_BA_TOL[0] and ba_err[1] <= DIST_BA_TOL[1]
          and ba_err[2] <= DIST_BA_TOL[2] and ba_err[3] <= DIST_BA_TOL[3],
          f"distributed BA against single: {ba_err}, bars {DIST_BA_TOL}")
    check(np.isfinite(c1) and c1 < c0, f"BA cost {c0} -> {c1}")

    gR, gt, pcg = ranks[0]["pg"][:3]
    for r in ranks[1:]:
        check(r["pg"][2] == pcg, f"PCG iterations differ between ranks: "
                                 f"{[x['pg'][2] for x in ranks]}")
        check(np.array_equal(r["pg"][0], gR) and np.array_equal(r["pg"][1],
                                                                gt),
              "pose-graph poses differ between ranks")
    extent = float(np.ptp(one["pg_single"][1], axis=0).max())
    d_pos = float(np.abs(gt - one["pg_single"][1]).max())
    d_rot = _angle(gR, one["pg_single"][0])
    cost0, cost1 = ranks[0]["pg_cost"]
    check(np.isfinite(gt).all() and cost1 < cost0,
          f"distributed pose graph cost {cost0} -> {cost1}")
    check(d_pos <= KITTI00_TOL[0] * extent and d_rot <= KITTI00_TOL[1],
          f"distributed pose graph against single: {d_pos:.3e} m of "
          f"{extent:.1f} m, {d_rot:.2e} rad")

    def row(ms, ar, sy):
        return f"{ms:.3f} ms, {ar:g} all_reduce, {sy:g} host syncs"

    x = a[0]
    log(f"phase 9 dist: {DIST_RANKS} gloo ranks on the card "
        f"({ranks_s:.1f} s, spawn included): association of "
        f"{DIST_RANKS} frames at {cfg.max_points} points / "
        f"{cfg.max_features} features / {cfg.image_width}x"
        f"{cfg.image_height}, 1 frame per rank: rank 0's first call "
        f"(lazy initialization included) {row(x['ms'], x['all_reduce'], x['syncs'])}, "
        f"gather_neighbors launches per rank {launches}; codes and counters "
        f"equal to the single-process run, depths within {d_depth:.1e} "
        f"[{card}]")
    log(f"phase 9 dist: BA K=8, L={lm.shape[0]} ({lm.shape[0] // DIST_RANKS} "
        f"per rank), {DIST_BA_ITERS} iterations: cost {c0:.6g} -> {c1:.6g}; "
        f"against single: cost {ba_err[0]:.1e} rel, R {ba_err[1]:.1e}, t "
        f"{ba_err[2]:.1e}, landmarks {ba_err[3]:.1e}; per iteration: single "
        f"{row(*one['ba_iter_single'])} | NCCL world of 1 "
        f"{row(*one['ba_iter'])} | {DIST_RANKS} gloo ranks "
        f"{row(*ranks[0]['ba_iter'])} [{card}]")
    log(f"phase 9 dist: pose graph {KITTI00_POSES} poses, "
        f"gn_iters={DIST_PG['gn_iters']}, cg_iters={DIST_PG['cg_iters']}: "
        f"cost {cost0:.4g} -> {cost1:.4g}, PCG iterations {pcg} on every "
        f"rank; against single: positions {d_pos:.3e} m of {extent:.1f} m, "
        f"rotations {d_rot:.2e} rad; per GN iteration: single "
        f"{row(*one['pg_single'][3:])} (deterministic mode) | NCCL world "
        f"of 1 {row(*one['pg'][3:])} (deterministic mode) | {DIST_RANKS} "
        f"gloo ranks {row(*ranks[0]['pg'][3:])}; one all_reduce of the "
        f"matvec's [{KITTI00_POSES}, 6] alone: NCCL world of 1 "
        f"{one['ar'][0]:.3f} ms, {DIST_RANKS} gloo ranks "
        f"{ranks[0]['ar'][0]:.3f} ms (the sync debug mode sees no host sync "
        f"in gloo: it stages CUDA tensors through the host in its own "
        f"thread, and the caller blocks until they are back) [{card}]")
    log(f"phase 9 dist: NCCL world of 1 ({one_s:.1f} s, spawn included): "
        f"distributed_ba and distributed_pose_graph equal group=None to the "
        f"bit; phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"gather_neighbors": sum(launches)}


# -------------------------------------------------------------- phase 10

def bench_py_keys() -> list:
    """The keys of bench.py's JSON line, in order, read from its source:
    the printed dict's own keys, then `spread_pct_` + each key of its
    `legs` dict, which it splices in with `**spreads`."""
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    legs, printed = None, None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["legs"]):
            legs = [k.value for k in node.value.keys]
        if (isinstance(node, ast.Call)
                and ast.unparse(node.func) == "json.dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            printed = node.args[0].keys
    keys = []
    for k in printed:
        keys += ([f"spread_pct_{leg}" for leg in legs] if k is None
                 else [k.value])
    return keys


def _host(tree):
    """A copy of a result tree with every tensor leaf as a numpy array."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _host(x) for k, x in tree.items()}
    return tree


# The stages that _CascadeTrace records by default (module under
# mono_lidar_depth_tpu_torch, global): core/depth_estimator.py's, the road
# plane's scatter in core/planefit.py and the RANSAC refit of the ground
# plane in core/ransac.py.
_TRACED = (("core.depth_estimator", "rasterize_cloud"),
           ("core.depth_estimator", "_gather_two_scales"),
           ("core.depth_estimator", "filter_points_min_dist_blob"),
           ("core.depth_estimator", "max_spanning_triangle"),
           ("core.depth_estimator", "plane_from_points"),
           ("core.depth_estimator", "ray_plane_intersection"),
           ("core.depth_estimator", "mestimator_plane"),
           ("core.planefit", "_scatter3"),
           ("core.depth_estimator", "_apply_depth_gates"),
           ("core.depth_estimator", "_road_pass"),
           ("core.ransac", "_ls_plane"))


class _CascadeTrace:
    """While open, every call of `stages` (default _TRACED) with its
    arguments and result copied to the host: `calls[name]` lists (args,
    result, keyword arguments) in call order, `order` every call as
    (name, (args, keyword arguments), result) in the order they return.
    `estimate_depths` calls each default stage once, but
    `plane_from_points`, `ray_plane_intersection` and `_apply_depth_gates`:
    the primary path's call first, then the road pass's.  `real(name)` is
    the stage's own function."""

    def __init__(self, stages=_TRACED):
        self.stages = stages

    def __enter__(self):
        import importlib

        self.real_fns, self.order = [], []
        self.calls = {name: [] for _, name in self.stages}
        for mod_name, name in self.stages:
            module = importlib.import_module(
                f"mono_lidar_depth_tpu_torch.{mod_name}")
            real = getattr(module, name)
            self.real_fns.append((module, name, real))

            def traced(*args, _real=real, _name=name, **kw):
                out = _real(*args, **kw)
                a, o, k = _host(args), _host(out), _host(kw)
                self.calls[_name].append((a, o, k))
                self.order.append((_name, (a, k), o))
                return out

            setattr(module, name, traced)
        return self

    def __exit__(self, *exc):
        for module, name, real in self.real_fns:
            setattr(module, name, real)

    def real(self, name):
        return next(r for _, n, r in self.real_fns if n == name)


def _ulps(a, b) -> int:
    """The largest distance in units in the last place between two float
    arrays of one shape (0 when bit-equal): float64 arrays in float64's
    ulps, others in float32's."""
    if np.size(a) == 0:
        return 0
    if np.asarray(a).dtype == np.float64:
        def ordered(x):  # float64 order as uint64, without overflow
            i = np.ascontiguousarray(x, np.float64).view(np.uint64)
            top = np.uint64(1 << 63)
            return np.where(i >= top, ~i + np.uint64(1), i + top)

        oa, ob = ordered(a), ordered(b)
        return int(np.where(oa >= ob, oa - ob, ob - oa).max())

    def ordered32(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered32(a) - ordered32(b)).max())


def _f32(x) -> str:
    """The shortest decimal that reads back as the same float32."""
    return np.format_float_positional(np.float32(x), unique=True)


def _raw_neighbors(frame, cam, uv, scales):
    """Each scale's raw point indices [K] of one feature (uv [2]) in a
    host FrameCloud, from the plain gather (bit-equal to the kernel,
    phase 3)."""
    import torch
    from mono_lidar_depth_tpu_torch.core import neighbors
    from mono_lidar_depth_tpu_torch.core.projection import FrameCloud

    fc = FrameCloud(*(torch.from_numpy(np.asarray(x)) for x in frame))
    nbs = neighbors.gather_stacks_reference(
        neighbors.frame_stacks([fc], True), [torch.from_numpy(uv[None])],
        cam, scales, True)
    return [nb.indices[0].numpy() for nb in nbs]


def _port_line() -> str:
    """file:line of the innermost frame in the port's package."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if "/mono_lidar_depth_tpu_torch/" in path:
            return (f"{path.split('/mono_lidar_depth_tpu_torch/')[1]}:"
                    f"{f.f_lineno}")
        f = f.f_back
    return "?"


def _op_chain(fn, args, kwargs, devices, lane=None) -> list:
    """Where a port function parts between devices, op by op: `fn(*args,
    **kwargs)` (host arrays) runs once on the CPU under a torch function
    mode that records every torch op it calls and its inputs; each
    recorded op then runs again on each of `devices` (card, CPU) from the
    CPU's inputs, so an op whose outputs differ computes otherwise on the
    two devices from the same inputs.  `lane` reads row `lane` of outputs
    whose first dimension is the batch's.  Returns [(file:line in the
    port, op, largest ulp distance of its float output, or 1 where an
    integer or boolean output differs)] for every op with a tensor
    output; `lane` applies where the first argument is the batch's
    tensor."""
    import torch
    from torch.overrides import TorchFunctionMode, resolve_name
    from torch.utils._pytree import tree_leaves, tree_map

    def on(d):
        return lambda x: (x.to(d) if isinstance(x, torch.Tensor) else
                          d if isinstance(x, torch.device) else x)

    def versions(tree):
        return [x._version for x in tree_leaves(tree)
                if isinstance(x, torch.Tensor)]

    ops = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, a=(), kw=None):
            kw = kw or {}
            seen = versions((a, kw))
            out = func(*a, **kw)
            if isinstance(out, torch.Tensor):
                ops.append((_port_line(), func, (a, kw), seen))
            return out

    host = tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x))
                    if isinstance(x, np.ndarray) else x, (args, kwargs))
    first = host[0][0]
    batch = first.shape[0] if isinstance(first, torch.Tensor) else None
    with Record():
        fn(*host[0], **host[1])
    chain = []
    for where, func, (a, kw), seen in ops:
        name = (resolve_name(func) or getattr(func, "__name__", str(func)))
        name = name.replace("torch.Tensor.", "").replace("torch.", "")
        # The inputs are kept by reference: none may have been written in
        # place after the op read it.
        check(versions((a, kw)) == seen,
              f"_op_chain: an input of {name} at {where} was written later")
        res = []
        for d in devices:
            a_d, kw_d = tree_map(on(d), (a, kw))
            r = func(*a_d, **kw_d).cpu()
            if lane is not None and r.dim() and batch and r.shape[0] == batch:
                r = r[lane]
            res.append(r)
        dist = (_ulps(res[0].numpy(), res[1].numpy())
                if res[0].is_floating_point()
                else int(not torch.equal(res[0], res[1])))
        chain.append((where, name, dist))
    return chain


def _chain_text(chain) -> str:
    """The ops of an `_op_chain` that part, in call order, and the first."""
    parted = [(where, name, u) for where, name, u in chain if u]
    shown = ", ".join(f"{where} {name} {u}" for where, name, u in parted[:8])
    first = f"{parted[0][1]} at {parted[0][0]}" if parted else "none"
    return (f"{len(chain)} ops, {len(parted)} parting: {shown or 'none'}"
            f"{' ...' if len(parted) > 8 else ''} ulp (first op to part: "
            f"{first})")


def _refit_text(g: dict, c: dict, devices) -> str:
    """The RANSAC refit of the ground plane on the two devices: its inputs,
    its coefficients and, op by op from the same inputs, where it parts."""
    if not g["_ls_plane"]:
        return ""
    (pg, wg), cg, _ = g["_ls_plane"][0]
    (pc, wc), cc, kc = c["_ls_plane"][0]
    text = (f" (RANSAC refit in the lidar frame: inputs "
            f"{max(_ulps(pg, pc), _ulps(wg, wc))} ulp, coefficients "
            f"{_ulps(cg, cc)} ulp apart")
    if devices is not None:
        from mono_lidar_depth_tpu_torch.core import ransac

        text += ("; op by op from the CPU's inputs: " + _chain_text(
            _op_chain(ransac._ls_plane, (pc, wc), kc, devices)))
    return text + ")"


def _cascade_split(cfg, cam, uv, lane: int, g: dict, c: dict,
                   devices=None) -> tuple[str, list]:
    """Where one lane's depth cascade parts between two devices' traces
    (`_CascadeTrace.calls` of one `estimate_depths` each, card `g` and CPU
    `c`), step by step: (1) points_cam and uv of the lane's gathered
    neighbours at both scales, (2) the histogram segment, (3) the
    triangle, (4) the plane and its depth, (5) the road pass's inputs,
    its scatter matrix and plane, (6) the global and local gate margins.
    With `devices` (card, CPU), the triangle, the ground plane's RANSAC
    refit and the road plane's fit are also replayed op by op on both
    from the CPU's inputs (`_op_chain`).  Returns (the first step whose
    values are not bit-equal, one line per step)."""
    from mono_lidar_depth_tpu_torch.core import planefit

    i = lane
    lines, first = [], None

    def step(name, equal, text):
        nonlocal first
        if not equal and first is None:
            first = name
        lines.append(f"({name}) {'bit-equal' if equal else 'DIFFER'}: {text}")

    # (1) the frame's transform, then the lane's neighbours
    fg, fc = g["rasterize_cloud"][0][1], c["rasterize_cloud"][0][1]
    v = fc.valid
    pts_rows = (fg.points_cam[v] != fc.points_cam[v]).any(1)
    uv_rows = (fg.uv[v] != fc.uv[v]).any(1)
    hx = cfg.pixelarea_search_witdh * 0.5
    hy = cfg.pixelarea_search_height * 0.5
    scales = [(hx, hy, cfg.primary_window),
              (hx * cfg.road_search_scale_x, hy * cfg.road_search_scale_y,
               cfg.road_window)]
    parts, equal = [], True
    nbs_g, nbs_c = g["_gather_two_scales"][0][1], c["_gather_two_scales"][0][1]
    idx_g = _raw_neighbors(fg, cam, uv, scales)
    idx_c = _raw_neighbors(fc, cam, uv, scales)
    for k, (ng, nc) in enumerate(zip(nbs_g, nbs_c)):
        same_idx = np.array_equal(idx_g[k], idx_c[k])
        ids = np.intersect1d(idx_g[k][idx_g[k] >= 0], idx_c[k][idx_c[k] >= 0])
        p_ulp = _ulps(fg.points_cam[ids], fc.points_cam[ids])
        u_ulp = _ulps(fg.uv[ids], fc.uv[ids])
        m_eq = np.array_equal(ng.mask[i], nc.mask[i])
        both = ng.mask[i] & nc.mask[i]
        d_ulp = _ulps(ng.points_cam[i][both], nc.points_cam[i][both])
        equal &= same_idx and m_eq and p_ulp == 0 and u_ulp == 0 \
            and d_ulp == 0
        parts.append(
            f"scale {k}: raw neighbour indices "
            f"{'equal' if same_idx else 'differ'} ({len(ids)} in common: "
            f"points_cam {p_ulp} ulp, uv {u_ulp} ulp apart); decoded window "
            f"mask {'equal' if m_eq else 'differs'} ({int(ng.count[i])}/"
            f"{int(nc.count[i])}), decoded points_cam {d_ulp} ulp apart on "
            f"{int(both.sum())} common cells")
    step("1 neighbours", equal,
         f"frame transform: points_cam of {int(pts_rows.sum())} and uv of "
         f"{int(uv_rows.sum())} of {int(v.sum())} valid points differ (max "
         f"{_ulps(fg.points_cam[v], fc.points_cam[v])} / "
         f"{_ulps(fg.uv[v], fc.uv[v])} ulp); " + "; ".join(parts))

    # (2) the histogram segment
    hg, hc = (t["filter_points_min_dist_blob"][0][1] for t in (g, c))
    step("2 segment", np.array_equal(hg.seg_mask[i], hc.seg_mask[i])
         and hg.lower[i] == hc.lower[i],
         f"points {int(hg.seg_mask[i].sum())}/{int(hc.seg_mask[i].sum())}, "
         f"lower bin border {_f32(hg.lower[i])}/{_f32(hc.lower[i])} m, found "
         f"{bool(hg.found[i])}/{bool(hc.found[i])}")

    # (3) the triangle
    if g["max_spanning_triangle"]:
        tg, tc = (t["max_spanning_triangle"][0][1] for t in (g, c))
        text = (f"corners {np.abs(tg.corners[i] - tc.corners[i]).max():.1e} "
                f"m apart ({_ulps(tg.corners[i], tc.corners[i])} ulp), span "
                f"gaps {_span_gap(tg.corners[i], tc.corners[i])}, ok "
                f"{bool(tg.ok[i])}/{bool(tc.ok[i])}")
        if devices is not None:
            args, _, kw = c["max_spanning_triangle"][0]
            text += ("; op by op from the CPU's inputs: " + _chain_text(
                _op_chain(planefit.max_spanning_triangle, args, kw, devices,
                          i)))
        step("3 triangle", np.array_equal(tg.corners[i], tc.corners[i]), text)

    def plane_at(t, n):
        normal, offset = t["plane_from_points"][n][1]
        return np.r_[normal[i], offset[i]]

    def depth_at(t, n):
        return t["ray_plane_intersection"][n][1][1][i]

    # (4) the primary plane and its depth
    pg, pc = plane_at(g, 0), plane_at(c, 0)
    ray = g["ray_plane_intersection"][0][0][3][i]
    angle, offset = _plane_angle_offset(pg, pc)
    step("4 plane", np.array_equal(pg, pc) and depth_at(g, 0) == depth_at(c, 0),
         f"normals {angle:.2e} deg apart, offsets {offset:.2e} m "
         f"({_ulps(pg, pc)} ulp); n.ray {float(np.dot(pg[:3], ray)):+.3e}/"
         f"{float(np.dot(pc[:3], ray)):+.3e}; depth "
         f"{_f32(depth_at(g, 0))}/{_f32(depth_at(c, 0))} m")

    # (5) the road pass
    rg, rc = g["_road_pass"][0], c["_road_pass"][0]
    coeffs = [np.asarray(r[0][4]) for r in (rg, rc)]
    coeffs = [x[i] if x.ndim == 2 else x for x in coeffs]
    ins = [(int(r[0][6][i]), bool(r[0][9][i]), bool(np.asarray(r[0][5]).ravel()[
        i if np.size(r[0][5]) > 1 else 0])) for r in (rg, rc)]
    text = (f"ground plane (camera) {_ulps(coeffs[0], coeffs[1])} ulp apart"
            f"{_refit_text(g, c, devices)}; "
            f"primary code {ins[0][0]}/{ins[1][0]}, primary success "
            f"{ins[0][1]}/{ins[1][1]}, plane ok {ins[0][2]}/{ins[1][2]}")
    equal = np.array_equal(coeffs[0], coeffs[1]) and ins[0] == ins[1]
    if g["_scatter3"]:
        (ag,), sg, _ = g["_scatter3"][0]
        (ac,), sc_, _ = c["_scatter3"][0]
        equal &= np.array_equal(ag[i], ac[i]) and np.array_equal(sg[i], sc_[i])
        text += (f"; weighted centered points {_ulps(ag[i], ac[i])} ulp, "
                 f"scatter {_ulps(sg[i], sc_[i])} ulp apart, the CPU's as "
                 f"{sc_.dtype} bits "
                 f"{sc_[i].view(f'u{sc_.itemsize}').ravel().tolist()}")
    if g["mestimator_plane"] and devices is not None:
        args, _, kw = c["mestimator_plane"][0]
        text += ("; the road plane's fit op by op from the CPU's inputs: "
                 + _chain_text(_op_chain(planefit.mestimator_plane, args, kw,
                                         devices, i)))
    if g["mestimator_plane"]:
        mg, mc = (t["mestimator_plane"][0][1] for t in (g, c))
        road = [np.r_[m.normal[i], -np.dot(m.normal[i], m.anchor[i])]
                for m in (mg, mc)]
        r_angle, r_offset = _plane_angle_offset(*road)
        equal &= np.array_equal(road[0], road[1])
        text += (f"; road plane normals {r_angle:.2e} deg apart, offsets "
                 f"{r_offset:.2e} m ({_ulps(road[0], road[1])} ulp)")
    if len(g["ray_plane_intersection"]) > 1:
        equal &= depth_at(g, 1) == depth_at(c, 1)
        text += (f"; road depth {_f32(depth_at(g, 1))}/"
                 f"{_f32(depth_at(c, 1))} m")
    text += (f"; road pass out {int(rg[1][0][i])}/{int(rc[1][0][i])} at "
             f"{_f32(rg[1][1][i])}/{_f32(rc[1][1][i])} m")
    step("5 road", equal, text)

    # (6) the gates: global margins (depth - min, max - depth) and the
    # local interval's (depth - lo, hi - depth) of each gate call
    parts, equal = [], True
    for n, (ag, ac) in enumerate(zip(g["_apply_depth_gates"],
                                     c["_apply_depth_gates"])):
        row = []
        for args, out, _ in (ag, ac):
            depth, nz, seg = args[1][i], args[2][i], args[3][i]
            lo_z = nz[seg].min() if seg.any() else np.inf
            hi_z = nz[seg].max() if seg.any() else -np.inf
            with np.errstate(invalid="ignore"):  # empty segment: inf - inf
                tol = ((hi_z - lo_z) * cfg.treshold_depth_local_value
                       if cfg.treshold_depth_local_valuetype == 1
                       else cfg.treshold_depth_local_value)
                row.append((float(depth - cfg.treshold_depth_min),
                            float(cfg.treshold_depth_max - depth),
                            float(depth - (lo_z - tol)),
                            float(hi_z + tol - depth), int(out[1][i])))
        equal &= np.array_equal(row[0], row[1], equal_nan=True)
        parts.append(
            f"{('primary', 'road')[n]}: global {row[0][0]:+.3e}, "
            f"{row[0][1]:+.3e} / {row[1][0]:+.3e}, {row[1][1]:+.3e}; local "
            f"{row[0][2]:+.3e}, {row[0][3]:+.3e} / {row[1][2]:+.3e}, "
            f"{row[1][3]:+.3e} m; gate code {row[0][4]}/{row[1][4]}")
    step("6 gates", equal, "; ".join(parts))
    return first or "none", lines


def phase_bench(card: str) -> dict:
    """bench_torch.run on the card at the full width, BENCH_FRAMES frames
    and one rep; then fast rasterization card against CPU on frames 0-1
    of its scene, and where the two devices' codes differ, where each
    such lane's cascade parts (`_cascade_split`)."""
    import contextlib
    import io

    import torch
    import bench_torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core.projection import (
        build_frame_cloud, rasterize_projected)
    from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
    from mono_lidar_depth_tpu_torch.core.result_types import (
        DepthResultType as R)
    from mono_lidar_depth_tpu_torch.tracker import klt

    t_phase = time.perf_counter()
    klt.launches = klt.gate_launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result, launches = bench_torch.run("cuda", n_frames=BENCH_FRAMES,
                                           reps=1)
    tracker = klt.launches + klt.gate_launches
    lines = printed.getvalue().strip().splitlines()
    check(len(lines) == 1 and json.loads(lines[0]) == result,
          f"bench_torch.run printed {len(lines)} lines, want its JSON line")
    keys = bench_py_keys()
    check(list(result) == keys,
          f"bench_torch's keys {list(result)} != bench.py's {keys}")
    # With one rep a leg's spread is 0 by definition.
    for k, v in result.items():
        if isinstance(v, bool) or isinstance(v, str):
            continue
        check(math.isfinite(v) and (v > 0 or k.startswith("spread_pct_")
                                    and v == 0),
              f"bench_torch: {k} = {v}")
    # bench_torch.run raises unless each leg launched the gather once per
    # estimate_depths / odometry_step call; here the totals of the run.
    calls = 2 * 4 * BENCH_FRAMES + 1 + bench_torch.SERVING_STEPS_PER_REP
    gathers = sum(launches.values())
    check(gathers == calls and tracker == 0,
          f"bench: {gathers} gather_neighbors and {tracker} tracker-kernel "
          f"launches, want {calls} and 0: {launches}")
    log(f"phase 10 bench: bench_torch.run, {BENCH_FRAMES} frames of 120000 "
        f"points, one rep ({time.perf_counter() - t_phase:.1f} s): "
        f"{json.dumps(result)}; gather_neighbors launches {launches} "
        f"(one per estimate_depths / odometry_step call), tracker kernels "
        f"{tracker} [{card}]")

    # ---- fast rasterization, card against CPU, on frames 0-1 of the
    # bench's scene, from the same RANSAC draws.
    t0 = time.perf_counter()
    sc = bench_torch.bench_scene(2)
    cfg = sc.cfg.replace(fast_rasterization=True)
    rng = np.random.default_rng(SEED)
    draws = [_numpy_draws(rng, cfg, int(v.sum())) for v in sc.valids]
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    cam, l2c_cpu = bench_torch.camera_and_extrinsics(cpu)
    _, l2c_dev = bench_torch.camera_and_extrinsics(dev)
    codes, depths, cells = {cpu: [], dev: []}, {cpu: [], dev: []}, 0
    traces = {cpu: [], dev: []}
    for f in range(2):
        cloud, valid = (torch.from_numpy(sc.clouds[f]),
                        torch.from_numpy(sc.valids[f]))
        sub_idx, picks = (torch.from_numpy(a) for a in draws[f])
        gp = bench_torch.ground_plane(cfg, cloud, valid,
                                      RansacDraws(sub_idx, picks))
        # The raster from the CPU's transform on both devices: cuBLAS may
        # round the 3x3 product otherwise, and a one-ulp change of z can
        # move a point across a 1 cm quantization step.
        want = build_frame_cloud(cloud, valid, l2c_cpu, cam,
                                 cfg.image_height, cfg.image_width,
                                 point_flags=gp.inlier_mask, fast=True)
        got = rasterize_projected(
            cloud.to(dev), want.points_cam.to(dev), want.uv.to(dev),
            valid.to(dev), cam, cfg.image_height, cfg.image_width,
            point_flags=gp.inlier_mask.to(dev), fast=True)
        for name in ("grid", "winner_flat", "visible"):
            a, b = getattr(got, name).cpu(), getattr(want, name)
            check(torch.equal(a, b),
                  f"frame {f}: fast raster {name} differs card/CPU on "
                  f"{int((a != b).sum())} entries")
        check(torch.equal(got.planes.cpu().view(torch.int32),
                          want.planes.view(torch.int32)),
              f"frame {f}: fast raster planes differ card/CPU in "
              f"{int((got.planes.cpu() != want.planes).sum())} cells")
        cells += int((want.grid >= 0).sum())
        for d, l2c in ((cpu, l2c_cpu), (dev, l2c_dev)):
            c, v = cloud.to(d), valid.to(d)
            with _CascadeTrace() as trace:
                gp_d = bench_torch.ground_plane(cfg, c, v, RansacDraws(
                    sub_idx.to(d), picks.to(d)))
                est = T.estimate_depths(
                    cfg, cam, l2c, c, v,
                    torch.from_numpy(sc.uv_new[f]).to(d),
                    torch.ones(cfg.max_features, dtype=torch.bool, device=d),
                    gp_d)
            traces[d].append(trace.calls)
            codes[d].append(est.codes.cpu().numpy())
            depths[d].append(est.depths.cpu().numpy())
    g_codes, c_codes = np.concatenate(codes[dev]), np.concatenate(codes[cpu])
    g_depths = np.concatenate(depths[dev])
    c_depths = np.concatenate(depths[cpu])
    N = cfg.max_features
    differ = np.flatnonzero(g_codes != c_codes)
    agree = 1.0 - differ.size / g_codes.size
    both = (g_codes == c_codes) & (c_depths > 0)
    rel = np.abs(g_depths - c_depths) / np.maximum(c_depths, 1e-30)
    by_code = {}
    for code in (R.Success, R.SuccessRoad):
        r = rel[both & (c_codes == int(code))]
        by_code[code.name] = (int(r.size),
                              float((r <= 5e-3).mean()) if r.size else 1.0,
                              float(r.max()) if r.size else 0.0)
    log(f"phase 10 bench: fast rasterization card vs CPU, frames 0-1 of the "
        f"bench's scene ({cells} occupied cells): grid, planes, winner_flat "
        f"and visible equal to the bit from the same points_cam and uv; "
        f"estimate_depths from the same RANSAC draws: codes agree "
        f"{agree:.5f}, differing lanes (frame:lane card/CPU) "
        f"{[f'{i // N}:{i % N} {R(int(g_codes[i])).name}/{R(int(c_codes[i])).name}' for i in differ]}; "
        f"depths on agreeing successes (lanes, share within 5e-3 relative, "
        f"max) {by_code} ({time.perf_counter() - t0:.1f} s) [{card}]")
    # Where each differing lane's cascade parts between the two devices.
    split = {}
    for k in differ:
        f, lane = divmod(int(k), N)
        first, lines = _cascade_split(cfg, cam, sc.uv_new[f][lane], lane,
                                      traces[dev][f], traces[cpu][f],
                                      (dev, cpu))
        split[f"{f}:{lane}"] = first
        log(f"phase 10 bench: lane {f}:{lane} "
            f"{R(int(g_codes[k])).name}/{R(int(c_codes[k])).name} "
            f"(card/CPU), step by step:")
        for ln in lines:
            log(f"    {ln}")
    log(f"phase 10 bench: the first step at which each differing lane's "
        f"cascade parts, card vs CPU: {split or 'no lane differs'}")
    check(agree >= 1.0, f"fast mode card/CPU codes agree {agree:.5f}")
    check(by_code["Success"][1] >= 0.999 and by_code["SuccessRoad"][1] >= 0.98,
          f"fast mode card/CPU depths within 5e-3 on too few lanes: "
          f"{by_code}")
    log(f"phase 10 bench: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"gather_neighbors": gathers}


def load_script(name: str):
    """scripts/<name>.py as a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script_ast(name: str):
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    with open(path) as fh:
        return ast.parse(fh.read())


def endurance_py_keys() -> tuple[list, dict]:
    """The keys of scripts/endurance_run.py's record, read from its
    source: (the top-level keys in order, {top-level key: [each key list
    the reference may write there]}).  Follows the dict literals that
    `main` assigns to `rec[...]` or to a name, `run_backend`'s `out`
    dict with its f-string key taking the call's label, and the keys
    later set on those dicts."""
    import ast

    tree = _script_ast("endurance_run")
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, ast.FunctionDef)}
    out = next(n.value for n in ast.walk(fns["run_backend"])
               if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
               and [ast.unparse(t) for t in n.targets] == ["out"])

    def key(node, label=None):
        if isinstance(node, ast.Constant):
            return node.value
        return "".join(v.value if isinstance(v, ast.Constant) else label
                       for v in node.values)  # f"ate_{label}_m"

    def keys_of(value):
        if isinstance(value, ast.Dict):
            return [key(k) for k in value.keys]
        if (isinstance(value, ast.Call)
                and ast.unparse(value.func) == "run_backend"):
            label = value.args[1].value
            return [key(k, label) for k in out.keys]
        if isinstance(value, ast.Name):
            return names.get(value.id)
        return None

    backend_nodes = set(map(id, ast.walk(fns["run_backend"])))
    assigns = sorted((n for n in ast.walk(fns["main"])
                      if isinstance(n, ast.Assign)
                      and id(n) not in backend_nodes),
                     key=lambda n: n.lineno)
    names, top, nested = {}, [], {}
    for node in assigns:
        for target in node.targets:
            elts = (target.elts if isinstance(target, ast.Tuple)
                    else [target])
            value = keys_of(node.value)
            for n, t in enumerate(elts):
                v = value if n == 0 else None
                if isinstance(t, ast.Name):
                    if v is not None:
                        names[t.id] = list(v)
                        if t.id == "rec":
                            top = list(v)
                    continue
                if not (isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)):
                    continue
                k, base = t.slice.value, t.value
                if isinstance(base, ast.Name) and base.id == "rec":
                    if k not in top:
                        top.append(k)
                    if v is not None:
                        nested.setdefault(k, []).append(list(v))
                    continue
                if isinstance(base, ast.Name) and base.id in names:
                    dict_keys = names[base.id]
                elif (isinstance(base, ast.Subscript)
                      and ast.unparse(base.value) == "rec"):
                    dict_keys = nested[base.slice.value][-1]
                else:
                    continue
                if k not in dict_keys:  # a dict keeps a key's first place
                    dict_keys.append(k)
    return top, nested


def check_endurance_keys(rec: dict) -> None:
    """The record's keys are the reference's (read from its source), plus
    `port`; each stage's keys are one of the reference's key lists."""
    top, nested = endurance_py_keys()
    check([k for k in rec if k != "port"] == top and "port" in rec,
          f"endurance record keys {list(rec)}, want {top} + ['port']")
    for k, alternatives in nested.items():
        check(list(rec[k]) in alternatives,
              f"endurance record {k}: keys {list(rec[k])}, want one of "
              f"{alternatives}")


def phase_endurance(card: str) -> dict:
    """scripts/endurance_run_torch.run on the card at ENDURANCE_FRAMES
    frames (one lap and its revisits) with the checkpoint at
    ENDURANCE_CHECKPOINT, the kernel counts reset just before."""
    import contextlib
    import io

    from mono_lidar_depth_tpu_torch.core import neighbors, windows
    from mono_lidar_depth_tpu_torch.obs.launches import kernel_launches
    from mono_lidar_depth_tpu_torch.tracker import klt

    e = load_script("endurance_run_torch")
    t0 = time.perf_counter()
    neighbors.launches = windows.launches = 0
    klt.launches = klt.gate_launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rec = e.run(ENDURANCE_FRAMES, ENDURANCE_CHECKPOINT, "cuda")
    wall = time.perf_counter() - t0
    total = kernel_launches()
    lines = [json.loads(ln) for ln in printed.getvalue().splitlines()]
    stages = ["vo", "checkpoint_resume", "pose_graph",
              "pose_graph_high_drift"]
    check([next(iter(ln)) for ln in lines] == stages,
          f"endurance_run_torch printed {lines}, want one line per stage")
    check_endurance_keys(rec)
    port = rec["port"]
    resume, pg, hd = (rec["checkpoint_resume"], rec["pose_graph"],
                      rec["pose_graph_high_drift"])
    log(f"phase 11 endurance: scripts/endurance_run_torch.run, "
        f"{ENDURANCE_FRAMES} frames at 384x128 (render {rec['gen_wall_s']} s)"
        f", checkpoint at {ENDURANCE_CHECKPOINT}, {wall:.1f} s: VO "
        f"{json.dumps(rec['vo'])}; resume {json.dumps(resume)}; backend "
        f"{json.dumps(pg)}; drifted {json.dumps(hd)}; verification calls "
        f"{port['verify_calls']} in {port['verify_s']} s; solves (s, GN "
        f"iterations) {port['solves']} [{card}]")
    check(resume["max_pose_deviation"] == 0.0,
          f"endurance: the resumed trajectory is not bit-equal "
          f"({resume['max_pose_deviation']})")
    check(pg["closures_verified"] >= 1 and pg["closures_used"] >= 1,
          f"endurance: {pg['closures_verified']} closures verified, "
          f"{pg['closures_used']} used in the nominal leg")
    check(math.isfinite(pg["ate_posegraph_m"])
          and pg["ate_posegraph_m"] <= pg["ate_vo_m"],
          f"endurance: backend ATE {pg['ate_posegraph_m']} m above the VO's "
          f"{pg['ate_vo_m']} m")
    # One gather, lk_track and zncc_gate per VO step (the first frame
    # only detects), and per verification direction: two per call.
    steps = ENDURANCE_FRAMES - 1
    for stage, calls in (("vo", steps), ("checkpoint_resume", steps),
                         ("pose_graph", 2 * port["verify_calls"][
                             "pose_graph"]),
                         ("pose_graph_high_drift", 2 * port["verify_calls"][
                             "pose_graph_high_drift"])):
        want = {"gather_neighbors": calls, "lk_track": calls,
                "zncc_gate": calls, "slice_windows": 0}
        check(port["launches"][stage] == want,
              f"endurance {stage}: launches {port['launches'][stage]}, "
              f"want {want}")
    log(f"phase 11 endurance: launches per stage {port['launches']} (one "
        f"gather_neighbors, lk_track and zncc_gate per VO step and per "
        f"verification direction), total {total} [{card}]")
    return total


# --------------------------------------------------------------- phase 12

def _printed_dict_keys(tree) -> list:
    """The keys of every `print(json.dumps({...}))` dict literal, in
    source order."""
    import ast

    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and ast.unparse(n.func) == "json.dumps" and n.args
                    and isinstance(n.args[0], ast.Dict)),
                   key=lambda n: (n.lineno, n.col_offset))
    return [[k.value for k in c.args[0].keys] for c in calls]


def parity_py_keys() -> dict:
    """The keys of scripts/make_parity_record.py's record, read from its
    source and from the sources of the three scripts it runs: {path: the
    key list there}, where a path is () for the top level, (entry,) for
    an entry, (entry, row) for a config-2 or config-3 row, (entry, "*")
    for every row of a sweep, ("scaling", i) for the i-th scaling line
    and ("multihost_demo", "tail") for the demo's JSON line."""
    import ast

    tree = _script_ast("make_parity_record")
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, ast.FunctionDef)}
    main = fns["main"]
    keys: dict = {(): []}
    assigns = sorted((n for n in ast.walk(main)
                      if isinstance(n, (ast.Assign, ast.AnnAssign))),
                     key=lambda n: n.lineno)

    def dict_keys(node):
        return [k.value for k in node.keys]

    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For)
                and ast.unparse(n.target) == "(name, kw)")
    modes = [e.elts[0].value for e in loop.iter.elts]
    for node in assigns:
        target = node.target if isinstance(node, ast.AnnAssign) \
            else node.targets[0]
        text = ast.unparse(target)
        if text == "rec" and isinstance(node.value, ast.Dict):
            keys[()] += dict_keys(node.value)
        elif (isinstance(target, ast.Subscript)
              and ast.unparse(target.value) == "rec"):
            k = target.slice.value
            if k not in keys[()]:
                keys[()].append(k)
            if isinstance(node.value, ast.Dict):
                keys[(k,)] = dict_keys(node.value)
        elif text == "depth[name]":
            for m in modes:
                keys[("depth", m)] = dict_keys(node.value)
        elif text == "depth['fast_rasterization']":
            keys[("depth", "fast_rasterization")] = dict_keys(node.value)
        elif text.startswith("depth['ransac']["):
            keys[("depth", "ransac")].append(target.slice.value)
        elif text.startswith("vo_rec['reinit']["):
            keys.setdefault(("vo", "reinit"), []).append(target.slice.value)
    metrics = next(n.value for n in ast.walk(fns["vo_metrics"])
                   if isinstance(n, ast.Return))
    keys[("vo", "reinit")] = dict_keys(metrics) + keys.get(("vo", "reinit"),
                                                           [])
    keys[("vo", "persist")] = dict_keys(metrics)
    keys[("depth",)] = modes + ["fast_rasterization"]
    keys[("vo",)] = ["reinit", "persist"]
    row = next(n.value for n in ast.walk(_script_ast("exp_success_rate"))
               if isinstance(n, ast.Assign)
               and ast.unparse(n.targets[0]) == "row")
    for k in ("density_sweep", "density_sweep_veto_off"):
        keys[(k, "*")] = dict_keys(row)
    for i, line in enumerate(_printed_dict_keys(_script_ast("bench_scaling"))):
        keys[("scaling", i)] = line
    keys[("multihost_demo", "tail")] = _printed_dict_keys(
        _script_ast("multihost_demo"))[0]
    return keys


def check_parity_keys(rec: dict) -> None:
    """The record's keys are the reference's (parity_py_keys), plus
    `port`, at every level; no leg is an {"error": ...}."""
    keys = parity_py_keys()
    check([k for k in rec if k != "port"] == keys[()] and "port" in rec,
          f"parity record keys {list(rec)}, want {keys[()]} + ['port']")
    for path, want in keys.items():
        if not path:
            continue
        if path[-1] == "*":
            rows = rec[path[0]]
            check(len(rows) > 0 and all(list(r) == want for r in rows),
                  f"parity record {path[0]}: rows {rows}, want keys {want}")
        elif path[0] == "scaling":
            row = rec["scaling"][path[1]]
            check(list(row) == want,
                  f"parity record scaling line {path[1]}: {row}, want keys "
                  f"{want}")
        elif path == ("multihost_demo", "tail"):
            mh = rec["multihost_demo"]
            check(mh["ok"], f"parity record: the demo failed: {mh}")
            check(list(json.loads(mh["tail"][-1])) == want,
                  f"parity record demo line {mh['tail']}, want keys {want}")
        else:
            node = rec
            for p in path:
                node = node[p]
            check(list(node) == want,
                  f"parity record {path}: keys {list(node)}, want {want}")
    check(len(rec["scaling"]) == len(
        [p for p in keys if p and p[0] == "scaling"]),
        f"parity record scaling: {rec['scaling']}")


def parity_card_vs_cpu(P, seq, card: str) -> None:
    """road_veto_off, production and persisted landmarks over the first
    PARITY_AGREE_FRAMES frames, on the card and on the CPU from the card's
    tracker outputs and the same numpy RANSAC draws: codes of every frame
    (process_frame) and poses (odometry_step)."""
    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    base = P.record_config()
    modes = {name: over for name, over, _ in P.MODES}
    cam = seq.camera
    for name, cfg, ocfg in (
            ("road_veto_off", base.replace(**modes["road_veto_off"]),
             T.OdometryConfig()),
            ("production", base.replace(**modes["production"]),
             T.OdometryConfig()),
            ("persist", base, T.OdometryConfig(persist_landmarks=True))):
        prime: list = []
        inputs = [f for f, _ in T.frame_inputs(
            seq, cfg, max_frames=PARITY_AGREE_FRAMES + 1, prime=prime,
            device=dev, seed=SEED)]
        rng = np.random.default_rng(SEED + 12)
        draws = [_numpy_draws(rng, cfg, int(prime[0][1].sum()))] + [
            _numpy_draws(rng, cfg, int(f.cloud_valid.sum())) for f in inputs]

        def run(d):
            l2c = seq.lidar_to_cam(d)

            def rd(k):
                return RansacDraws(*(torch.from_numpy(a).to(d)
                                     for a in draws[k]))

            state = T.OdometryState.create(cfg, ocfg, P.VO_KW["max_tracks"],
                                           P.VO_KW["max_length"], d)
            state = state._replace(tracklets=T.prime_state(
                cfg, cam, l2c, state.tracklets, prime[0][0].to(d),
                prime[0][1].to(d), rd(0)))
            poses, codes = [], []
            for k, f in enumerate(inputs, 1):
                frame = T.FrameInput(*(x.to(d) for x in f[:7]), rng=rd(k))
                _, _, cod = T.process_frame(cfg, cam, l2c, state.tracklets,
                                            frame)
                state, R_cw, t_cw, _ = T.odometry_step(cfg, ocfg, cam, l2c,
                                                       state, frame)
                poses.append((R_cw.cpu().numpy(), t_cw.cpu().numpy()))
                codes.append(cod.cpu().numpy())
            return poses, np.concatenate(codes)

        t0 = time.perf_counter()
        (g_poses, g_codes), (c_poses, c_codes) = run(dev), run(cpu)
        agree = float(np.mean(g_codes == c_codes))
        dR = max(float(np.abs(a[0] - b[0]).max())
                 for a, b in zip(g_poses, c_poses))
        dt = max(float(np.abs(a[1] - b[1]).max())
                 for a, b in zip(g_poses, c_poses))
        log(f"phase 12 parity: card vs CPU plain versions, {name}, "
            f"{PARITY_AGREE_FRAMES} frames ({time.perf_counter() - t0:.1f} "
            f"s): codes agree {agree:.5f} ({int((g_codes != c_codes).sum())}"
            f" of {g_codes.size} differ), poses max |dR| {dR:.2e}, max |dt| "
            f"{dt:.2e} m [{card}]")
        check(agree >= PARITY_CODE_BAR,
              f"{name}: card/CPU codes agree {agree:.5f} < {PARITY_CODE_BAR}")
        check(dR <= PARITY_POSE_BAR[0] and dt <= PARITY_POSE_BAR[1],
              f"{name}: card/CPU poses differ: |dR| {dR:.2e}, |dt| {dt:.2e}")


def parity_steps_card_vs_cpu(P, card: str) -> None:
    """Config 3 on the card over PARITY_FRAMES frames of the record's
    sequence, then the whole run on the CPU with the card's RANSAC draws
    (make_parity_record_torch.replay_on_cpu): ATEs within PARITY_ATE_BAR;
    and every frame once on the CPU from the card's carry after the frame
    before and with the card's RANSAC draws
    (make_parity_record_torch.replay_steps_on_cpu): counts equal on every
    frame, poses within PARITY_POSE_BAR, codes at PARITY_CODE_BAR, the
    carry's integer leaves equal to the bit, and the frame-by-frame card
    run equal to the uninterrupted one."""
    seq = P.render_sequence(P.record_spec(PARITY_FRAMES))
    cfg = P.record_config()
    t0 = time.perf_counter()
    vo = P.eval_vo_sequence(seq, cfg, P.OdometryConfig(), device="cuda",
                            **P.VO_KW)
    whole = P.replay_on_cpu(seq, cfg, vo, "cuda")
    gap = abs(float(vo["ate_rmse"]) - whole["ate_rmse_m"])
    log(f"phase 12 parity: config 3 reinit, {PARITY_FRAMES} frames: ATE "
        f"{float(vo['ate_rmse']):.4f} m on the card, "
        f"{whole['ate_rmse_m']:.3f} m on the CPU from the card's draws "
        f"(replay_on_cpu; poses max |dR| {whole['max_dR']:.2e}, |dt| "
        f"{whole['max_dt_m']:.2e} m, first frame beyond the bar "
        f"{whole['first_frame_apart']}) ({time.perf_counter() - t0:.1f} s) "
        f"[{card}]")
    check(gap <= PARITY_ATE_BAR, f"config 3 ATE card {vo['ate_rmse']:.4f} "
          f"against the CPU's {whole['ate_rmse_m']:.3f} m")
    t0 = time.perf_counter()
    s = P.replay_steps_on_cpu(seq, cfg, vo, "cuda")
    log(f"phase 12 parity: config 3 one step at a time, card vs CPU from "
        f"the card's carry, {s['frames']} frames "
        f"({time.perf_counter() - t0:.1f} s): largest |dR| {s['max_dR']:.2e}"
        f" (frame {s['max_dR_frame']}), |dt| {s['max_dt_m']:.2e} m (frame "
        f"{s['max_dt_frame']}); counts differ at {s['count_frames']}; codes "
        f"agree {s['codes_agree']:.5f}, differ at {s['code_frames']}, first "
        f"{s['first_frame']}; integer leaves apart {s['int_apart']}; "
        f"frame-by-frame run equal to the run {s['equals_run']} [{card}]")
    check(s["equals_run"], "config 3 frame by frame on the card is not the "
          "uninterrupted run")
    check(not s["int_apart"], f"one-step integer leaves: {s['int_apart']}")
    check(not s["count_frames"],
          f"one-step counts differ at frames {s['count_frames']}")
    check(s["max_dR"] <= PARITY_POSE_BAR[0]
          and s["max_dt_m"] <= PARITY_POSE_BAR[1],
          f"one-step poses: |dR| {s['max_dR']:.2e}, |dt| {s['max_dt_m']:.2e}")
    check(s["codes_agree"] >= PARITY_CODE_BAR,
          f"one-step codes agree {s['codes_agree']:.5f} < {PARITY_CODE_BAR}")


def phase_parity(card: str) -> dict:
    """scripts/make_parity_record_torch.run on the card: stages 2-4b in
    process at PARITY_FRAMES frames (make_parity_record.py's --quick
    size), its three subprocess legs at their smallest (the sweep at
    PARITY_SWEEP's frames and rows, veto on and off; ranks PARITY_RANKS;
    the demo's 2 processes); the kernel counts reset just before."""
    import contextlib
    import io

    from mono_lidar_depth_tpu_torch.core import neighbors, windows
    from mono_lidar_depth_tpu_torch.obs.launches import kernel_launches
    from mono_lidar_depth_tpu_torch.tracker import klt

    P = load_script("make_parity_record_torch")
    frames, rows = PARITY_SWEEP
    t0 = time.perf_counter()
    neighbors.launches = windows.launches = 0
    klt.launches = klt.gate_launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rec = P.run(PARITY_FRAMES, "cuda", "chip_smoke", sweep_frames=frames,
                    sweeps=(("density_sweep", ["--rows", str(rows)]),
                            ("density_sweep_veto_off",
                             ["--no-far-veto", "--rows", str(rows)])),
                    ranks=PARITY_RANKS, replay=False)
    wall = time.perf_counter() - t0
    total = kernel_launches()
    port = rec["port"]
    log(f"phase 12 parity: scripts/make_parity_record_torch.run, "
        f"{PARITY_FRAMES} frames at 384x128, {wall:.1f} s (per stage "
        f"{ {k: round(v, 1) for k, v in port['seconds'].items()} }): depth "
        f"{json.dumps(rec['depth'])}; vo {json.dumps(rec['vo'])}; pose graph "
        f"{json.dumps(rec['pose_graph'])}; drifted "
        f"{json.dumps(rec['pose_graph_high_drift'])}; verification "
        f"{port['verify']}; re-initialized runs {port['reinit_runs']} "
        f"[{card}]")
    log(f"phase 12 parity: sweep {json.dumps(rec['density_sweep'])}, veto "
        f"off {json.dumps(rec['density_sweep_veto_off'])}; scaling "
        f"{json.dumps(rec['scaling'])}; demo "
        f"{json.dumps(rec['multihost_demo'])} [{card}]")
    check_parity_keys(rec)
    for name, row in rec["depth"].items():
        for k in ("success_rate_all", "success_rate_lidar_covered"):
            check(0.0 < row[k] < 1.0, f"parity {name}: {k} {row[k]}")
    for key in ("density_sweep", "density_sweep_veto_off"):
        for row in rec[key]:
            for k in ("success_all", "success_covered"):
                check(0.0 < row[k] < 1.0, f"parity {key}: {k} {row[k]}")
    vo, pg, hd = rec["vo"], rec["pose_graph"], rec["pose_graph_high_drift"]
    ates = [vo["reinit"]["ate_rmse_m"], vo["persist"]["ate_rmse_m"],
            *vo["reinit"]["ate_runs_m"], pg["ate_vo_m"], hd["ate_drifted_m"]]
    ates += [leg["ate_posegraph_m"] for leg in (pg, hd)
             if leg["closures_used"]]  # NaN where no closure reached it
    check(all(math.isfinite(a) for a in ates), f"parity ATEs {ates}")
    demo = json.loads(rec["multihost_demo"]["tail"][-1])
    check(demo["match"] is True, f"parity demo: {demo}")

    # Exactly one lk_track, zncc_gate and gather_neighbors launch per
    # processed frame (two gathers with region growing) and per
    # verification direction, two directions per call.
    steps = PARITY_FRAMES - 1

    def each(n, gather=None):
        return {"gather_neighbors": n if gather is None else gather,
                "lk_track": n, "zncc_gate": n, "slice_windows": 0}

    want = {name: each(2 * steps) for name, _, _ in P.MODES}
    want["region_growing"] = each(2 * steps, 4 * steps)
    want[P.FAST[0]] = each(steps)
    want["device_time"] = each(2 * steps)  # a warm run, a timed one
    got = {k: v["launches"] for k, v in port["depth"].items()}
    check(got == want, f"parity depth launches {got}, want {want}")
    want_stage = {
        "depth": each(sum(v["lk_track"] for v in want.values()),
                      sum(v["gather_neighbors"] for v in want.values())),
        "vo": each(4 * steps),
        "pose_graph": each(2 * port["verify"]["pose_graph"]["calls"]),
        "pose_graph_high_drift": each(
            2 * port["verify"]["pose_graph_high_drift"]["calls"])}
    check(port["launches"] == want_stage,
          f"parity launches per stage {port['launches']}, want {want_stage}")
    legs = port["legs"]
    for key in ("density_sweep", "density_sweep_veto_off"):
        check(legs[key]["launches"] == each(frames - 1),
              f"parity {key} launches {legs[key]['launches']}")
    # each world: one untimed and REPS timed steps over B = 2 * max ranks
    # frames, one gather per frame on whichever rank runs it
    S = load_script("bench_scaling_torch")
    frames_run = len(PARITY_RANKS) * (S.REPS + 1) * 2 * max(PARITY_RANKS)
    check(legs["scaling"]["launches"] == each(0, frames_run),
          f"parity scaling launches {legs['scaling']['launches']}, want "
          f"{frames_run} gathers")
    log(f"phase 12 parity: launches per stage {port['launches']}, per depth "
        f"mode {got}, sweeps {legs['density_sweep']['launches']} / "
        f"{legs['density_sweep_veto_off']['launches']}, scaling "
        f"{legs['scaling']['launches']} (exact) [{card}]")

    # card against the CPU on the rows this slice drives first on the card
    seq = P.render_sequence(P.record_spec(PARITY_AGREE_FRAMES + 1))
    parity_card_vs_cpu(P, seq, card)
    parity_steps_card_vs_cpu(P, card)
    for key in ("density_sweep", "density_sweep_veto_off", "scaling"):
        for k, v in legs[key]["launches"].items():
            total[k] += v
    return total


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; there is no CPU run",
              file=sys.stderr)
        return 1
    import bench_torch
    from mono_lidar_depth_tpu_torch import kernels, precision

    name = torch.cuda.get_device_name(0)
    card = bench_torch.card_line(torch.device("cuda"))
    check(precision.fp32_enforced(), "TF32 is not off")
    log(f"phase 1 device: {name}, {torch.cuda.device_count()} visible, "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")
    log(card)

    t0 = time.perf_counter()
    kernels.build()
    info = dict(kernels.build_info)
    for lib in ("windows", "lk_track", "gather_neighbors", "zncc_gate"):
        kernels.library(lib)
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase 2 build: {info['path']} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc, one process per source, {info['seconds']:.2f} s); ptxas: "
        f"{' | '.join(ptxas)}")
    check_no_spills(info["log"], "lk_track.cu")

    from mono_lidar_depth_tpu_torch.io.synthetic_dataset import (
        SyntheticSpec, render_sequence)

    t0 = time.perf_counter()
    seq = render_sequence(SyntheticSpec(frames=IMAGE_FRAMES), seed=SEED)
    render_s = time.perf_counter() - t0

    seconds = {}

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t, 1)
        return out

    kern = timed(3, phase_kernels, card)
    lk = timed("3 lk", phase_lk, card, seq.image(0), seq.image(1))
    gather = timed("3 gather", phase_gather, card)
    gate = timed("3 gate", phase_gate, card, seq.image(0), seq.image(1))
    launches = timed(4, phase_main, card)
    timed(5, phase_agree, card)
    img_launches = timed(6, phase_images, card, seq, render_s)
    seq_launches = timed(7, phase_sequence, card, seq)
    pg_launches = timed(8, phase_posegraph, card)
    dist_launches = timed(9, phase_dist, card)
    bench_launches = timed(10, phase_bench, card)
    end_launches = timed(11, phase_endurance, card)
    par_launches = timed(12, phase_parity, card)

    # Per kernel: `launches` of its main paths' runs (phase 4's
    # feature-fed path, phase 6's image-fed path, phase 7's sequence
    # evaluators, phase 8's loop closure, phase 9's ranks, phase 10's
    # bench, phase 11's endurance run and phase 12's evaluation record
    # (with its subprocesses' own counts), each counted from 0 just before
    # it; the LK passes and the
    # gate run on the image-fed paths only; the window crop is launched by
    # neither any more, so its count is 0, and phase 3 goes on holding it
    # bit-exact and timing it through its public entry point); ms,
    # plain_ms, bound_ms: device time of the kernel's launches in one
    # frame (slice_windows: the 2 ZNCC crops that one track_frame made
    # until the gate took them over; lk_track: the one launch of one
    # track_frame, both passes over all 4 levels; gather_neighbors: the
    # one launch of one odometry step; zncc_gate: the one launch of one
    # track_frame).  library_ms: for slice_windows the indexing gather of
    # the same crops on ready indices, for lk_track grid_sample doing the
    # iterations' patch sampling alone (2 x 4 x 8 calls), for gather_neighbors the four indexing gathers of
    # its crops alone (no decode), for zncc_gate two grid_sample calls
    # doing its patch sampling alone.
    log(json.dumps({"kernels": [
        {"name": "slice_windows", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES,
         "launches": (launches["slice_windows"]
                      + img_launches["slice_windows"]
                      + seq_launches["slice_windows"]
                      + pg_launches["slice_windows"]
                      + end_launches["slice_windows"]
                      + par_launches["slice_windows"]),
         "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
         "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
         "bound_by": "bytes", "library_ms": kern["library_ms"]},
        {"name": "lk_track", "route": "cuda", "source": LK_SOURCE,
         "replaces": REPLACES,
         "launches": (img_launches["lk_track"] + seq_launches["lk_track"]
                      + pg_launches["lk_track"] + end_launches["lk_track"]
                      + par_launches["lk_track"]),
         "max_abs_err": lk["max_abs_err"], "ms": lk["ms"],
         "plain_ms": lk["plain_ms"], "bound_ms": lk["bound_ms"],
         "bound_by": lk["bound_by"], "library_ms": lk["library_ms"]},
        {"name": "gather_neighbors", "route": "cuda", "source": GATHER_SOURCE,
         "replaces": REPLACES,
         "launches": (launches["gather_neighbors"]
                      + img_launches["gather_neighbors"]
                      + seq_launches["gather_neighbors"]
                      + pg_launches["gather_neighbors"]
                      + dist_launches["gather_neighbors"]
                      + bench_launches["gather_neighbors"]
                      + end_launches["gather_neighbors"]
                      + par_launches["gather_neighbors"]),
         "max_abs_err": gather["max_abs_err"], "ms": gather["ms"],
         "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
         "bound_by": gather["bound_by"],
         "library_ms": gather["library_ms"],
         "indices_form": gather["indices_form"]},
        {"name": "zncc_gate", "route": "cuda", "source": GATE_SOURCE,
         "replaces": REPLACES,
         "launches": (img_launches["zncc_gate"] + seq_launches["zncc_gate"]
                      + pg_launches["zncc_gate"] + end_launches["zncc_gate"]
                      + par_launches["zncc_gate"]),
         "max_abs_err": gate["max_abs_err"], "ms": gate["ms"],
         "plain_ms": gate["plain_ms"], "bound_ms": gate["bound_ms"],
         "bound_by": gate["bound_by"], "library_ms": gate["library_ms"]}]}))
    log(f"chip_smoke: seconds per phase {seconds}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
