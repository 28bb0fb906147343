#!/usr/bin/env python3
"""Where the time of the full-size odometry step, of the tracker's
`track_frame` and of the two optional depth configurations goes, on one
CUDA GPU.

    python3 profile_step.py [TARGET ...]

TARGET is any of TARGETS (odometry, track_frame, options, closure,
pose_graph), each described below; no TARGET profiles them all, in that
order.  To set two trees side by side in one session, copy this script
into the root of the other tree (a `git archive` unpacked into a
git-ignored directory) and run it there too, in turns: it then profiles
that tree's package with this script's plan.

First the odometry step.  Runs the port's main path on chip_smoke.py's scene (the reference
defaults at the KITTI size, bench.py's synthetic clouds and tracks) for
11 steps after `prime_state`:

  * steps 1-4 warm up;
  * steps 5-8 run alone, timed with CUDA events (no profiler, no extra
    syncs): the step median;
  * steps 9-11 run under torch.profiler, again with no extra syncs:
    the device's busy time per step (every kernel, copy and fill),
    device activities per step, and for each stage of the step its host
    time and the device time of the kernels it launched.

The idle share is 1 - busy / step median, against the unprofiled median.
Stages are labelled by wrapping the functions the step calls (in
tracks/pipeline.py and vo/pipeline.py) for the profiled steps only.

Then the image path: 12 frames of the synthetic sequence at the KITTI
size (chip_smoke.py's phase 6 settings) are rendered and moved to the
card, `init_tracker` runs on the first, and `track_frame` on the others
with the same plan (4 warm, 4 timed alone, 3 profiled), its stages being
`build_pyramid`, `track_features` (the one `lk_track` launch of both LK
passes and the one `zncc_gate` launch), `detect_features`, and the lane
bookkeeping that remains.

Then the optional configurations, on the same rendered frames with their
scans in Velodyne order (io/synthetic_dataset.VelodyneOrder) and the tracker's
outputs made beforehand: `odometry_step` with the defaults and then with
`do_use_depth_segmentation=True` (stages `segment_rows`, `grow_regions`,
the two `estimate_depths_from_frame` passes), and `process_frame` with
the RANSAC plane and then with the semantic plane (stage
`fit_ground_plane_semantic`), each with the same plan, so that the device
time and the activities that a configuration adds can be read off.

Last the loop-closure backend: `closure_constraint_from_frames` on the
first candidate pair of chip_smoke.py's 220-frame loop (the device call of
each direction and its stages: corners, pyramids, KLT, RANSAC, depths,
pose GN), and one Gauss-Newton iteration of `optimize_pose_graph` on
chip_smoke.py's 4541-pose graph (stages: linearization, chain blocks, the
factorization scan, the scans' products, PCG), with the plan PG_PLAN.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

import bench_torch
import chip_smoke as cs

TARGETS = ("odometry", "track_frame", "options", "closure", "pose_graph")
WARM, TIMED, PROFILED = 4, 4, 3
# The pose graph at KITTI-00 scale: one GN iteration per call, fewer calls
# (a call launches ~400,000 kernels).
PG_PLAN = (1, 2, 1)
# (module, function, label): the stages of one odometry step.
STAGES = [("tracks", "_ground_plane", "ransac"),
          ("tracks", "rasterize_cloud", "rasterize"),
          ("tracks", "match_tracks", "match_tracks"),
          ("tracks", "estimate_depths_pair", "depth_pair"),
          ("tracks", "update_tracks", "update_tracks"),
          ("vo", "estimate_pose_gn", "pose_gn"),
          ("vo", "run_ba", "window_ba")]


# What the optional configurations add to the stages of a step.
OPTION_STAGES = STAGES + [
    ("tracks", "fit_ground_plane_semantic", "fit_ground_plane_semantic"),
    ("depth", "estimate_depths_from_frame", "depths_from_frame"),
    ("depth", "segment_rows", "segment_rows"),
    ("depth", "grow_regions", "grow_regions")]
# Stages that run inside `depth_pair`: shown, not added to the stages' sum.
NESTED = {"depths_from_frame", "segment_rows", "grow_regions"}

# The stages of one GN iteration of `optimize_pose_graph`
# (vo/pose_graph.py): the factorization scan and the scans' products are
# made inside the preconditioner, the PCG applies it.
PG_STAGES = [("pg", "_linearize", "linearize"),
             ("pg", "_chain_blocks", "chain_blocks"),
             ("pg", "_chain_factor", "factorization_scan"),
             ("pg", "_scan_plan", "scan_products"),
             ("pg", "_pcg", "pcg")]

# The stages of one closure verification pair (vo/closures.py): per
# direction the device call and its pieces; the host reads, the
# acceptance and the covariance are what remains.
CLOSURE_STAGES = [("closures", "_closure_pose_device", "closure_device"),
                  ("closures", "detect_features", "closure_detect"),
                  ("closures", "build_pyramid", "closure_pyramids"),
                  ("closures", "track_features", "closure_klt"),
                  ("closures", "fit_ground_plane_ransac", "closure_ransac"),
                  ("closures", "estimate_depths", "closure_depths"),
                  ("closures", "estimate_pose_gn", "closure_pose_gn")]
NESTED |= {label for *_, label in CLOSURE_STAGES[1:]}

# The stages of one track_frame (all called from tracker/frontend.py).
TRACK_STAGES = [("frontend", "build_pyramid", "build_pyramid"),
                ("frontend", "track_features", "track_features"),
                ("frontend", "detect_features", "detect_features")]


@contextlib.contextmanager
def labelled_stages(stages=STAGES):
    """Wrap each stage function in a profiler range named after it."""
    import torch
    from mono_lidar_depth_tpu_torch.core import depth_estimator as depth
    from mono_lidar_depth_tpu_torch.tracker import frontend
    from mono_lidar_depth_tpu_torch.tracks import pipeline as tracks
    from mono_lidar_depth_tpu_torch.vo import closures
    from mono_lidar_depth_tpu_torch.vo import pipeline as vo
    from mono_lidar_depth_tpu_torch.vo import pose_graph as pg

    modules = {"tracks": tracks, "vo": vo, "frontend": frontend,
               "depth": depth, "pg": pg, "closures": closures}
    saved, missing = [], []
    for mod_name, fn_name, label in stages:
        mod = modules[mod_name]
        fn = getattr(mod, fn_name, None)
        if fn is None:  # a stage this tree does not have
            missing.append(f"{mod.__name__}.{fn_name}")
            continue
        saved.append((mod, fn_name, fn))

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)

        setattr(mod, fn_name, wrapped)
    if missing:
        print(f"stages not in this tree, not profiled: {missing}")
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def profile_calls(what: str, call, stages, card: str,
                  plan=(WARM, TIMED, PROFILED)) -> None:
    """`plan` = (warm, timed, profiled): warm calls of `call()`, timed
    calls alone under CUDA events, then profiled calls under
    torch.profiler with `stages` labelled; prints the median, the
    device's busy and idle share and the stage table."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    WARM, TIMED, PROFILED = plan
    for _ in range(WARM):
        call()
    events = []
    for _ in range(TIMED):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    call_ms = [a.elapsed_time(b) for a, b in events]
    median = float(np.median(call_ms))

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with labelled_stages(stages), profile(activities=acts) as prof:
        for _ in range(PROFILED):
            call()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    labels = {label for *_, label in stages}
    # Device activities: CUDA rows other than the ranges' own annotations.
    dev_rows = [e for e in rows
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.key not in labels]
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e3 / PROFILED
    n_dev = sum(e.count for e in dev_rows) / PROFILED

    print(f"{what}, {TIMED} calls alone (CUDA events): "
          f"median {median:.3f} ms, all {[round(x, 3) for x in call_ms]} "
          f"[{card}]")
    print(f"profiled calls: device busy {busy:.3f} ms/call, "
          f"{n_dev:.0f} device activities/call; idle share against the "
          f"unprofiled median {1 - busy / median:.3f} [{card}]")
    print("stage | calls/call | host ms/call | device ms/call")
    staged = 0.0
    for _, _, label in stages:
        row = next((e for e in rows if e.key == label
                    and e.device_type == torch.autograd.DeviceType.CPU), None)
        if row is None:
            print(f"{label} | 0 | - | -")
            continue
        dev_ms = row.device_time_total / 1e3 / PROFILED
        if label in NESTED:
            label += " (nested)"
        else:
            staged += dev_ms
        print(f"{label} | {row.count / PROFILED:g} | "
              f"{row.cpu_time_total / 1e3 / PROFILED:.3f} | {dev_ms:.3f}")
    print(f"device time inside the stages: {staged:.3f} of {busy:.3f} "
          f"ms/call")
    print("top device activities by time (ms/call, count/call):")
    for e in sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / PROFILED:8.3f} "
              f"{e.count / PROFILED:6.0f}  {e.key[:90]}")


def main() -> int:
    import torch
    import mono_lidar_depth_tpu_torch as T
    from mono_lidar_depth_tpu_torch.eval.kitti_eval import _dev_img

    targets = sys.argv[1:] or list(TARGETS)
    unknown = sorted(set(targets) - set(TARGETS))
    if unknown:
        print(f"profile_step: unknown targets {unknown}; choose from "
              f"{TARGETS}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    card = bench_torch.card_line(torch.device("cuda"))
    calls = WARM + TIMED + PROFILED
    dev = torch.device("cuda")
    cfg = T.DepthEstimatorConfig(do_use_depth_segmentation=False)
    ocfg = T.OdometryConfig()
    print(f"profile_step: {targets} [{card}]")

    if "odometry" in targets:
        sc = cs.bench_scene(frames=calls)
        state = cs.prime(sc)
        frames = iter(sc.inputs)

        def step():
            nonlocal state
            state, *_ = T.odometry_step(sc.cfg, sc.ocfg, sc.cam,
                                        sc.lidar_to_cam, state, next(frames))

        profile_calls("odometry step", step, STAGES, card)

    seq = T.render_sequence(T.SyntheticSpec(frames=calls + 1), seed=cs.SEED)
    if "track_frame" in targets:
        imgs = iter([_dev_img(torch.from_numpy(seq.image(i)).to(dev))
                     for i in range(len(seq))])
        tstate = T.init_tracker(next(imgs), cfg.max_features,
                                levels=cs.LEVELS)

        def track():
            nonlocal tstate
            tstate, _ = T.track_frame(tstate, next(imgs))

        print()
        profile_calls(f"track_frame ({cfg.max_features} lanes, {cs.LEVELS} "
                      f"levels, {seq.camera.width}x{seq.camera.height})",
                      track, TRACK_STAGES, card)
    if "options" in targets:
        profile_options(T, seq, cfg, ocfg, dev, card)
    if "closure" in targets:
        from mono_lidar_depth_tpu_torch.vo import closures

        loop = T.render_sequence(T.SyntheticSpec(
            frames=cs.LOOP_FRAMES, step=0.55, loop=True), seed=cs.SEED)
        i, j = closures.propose_loop_closures(loop.gt_poses,
                                              **cs.LOOP_PROPOSE)[0]

        def verify():
            closures.closure_constraint_from_frames(
                loop, cfg, i, j, max_features=cfg.max_features, device=dev)

        print()
        profile_calls(f"closure_constraint_from_frames, frames {i} and {j} "
                      f"of the {cs.LOOP_FRAMES}-frame loop (both directions, "
                      f"{loop.camera.width}x{loop.camera.height})", verify,
                      CLOSURE_STAGES, card)
    if "pose_graph" in targets:
        from mono_lidar_depth_tpu_torch.vo import pose_graph as pg

        graph = cs.kitti00_graph(dev)

        def gn_iteration():
            pg.optimize_pose_graph(graph, gn_iters=1, cg_iters=cs.PG_CG_ITERS)

        print()
        profile_calls(f"optimize_pose_graph, one GN iteration at "
                      f"{cs.KITTI00_POSES} poses (cg_iters={cs.PG_CG_ITERS})",
                      gn_iteration, PG_STAGES, card, plan=PG_PLAN)
    print(card)
    return 0


def profile_options(T, seq, cfg, ocfg, dev, card) -> None:
    """The optional configurations on the rendered frames, their scans in
    Velodyne order and the tracker's outputs made beforehand."""
    from mono_lidar_depth_tpu_torch.io.synthetic_dataset import VelodyneOrder

    vseq = VelodyneOrder(seq)
    l2c = seq.lidar_to_cam(dev)
    prime: list = []
    inputs = [f for f, _ in T.frame_inputs(
        vseq, cfg, prime=prime, pyramid_levels=cs.LEVELS,
        use_semantics=True, device=dev, seed=cs.SEED)]
    cloud0, valid0, sem0 = prime[0]
    cfg_rg = T.DepthEstimatorConfig(do_use_depth_segmentation=True)

    def odometry_on(c):
        state = T.OdometryState.create(c, ocfg, c.max_features, 12, dev)
        state = state._replace(tracklets=T.prime_state(
            c, seq.camera, l2c, state.tracklets, cloud0, valid0,
            torch_generator(dev)))
        it = iter(inputs)

        def step():
            nonlocal state
            state, *_ = T.odometry_step(
                c, ocfg, seq.camera, l2c, state,
                next(it)._replace(semantic=None))
        return step

    def process_on(semantic: bool):
        state = T.TrackletDepthState.create(cfg, cfg.max_features, 12, dev)
        state = T.prime_state(
            cfg, seq.camera, l2c, state, cloud0, valid0, torch_generator(dev),
            semantic=sem0 if semantic else None)
        it = iter(inputs)

        def step():
            nonlocal state
            frame = next(it)
            state, *_ = T.process_frame(
                cfg, seq.camera, l2c, state,
                frame if semantic else frame._replace(semantic=None))
        return step

    for what, call in (
            ("odometry step on the rendered frames, defaults",
             odometry_on(cfg)),
            ("odometry step on the rendered frames, region growing on",
             odometry_on(cfg_rg)),
            ("process_frame on the rendered frames, RANSAC plane",
             process_on(False)),
            ("process_frame on the rendered frames, semantic plane",
             process_on(True))):
        print()
        profile_calls(what, call, OPTION_STAGES, card)


def torch_generator(dev):
    import torch

    return torch.Generator(device=dev).manual_seed(cs.SEED)


if __name__ == "__main__":
    sys.exit(main())
