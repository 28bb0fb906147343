#!/usr/bin/env python
"""KITTI odometry evaluation CLI of the PyTorch port (counterpart of
scripts/run_kitti.py).

Usage:
  python scripts/run_kitti_torch.py depth --root /data/kitti --seq 04
  python scripts/run_kitti_torch.py vo --root /data/kitti --seq 00 [--frames N]
  python scripts/run_kitti_torch.py posegraph --root /data/kitti --seq 00
  python scripts/run_kitti_torch.py selftest    # synthetic end-to-end check

Everything runs on `--device` (default: CUDA device 0; `--device cpu` runs
the plain PyTorch versions on the CPU).  Sequence 99 is the built-in
synthetic sequence, generated under --root on demand (that needs Pillow).
`--checkpoint PATH` saves the VO carry after a `vo` run and resumes from
it when the file exists.  Results print as one JSON line per run.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["depth", "vo", "posegraph", "selftest"])
    ap.add_argument("--root", default="/data/kitti")
    ap.add_argument("--seq", default="04")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--config", default=None, help="parameters yaml path")
    ap.add_argument("--checkpoint", default=None,
                    help="npz checkpoint path to save/restore VO state")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA device 0)")
    args = ap.parse_args(argv)

    import torch

    from mono_lidar_depth_tpu_torch import DepthEstimatorConfig
    from mono_lidar_depth_tpu_torch.device import default_device

    device = torch.device(args.device) if args.device else default_device()
    if args.config:
        cfg = DepthEstimatorConfig.from_yaml(args.config)
    else:
        cfg = DepthEstimatorConfig()

    if args.mode == "selftest":
        _selftest(device)
        return

    from mono_lidar_depth_tpu_torch.io.kitti import KittiSequence

    root = Path(args.root)
    if not (root / "sequences" / args.seq).exists() and args.seq == "99":
        from mono_lidar_depth_tpu_torch.io.synthetic_dataset import (
            SyntheticSpec, generate_kitti_sequence)
        print(f"generating synthetic sequence 99 under {root} ...")
        generate_kitti_sequence(str(root), "99",
                                SyntheticSpec(frames=args.frames or 30))
    seq = KittiSequence(args.root, args.seq)

    if args.mode == "depth":
        from mono_lidar_depth_tpu_torch.eval import eval_depth_sequence

        out = eval_depth_sequence(seq, cfg, max_frames=args.frames,
                                  device=device)
        print(json.dumps({k: v for k, v in out.items()
                          if isinstance(v, (int, float))}))
    elif args.mode == "vo":
        out = _vo(seq, cfg, args, device)
        print(json.dumps({k: v for k, v in out.items()
                          if isinstance(v, (int, float))}))
    elif args.mode == "posegraph":
        from mono_lidar_depth_tpu_torch.eval import (
            eval_vo_sequence, propose_loop_closures,
            propose_loop_closures_appearance, run_pose_graph_backend,
            union_closure_candidates)
        from mono_lidar_depth_tpu_torch.eval.kitti_eval import (
            closure_constraint_from_frames)
        from mono_lidar_depth_tpu_torch.vo.metrics import ate_rmse

        vo = eval_vo_sequence(seq, cfg, max_frames=args.frames,
                              device=device)
        poses = vo["poses"]
        # budget scales with sequence length (~1 candidate / 25 frames);
        # the union of the metric and the appearance proposers
        budget = int(np.clip(len(poses) // 25, 20, 200))
        cands = union_closure_candidates(
            propose_loop_closures(poses, max_candidates=budget),
            propose_loop_closures_appearance(
                seq, [int(f) for f in vo["frame_ids"]],
                max_candidates=budget // 2))

        def measure(a, b):
            return closure_constraint_from_frames(
                seq, cfg, vo["frame_ids"][a], vo["frame_ids"][b],
                device=device)

        closures = []
        for (i, j) in cands:
            z = measure(i, j)
            if z is not None:
                closures.append((i, j, *z))
        print(f"loop closures: {len(closures)}/{len(cands)} verified")
        opt = run_pose_graph_backend(poses, closures, remeasure=measure,
                                     device=device)
        result = {"frames": len(poses), "closures": len(closures)}
        if seq.gt_poses is not None:
            gt = seq.gt_poses[vo["frame_ids"]]
            result["ate_vo"] = ate_rmse(poses[:, :3, 3], gt[:, :3, 3])
            result["ate_posegraph"] = ate_rmse(opt[:, :3, 3], gt[:, :3, 3])
        print(json.dumps(result))


def _vo(seq, cfg, args, device) -> dict:
    """`eval_vo_sequence`; with --checkpoint, resumed from the file when it
    exists and the carry saved to it afterwards."""
    import torch

    from mono_lidar_depth_tpu_torch import (OdometryConfig, OdometryState,
                                            eval_vo_sequence, init_tracker,
                                            load_checkpoint, save_checkpoint)

    kw = dict(max_frames=args.frames, device=device)
    if args.checkpoint and Path(args.checkpoint).exists():
        cam = seq.camera
        fresh = (init_tracker(torch.zeros((cam.height, cam.width),
                                          device=device),
                              cfg.max_features, levels=4),
                 OdometryState.create(cfg, OdometryConfig(), 2048, 12,
                                      device))
        carry, meta = load_checkpoint(args.checkpoint, fresh)
        kw.update(start_frame=int(meta["next_frame"]), init_carry=carry)
        print(f"resuming at frame {kw['start_frame']} from "
              f"{args.checkpoint}")
    out = eval_vo_sequence(seq, cfg, return_carry=bool(args.checkpoint),
                           **kw)
    if args.checkpoint:
        next_frame = out["frame_ids"][-1] + 1
        save_checkpoint(args.checkpoint, out.pop("carry"),
                        {"next_frame": next_frame})
        out["next_frame"] = next_frame
    return out


# ---- selftest: a synthetic metric world, built with the port's code ----

M = 256  # track lanes
P = 8192  # padded cloud
R_LC = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float32)


def _world(rng):
    """World points (= frame-0 camera frame): the ground 1.5 m below the
    camera, facades flanking the road and one far ahead."""
    n_g = 3000
    ground = np.stack([rng.uniform(-12, 12, n_g),
                       1.5 + 0.01 * rng.normal(size=n_g),
                       rng.uniform(2, 80, n_g)], 1)
    parts = [ground]
    for side in (-8.0, 8.0):
        n_w = 1500
        parts.append(np.stack([side + 0.02 * rng.normal(size=n_w),
                               rng.uniform(-4, 1.3, n_w),
                               rng.uniform(2, 80, n_w)], 1))
    n_f = 1000
    parts.append(np.stack([rng.uniform(-8, 8, n_f), rng.uniform(-4, 1.3, n_f),
                           85.0 + 0.02 * rng.normal(size=n_f)], 1))
    return np.concatenate(parts).astype(np.float32)


def _frames(rng, F, device):
    """FrameInputs of a camera driving 1 m per frame with a slight yaw
    (persistent landmark tracks, 0.2 px noise) and the ground-truth
    camera centres of the processed frames."""
    import torch

    from mono_lidar_depth_tpu_torch.tracks.pipeline import FrameInput
    from mono_lidar_depth_tpu_torch.vo.lie import so3_exp

    world = _world(rng)
    lm = world[rng.choice(len(world), M, replace=False)]
    dR = so3_exp(torch.tensor([0.0, 0.01, 0.0])).numpy().astype(np.float64)
    R_wc, c = np.eye(3), np.zeros(3)
    frames, centres, prev = [], [], None
    for f in range(F):
        R_cw, t_cw = R_wc.T, -R_wc.T @ c
        cloud = np.zeros((P, 3), np.float32)
        p_lid = (world @ R_cw.T + t_cw) @ R_LC
        n = min(len(p_lid), P)
        cloud[:n] = p_lid[:n]
        cvalid = np.arange(P) < n
        l_cam = lm @ R_cw.T + t_cw
        z = np.maximum(l_cam[:, 2], 1e-3)
        uv = (np.stack([500 * l_cam[:, 0] / z + 320,
                        500 * l_cam[:, 1] / z + 240], 1)
              + rng.normal(0, 0.2, (M, 2))).astype(np.float32)
        vis = ((l_cam[:, 2] > 1) & (uv[:, 0] > 2) & (uv[:, 0] < 638)
               & (uv[:, 1] > 2) & (uv[:, 1] < 478))
        if prev is not None:
            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            frames.append(FrameInput(
                cloud=dev(cloud), cloud_valid=dev(cvalid),
                ids=dev(np.arange(M, dtype=np.int32)),
                ids_valid=dev(vis & prev[1]), uv_new=dev(uv),
                uv_prev=dev(prev[0]),
                stamp=dev(np.asarray(f, np.float32)),
                rng=torch.Generator(device=device).manual_seed(f)))
            centres.append(c.copy())
        prev = (uv, vis)
        R_wc = R_wc @ dR
        c = c + R_wc @ np.array([0.0, 0.0, 1.0])
    return frames, np.stack(centres)


def _selftest(device) -> None:
    """Synthetic end-to-end check: odometry on a metric world, then the
    pose-graph backend over its trajectory."""
    import torch

    from mono_lidar_depth_tpu_torch import (SE3, DepthEstimatorConfig,
                                            OdometryConfig, PinholeCamera,
                                            run_odometry)
    from mono_lidar_depth_tpu_torch.eval import run_pose_graph_backend
    from mono_lidar_depth_tpu_torch.vo.metrics import ate_rmse

    print("building synthetic odometry scene...")
    cfg = DepthEstimatorConfig(
        max_points=P, max_features=M, image_width=640, image_height=480,
        ransac_num_hypotheses=256, ransac_subsample_points=2048,
        do_use_ransac_plane=True)
    cam = PinholeCamera(width=640, height=480, focal_length=500.0,
                        cx=320.0, cy=240.0)
    l2c = SE3(torch.from_numpy(R_LC).to(device),
              torch.zeros(3, device=device))
    frames, gt_centres = _frames(np.random.default_rng(7), 12, device)
    poses, _ = run_odometry(cfg, OdometryConfig(ba_window=5, ba_iters=5),
                            cam, l2c, frames, max_tracks=M, max_length=8,
                            device=device)
    est = poses[:, :3, 3]
    # the first processed frame's motion is unobservable (no previous
    # depths): compare after the 3-frame transient, as the reference does
    rmse = ate_rmse(est[3:] - est[3], gt_centres[3:] - gt_centres[3])
    print(f"VO ATE (steady-state): {rmse:.3f} m")
    opt = run_pose_graph_backend(poses, [], device=device)
    finite = bool(np.isfinite(opt).all())
    print(f"pose-graph (odometry-only) finite: {finite}")
    print(json.dumps({"selftest_ate": rmse, "ok": bool(rmse < 0.2)
                      and finite}))


if __name__ == "__main__":
    main()
