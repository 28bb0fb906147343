"""Image-fed odometry over a sequence (counterpart of the frame-input
part of eval/kitti_eval.py).

    grey images + lidar scans  ->  tracker  ->  FrameInput  ->  poses

`_frame_inputs` drives the internal tracker on a sequence's images and
pads its scans; `eval_vo_sequence` runs `odometry_step` on every frame it
yields and scores the trajectory against the sequence's ground truth.  A
sequence is anything with `len`, `scans(max_points)`, `image(i)`,
`times`, `camera`, `lidar_to_cam(device)` and `gt_poses`
(io.synthetic_dataset.SyntheticSequence).

The JAX package evaluates long sequences in chunks of frames, each one
scanned device program, and adds loop closures and a pose graph; those
are not ported.  The semantic ground plane is not ported either:
`use_semantics=True` raises.

RANSAC randomness: the JAX harness splits one PRNG key per frame; here
every frame carries the same `torch.Generator` on the device, seeded
once, which the frames consume in order.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..config import DepthEstimatorConfig
from ..device import Device, default_device
from ..io.kitti import pad_cloud
from ..tracker.frontend import init_tracker, track_frame
from ..tracks.pipeline import _NO_SEMANTIC, FrameInput, prime_state
from ..vo.metrics import ate_rmse, rpe_stats
from ..vo.pipeline import OdometryConfig, OdometryState, odometry_step


def _load_payload(seq, cfg: DepthEstimatorConfig, f: int, xyzi, count,
                  use_semantics: bool):
    """The per-frame payload: padded cloud, its valid mask, UINT8
    grayscale image, and no semantic labels.

    Images ship as uint8 and are normalized to [0, 1] f32 on the device
    (`_dev_img`): a quarter of the bytes over the host link."""
    if use_semantics:
        raise NotImplementedError(_NO_SEMANTIC)
    cloud, cvalid = pad_cloud(xyzi, count, cfg.max_points)
    img = seq.image(f)
    if img is None:
        raise FileNotFoundError(f"the sequence has no image for frame {f}")
    img = np.ascontiguousarray(img)  # uint8 [H, W]
    return cloud, cvalid, img, None


def _dev_img(img: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W] -> [0, 1] f32, on device (see _load_payload)."""
    return img.to(torch.float32) / 255.0


def _frame_inputs(seq, cfg: DepthEstimatorConfig,
                  max_frames: Optional[int] = None,
                  prime: Optional[list] = None,
                  pyramid_levels: int = 4,
                  use_semantics: bool = False,
                  device: Device = default_device(),
                  rng: Optional[torch.Generator] = None,
                  ) -> Iterator[tuple[FrameInput, int]]:
    """Generator of (FrameInput, frame index) over a sequence, driving
    the internal tracker on the grayscale images.  Frame 0 initializes
    the tracker; if `prime` is a list, its padded cloud is appended to
    it so the caller can prime the tracklet state (see
    tracks.pipeline.prime_state).  `rng` is the RANSAC generator every
    frame carries (on `device`; seeded with 0 when not given)."""
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    tracker_state = None
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    for f, (xyzi, count) in enumerate(seq.scans(cfg.max_points)):
        if f >= n:
            break
        cloud, cvalid, img, sem = _load_payload(
            seq, cfg, f, xyzi, count, use_semantics)
        cloud = torch.from_numpy(cloud).to(device)
        cvalid = torch.from_numpy(cvalid).to(device)
        dimg = _dev_img(torch.from_numpy(img).to(device))
        if tracker_state is None:
            tracker_state = init_tracker(dimg, cfg.max_features,
                                         levels=pyramid_levels)
            if prime is not None:
                prime.append((cloud, cvalid, sem))
            continue
        tracker_state, out = track_frame(tracker_state, dimg)
        stamp = float(seq.times[f]) if seq.times is not None else float(f)
        yield FrameInput(
            cloud=cloud, cloud_valid=cvalid,
            ids=out.ids, ids_valid=out.valid,
            uv_new=out.uv_new, uv_prev=out.uv_prev,
            stamp=torch.tensor(stamp, dtype=torch.float32, device=device),
            rng=rng, semantic=sem), f


def eval_vo_sequence(seq, cfg: DepthEstimatorConfig,
                     ocfg: OdometryConfig = OdometryConfig(),
                     max_frames: Optional[int] = None,
                     max_tracks: int = 2048, max_length: int = 12,
                     verbose: bool = True,
                     device: Device = default_device(),
                     seed: int = 0) -> dict:
    """Full VO + sliding-window BA over a sequence, frame by frame;
    ATE/RPE against the ground truth where the sequence has one.

    Returns frames, poses [F, 4, 4] (world←cam, frames 1..), frame_ids,
    diag [F, 3] and, with ground truth, ate_rmse, ate_rmse_scaled,
    rpe_trans_rmse, rpe_rot_rmse_deg."""
    cam, l2c = seq.camera, seq.lidar_to_cam(device)
    rng = torch.Generator(device=device).manual_seed(seed)
    state = OdometryState.create(cfg, ocfg, max_tracks, max_length, device)
    primed = False
    prime: list = []
    Rs, ts, diags, frame_ids = [], [], [], []
    for frame, f in _frame_inputs(seq, cfg, max_frames, prime=prime,
                                  pyramid_levels=4, device=device, rng=rng):
        if not primed:
            cloud0, cvalid0, _ = prime[0]
            state = state._replace(tracklets=prime_state(
                cfg, cam, l2c, state.tracklets, cloud0, cvalid0, rng))
            primed = True
        state, R_cw, t_cw, diag = odometry_step(cfg, ocfg, cam, l2c, state,
                                                frame)
        Rs.append(R_cw)
        ts.append(t_cw)
        diags.append(diag)
        frame_ids.append(f)
    if not Rs:
        raise ValueError("the sequence has fewer than two frames")
    R = torch.stack(Rs).cpu().numpy().astype(np.float64)
    t = torch.stack(ts).cpu().numpy().astype(np.float64)
    F = R.shape[0]
    poses = np.tile(np.eye(4), (F, 1, 1))
    poses[:, :3, :3] = R.transpose(0, 2, 1)
    poses[:, :3, 3] = -np.einsum("fij,fj->fi", R.transpose(0, 2, 1), t)
    out = {"frames": F, "poses": poses, "frame_ids": frame_ids,
           "diag": torch.stack(diags).cpu().numpy()}
    if getattr(seq, "gt_poses", None) is not None:
        gt = seq.gt_poses[frame_ids]
        out["ate_rmse"] = ate_rmse(poses[:, :3, 3], gt[:, :3, 3])
        out["ate_rmse_scaled"] = ate_rmse(poses[:, :3, 3], gt[:, :3, 3],
                                          with_scale=True)
        out.update({f"rpe_{k}": v
                    for k, v in rpe_stats(poses, gt).items()})
        if verbose:
            print(f"ATE RMSE: {out['ate_rmse']:.3f} m "
                  f"(scale-aligned {out['ate_rmse_scaled']:.3f} m); "
                  f"RPE trans {out['rpe_trans_rmse']:.3f} m "
                  f"rot {out['rpe_rot_rmse_deg']:.3f} deg")
    return out
