"""Sequence evaluators (counterpart of eval/kitti_eval.py; its
loop-closure backend lives in vo/closures.py and is re-exported here
under the reference's names):

    grey images + lidar scans  ->  tracker  ->  FrameInput  ->  depth
    association statistics (`eval_depth_sequence`) or poses
    (`eval_vo_sequence`)

A sequence is anything with `len`, `scans(max_points)`, `image(i)`,
`semantic(i)`, `times`, `camera`, `lidar_to_cam(device)` and `gt_poses`:
io.kitti.KittiSequence on disk, io.synthetic_dataset.SyntheticSequence in
memory.

`_frame_inputs` is the per-frame generator.  The evaluators work in chunks of
`_CHUNK_FRAMES` frames, which bounds host and device memory: a background
thread reads and stacks the next chunk (host work only) while the main
thread moves the current chunk's arrays to the device, once per array, and
loops over its frames, calling `track_frame` and `process_frame` /
`odometry_step` on views of the staged tensors.  The JAX package runs a
chunk as one scanned device program; PyTorch has no scan, so the loop is
Python and every frame's kernels are launched from the host.  Chunking is
an execution detail: counters and poses are the same to the bit for every
chunk size and for the per-frame loop over `_frame_inputs`.

RANSAC randomness is indexed by the absolute frame number: frame f draws
from a generator seeded with `_frame_seed(seed, f)`, and `prime_state`
from frame 0's slot, which no processed frame uses.  So a run resumed
from a checkpoint (`start_frame`, `init_carry`) draws what the
uninterrupted run drew.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import DepthEstimatorConfig
from ..device import Device, default_device
from ..io.kitti import pad_cloud
from ..obs.stats import DepthCalcStats, format_stats_report, success_rates
from ..tracker.frontend import init_tracker, track_frame
from ..tracks.pipeline import (FrameInput, TrackletDepthState, prime_state,
                               process_frame)
from ..vo.closures import (  # noqa: F401  (the reference's names)
    closure_constraint_from_frames, filter_consistent_closures,
    propose_loop_closures, propose_loop_closures_appearance,
    run_pose_graph_backend, union_closure_candidates)
from ..vo.metrics import ate_rmse, rpe_stats
from ..vo.pipeline import OdometryConfig, OdometryState, odometry_step

# Frames per staged chunk in the chunked evaluators.  Bounds host and device
# memory to O(chunk) frames: at the defaults a frame is a 1.57 MB cloud, a
# 0.13 MB mask, a 0.45 MB image and, in semantic mode, 1.81 MB of labels.
_CHUNK_FRAMES = 256
_PYRAMID_LEVELS = 4  # the tracker's pyramid in the chunked evaluators


def _frame_seed(seed: int, f: int) -> int:
    """The seed of frame f's RANSAC generator, a function of (seed, f)
    alone (numpy's SeedSequence mixes the two words)."""
    return int(np.random.SeedSequence([seed, f]).generate_state(
        1, np.uint64)[0])


def _frame_rng(frame_seed: int, device: Device) -> torch.Generator:
    """A generator on `device` seeded for one frame.  Seeding is host
    work: it does not synchronize with the card."""
    return torch.Generator(device=device).manual_seed(frame_seed)


def _load_payload(seq, cfg: DepthEstimatorConfig, f: int, xyzi, count,
                  use_semantics: bool):
    """The one per-frame payload protocol (padded cloud, its valid mask,
    UINT8 grayscale image, int32 semantic labels or None) shared by the
    per-frame generator and the chunked evaluators.

    Images ship as uint8 and are normalized to [0, 1] f32 on the device
    (`_dev_img`): a quarter of the bytes over the host link."""
    cloud, cvalid = pad_cloud(xyzi, count, cfg.max_points)
    name = getattr(seq, "sequence", "")
    img = seq.image(f)
    if img is None:
        raise FileNotFoundError(
            f"sequence {name} has no image for frame {f}")
    img = np.ascontiguousarray(img)  # uint8 [H, W]
    sem = None
    if use_semantics:
        sem = seq.semantic(f)
        if sem is None:
            raise FileNotFoundError(
                f"sequence {name} has no semantic labels for frame {f}: "
                f"the semantic plane mode needs them")
        sem = sem.astype(np.int32)
    return cloud, cvalid, img, sem


def _dev_img(img: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W] -> [0, 1] f32, on device (see _load_payload)."""
    return img.to(torch.float32) / 255.0


def _prefetch_iter(gen, depth: int = 1):
    """Run a generator in a background thread with a bounded queue: the
    host-side preparation of the next chunk (PNG decode, scan reads,
    stacking) overlaps the device work of the current one.  The thread
    touches no device.

    If the consumer abandons the iterator (an exception in the eval loop,
    or an explicit .close()), the worker must not stay parked on a full
    queue holding a staged chunk: a cancellation flag is checked around
    every blocking put, and the consumer's finally-block sets it, drains
    the queue and closes the source generator."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    cancelled = threading.Event()

    def put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # propagate into the consumer
            put(e)
        finally:
            gen.close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancelled.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:  # pragma: no cover
                break
        t.join(timeout=5.0)


def _frame_inputs(seq, cfg: DepthEstimatorConfig,
                  max_frames: Optional[int] = None,
                  prime: Optional[list] = None,
                  pyramid_levels: int = 4,
                  use_semantics: bool = False,
                  device: Device = default_device(),
                  seed: int = 0,
                  ) -> Iterator[tuple[FrameInput, int]]:
    """Generator of (FrameInput, frame index) over a sequence, driving
    the internal tracker on the grayscale images.  Frame 0 initializes
    the tracker; if `prime` is a list, its padded cloud (and labels) are
    appended to it so the caller can prime the tracklet state (see
    tracks.pipeline.prime_state).  With `use_semantics` the sequence's
    label images ride along as int32 tensors; a sequence without them
    raises FileNotFoundError.  Frame f carries its own RANSAC generator,
    seeded with `_frame_seed(seed, f)`."""
    tracker_state = None
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    for f, (xyzi, count) in enumerate(seq.scans(cfg.max_points)):
        if f >= n:
            break
        cloud, cvalid, img, sem = _load_payload(
            seq, cfg, f, xyzi, count, use_semantics)
        cloud = torch.from_numpy(cloud).to(device)
        cvalid = torch.from_numpy(cvalid).to(device)
        if sem is not None:
            sem = torch.from_numpy(sem).to(device)
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
            rng=_frame_rng(_frame_seed(seed, f), device), semantic=sem), f


def _stack_chunks(seq, cfg: DepthEstimatorConfig, max_frames: Optional[int],
                  use_semantics: bool, chunk: Optional[int] = None,
                  start_frame: int = 0, seed: int = 0):
    """Yield a sequence as dense per-frame chunks for the chunked evaluators:
    (dict of host arrays covering frames [start, start + C), start).
    Frame 0 (tracker init, state prime) rides in the first chunk.
    Per-frame payloads come from `_load_payload`, the same protocol as
    `_frame_inputs`; seeds[k] belongs to frame start + k.

    `start_frame` starts chunking mid-sequence for checkpoint/resume:
    stamps and seeds stay indexed by the absolute frame number, so a
    resumed run sees the per-frame inputs of the uninterrupted run."""
    if chunk is None:
        chunk = _CHUNK_FRAMES  # resolved at call time (tests override)
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    stamps_all = (np.asarray(seq.times[:n], np.float32)
                  if seq.times is not None
                  else np.arange(n, dtype=np.float32))
    imgs, clouds, cvalids, sems = [], [], [], []
    start = start_frame

    def flush(stop):
        out = {
            "images": np.stack(imgs),
            "clouds": np.stack(clouds),
            "cvalids": np.stack(cvalids),
            "sems": np.stack(sems) if use_semantics else None,
            "stamps": stamps_all[start:stop],
            "seeds": [_frame_seed(seed, f) for f in range(start, stop)],
        }
        imgs.clear(), clouds.clear(), cvalids.clear(), sems.clear()
        return out

    for f, (xyzi, count) in enumerate(seq.scans(cfg.max_points)):
        if f >= n:
            break
        if f < start_frame:
            continue
        cloud, cvalid, img, sem = _load_payload(
            seq, cfg, f, xyzi, count, use_semantics)
        imgs.append(img)
        clouds.append(cloud)
        cvalids.append(cvalid)
        if use_semantics:
            sems.append(sem)
        if len(imgs) == chunk:
            yield flush(f + 1), start
            start = f + 1
    if imgs:
        yield flush(start + len(imgs)), start


def _chunk_xs(arrs, skip_first: bool, with_sem: bool,
              device: Device = default_device()) -> dict:
    """Per-frame inputs of one chunk on `device`: each array moved once;
    skip_first drops the tracker-init/prime frame of the first chunk.
    The seeds stay on the host."""
    s = 1 if skip_first else 0
    xs = {"img": torch.from_numpy(arrs["images"][s:]).to(device),
          "cloud": torch.from_numpy(arrs["clouds"][s:]).to(device),
          "cvalid": torch.from_numpy(arrs["cvalids"][s:]).to(device),
          "stamp": torch.from_numpy(
              np.ascontiguousarray(arrs["stamps"][s:])).to(device),
          "seed": arrs["seeds"][s:]}
    if with_sem:
        xs["sem"] = torch.from_numpy(arrs["sems"][s:]).to(device)
    return xs


def _chunk_frame(xs: dict, k: int, out, with_sem: bool) -> FrameInput:
    """Frame k of a staged chunk, on views of its tensors."""
    return FrameInput(
        cloud=xs["cloud"][k], cloud_valid=xs["cvalid"][k],
        ids=out.ids, ids_valid=out.valid,
        uv_new=out.uv_new, uv_prev=out.uv_prev,
        stamp=xs["stamp"][k],
        rng=_frame_rng(xs["seed"][k], xs["cloud"].device),
        semantic=xs["sem"][k] if with_sem else None)


def _scan_depth_chunk(cfg, camera, lidar_to_cam, carry, xs,
                      with_sem: bool = False):
    """One staged chunk of frames of depth association."""
    tstate, dstate = carry
    for k in range(len(xs["seed"])):
        tstate, out = track_frame(tstate, _dev_img(xs["img"][k]))
        dstate, _, _ = process_frame(cfg, camera, lidar_to_cam, dstate,
                                     _chunk_frame(xs, k, out, with_sem))
    return tstate, dstate


def _scan_vo_chunk(cfg, ocfg, camera, lidar_to_cam, carry, xs):
    """One staged chunk of frames of VO + window BA; returns the carry
    and per-frame (R_cw [C, 3, 3], t_cw [C, 3], diag [C, 3])."""
    tstate, ostate = carry
    Rs, ts, diags = [], [], []
    for k in range(len(xs["seed"])):
        tstate, out = track_frame(tstate, _dev_img(xs["img"][k]))
        ostate, R_cw, t_cw, diag = odometry_step(
            cfg, ocfg, camera, lidar_to_cam, ostate,
            _chunk_frame(xs, k, out, False))
        Rs.append(R_cw)
        ts.append(t_cw)
        diags.append(diag)
    dev = xs["cloud"].device

    def stack(rows, *shape):
        return (torch.stack(rows) if rows
                else torch.zeros((0, *shape), device=dev))

    return (tstate, ostate), (stack(Rs, 3, 3), stack(ts, 3), stack(diags, 3))


def _first_carry(seq, cfg, arrs, with_sem: bool, state, device, seed: int):
    """The carry before the first processed frame: the tracker on frame
    0's image, and `state` (TrackletDepthState) primed with its cloud."""
    sem0 = (torch.from_numpy(arrs["sems"][0]).to(device) if with_sem
            else None)
    state = prime_state(
        cfg, seq.camera, seq.lidar_to_cam(device), state,
        torch.from_numpy(arrs["clouds"][0]).to(device),
        torch.from_numpy(arrs["cvalids"][0]).to(device),
        _frame_rng(_frame_seed(seed, 0), device), semantic=sem0)
    tracker = init_tracker(
        _dev_img(torch.from_numpy(arrs["images"][0]).to(device)),
        cfg.max_features, levels=_PYRAMID_LEVELS)
    return tracker, state


def eval_depth_sequence(seq, cfg: DepthEstimatorConfig,
                        max_frames: Optional[int] = None,
                        max_tracks: int = 4096, max_length: int = 12,
                        verbose: bool = True,
                        plane_mode: str = "ransac",
                        device: Device = default_device(),
                        seed: int = 0) -> dict:
    """Depth-augmented tracklets over a sequence; returns the outcome
    statistics dict (success rates, frames, counters).

    plane_mode: "ransac", or "semantic": the ground plane comes from the
    sequence's semantic label images."""
    if plane_mode not in ("ransac", "semantic"):
        raise ValueError(f"unknown plane_mode {plane_mode!r}")
    with_sem = plane_mode == "semantic"
    cam, l2c = seq.camera, seq.lidar_to_cam(device)
    carry = None
    n = 0
    for arrs, start in _prefetch_iter(
            _stack_chunks(seq, cfg, max_frames, with_sem, seed=seed)):
        n = start + len(arrs["images"])
        if carry is None:
            carry = _first_carry(
                seq, cfg, arrs, with_sem, TrackletDepthState.create(
                    cfg, max_tracks, max_length, device), device, seed)
        carry = _scan_depth_chunk(
            cfg, cam, l2c, carry,
            _chunk_xs(arrs, start == 0, with_sem, device), with_sem=with_sem)
    if carry is None:
        raise ValueError("the sequence has no frames")
    counters = carry[1].counters
    frames = n - 1
    host = counters.cpu().numpy()
    out = success_rates(host)
    out["frames"] = frames
    out["counters"] = host.tolist()
    if verbose:
        stats = DepthCalcStats.zeros(device)._replace(
            accumulated=counters, frames=torch.tensor(frames))
        print(format_stats_report(stats))
    return out


def measure_depth_device_time(seq, cfg: DepthEstimatorConfig,
                              max_frames: Optional[int] = None,
                              max_tracks: int = 4096,
                              max_length: int = 12,
                              device: Device = default_device(),
                              seed: int = 0) -> dict:
    """Time of the depth-association loop alone: every chunk is staged on
    the device first, one run warms up, and a second one is timed: with
    CUDA events on a card (the span between the first launch and the end
    of the last kernel, host launch time included), with the host clock
    on the CPU."""
    device = torch.device(device)
    cam, l2c = seq.camera, seq.lidar_to_cam(device)
    staged = []
    carry0 = None
    for arrs, start in _stack_chunks(seq, cfg, max_frames, False, seed=seed):
        if carry0 is None:
            carry0 = _first_carry(
                seq, cfg, arrs, False, TrackletDepthState.create(
                    cfg, max_tracks, max_length, device), device, seed)
        staged.append(_chunk_xs(arrs, start == 0, False, device))
    if carry0 is None:
        raise ValueError("the sequence has no frames")

    def run():
        carry = carry0
        for xs in staged:
            carry = _scan_depth_chunk(cfg, cam, l2c, carry, xs)
        return carry

    run()  # warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize(device)
        dt = t0.elapsed_time(t1) / 1e3
    else:
        start_s = time.perf_counter()
        run()
        dt = time.perf_counter() - start_s
    n = sum(len(xs["seed"]) for xs in staged)
    return {"device_s": dt, "frames": n,
            "device_ms_per_frame": 1e3 * dt / max(n, 1)}


def eval_vo_sequence(seq, cfg: DepthEstimatorConfig,
                     ocfg: OdometryConfig = OdometryConfig(),
                     max_frames: Optional[int] = None,
                     max_tracks: int = 2048, max_length: int = 12,
                     verbose: bool = True,
                     start_frame: int = 0,
                     init_carry=None,
                     return_carry: bool = False,
                     device: Device = default_device(),
                     seed: int = 0) -> dict:
    """Full VO + sliding-window BA over a sequence, in chunks; ATE/RPE
    against the ground truth where the sequence has one.

    Returns frames, poses [F, 4, 4] (world<-cam, frames 1..), frame_ids,
    diag [F, 3] and, with ground truth, ate_rmse, ate_rmse_scaled,
    rpe_trans_rmse, rpe_rot_rmse_deg.

    Checkpoint/resume: `return_carry=True` adds the final (tracker,
    odometry) carry as `out["carry"]` (snapshot it with
    io.checkpoint.save_checkpoint); resume with `start_frame=<next frame>`
    and `init_carry=<restored carry>`.  Stamps and RANSAC seeds are
    indexed by the absolute frame number, so the resumed run equals the
    uninterrupted one to the bit."""
    if (start_frame > 0) != (init_carry is not None):
        raise ValueError("start_frame and init_carry go together")
    cam, l2c = seq.camera, seq.lidar_to_cam(device)
    carry = init_carry
    n = 0
    Rs, ts, diags = [], [], []
    for arrs, start in _prefetch_iter(
            _stack_chunks(seq, cfg, max_frames, use_semantics=False,
                          start_frame=start_frame, seed=seed)):
        n = start + len(arrs["images"])
        if carry is None:
            state = OdometryState.create(cfg, ocfg, max_tracks, max_length,
                                         device)
            tracker, tracklets = _first_carry(seq, cfg, arrs, False,
                                              state.tracklets, device, seed)
            carry = (tracker, state._replace(tracklets=tracklets))
        carry, (Rc, tc, dc) = _scan_vo_chunk(
            cfg, ocfg, cam, l2c, carry,
            _chunk_xs(arrs, start == 0, False, device))
        Rs.append(Rc.cpu().numpy())
        ts.append(tc.cpu().numpy())
        diags.append(dc.cpu().numpy())
    if not Rs or sum(len(r) for r in Rs) == 0:
        raise ValueError("the sequence has fewer than two frames")
    R = np.concatenate(Rs).astype(np.float64)
    t = np.concatenate(ts).astype(np.float64)
    F = R.shape[0]
    poses = np.tile(np.eye(4), (F, 1, 1))
    poses[:, :3, :3] = R.transpose(0, 2, 1)
    poses[:, :3, 3] = -np.einsum("fij,fj->fi", R.transpose(0, 2, 1), t)
    frame_ids = list(range(max(1, start_frame), n))
    out = {"frames": F, "poses": poses, "frame_ids": frame_ids,
           "diag": np.concatenate(diags)}
    if return_carry:
        out["carry"] = carry
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
