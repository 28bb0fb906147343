"""LIMO's odometry stream, in a closed loop: per frame one vehicle's grey
image, lidar scan and road labels go to the card from pinned host
memory; the port's tracker (`track_frame`) follows its features into
the image, and `odometry_step` associates lidar depth to the tracks
(`process_frame`, the ground plane from the road labels), estimates the
frame's motion (pose Gauss-Newton, its retry, the acceptance gates)
and refines the window (bundle adjustment); the pose and its
diagnostics are read back before the next frame is handed over.  The
lap is replayed cyclically; it closes exactly, so the image stream
never jumps.

The port is called through the package's attributes (`track_frame`,
`odometry_step`), so the harness's wrappers see the calls.  At each
sampled frame the cell keeps references to the tracker's state before
and after the frame and its output, the odometry state before and
after, what `process_frame` returned inside the step, and whether the
pose retry ran (the calls of `estimate_pose_gn` that the step made):
the port is functional, so holding them costs memory and no copies.

The check runs, for each sampled frame, `oracle_odometry` (a plain
float64 reference written apart from the port) one step from the
port's own state before that frame, and `oracle` on the port's tracks
for the depth association; `Cell.check` says what it compares.
"""

from __future__ import annotations

import inspect
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import common, oracle, scene
from .. import oracle_odometry as ref

NUMBERS = ("lanes_apart", "track_px", "births_apart", "codes_apart",
           "depth_rel", "inliers_apart", "accept_apart", "rot_deg",
           "trans_m", "rot_deg_sparse", "trans_m_sparse")


class Kept(NamedTuple):
    """What a sampled frame leaves for the check (references only)."""

    tracker_before: object  # TrackerState
    tracker_out: object  # TrackerOutput
    tracker_after: object  # TrackerState
    odometry_before: object  # OdometryState
    odometry_after: object  # OdometryState
    assoc: tuple  # (TrackletDepthState, depths, codes) of process_frame
    gn_calls: int  # estimate_pose_gn calls in the step: 2 with a retry
    host: torch.Tensor  # R_cw [9], t_cw [3], diag [3] as read back


def render_images(cfg: dict, device) -> torch.Tensor:
    """The lap's grey images [F, H, W] uint8 in host memory (pinned on a
    card), rendered on `device` by the scene's own renderer with no
    lidar rays: the images take nothing from the seed."""
    motion = cfg["motion"]
    lap = motion["lap_frames"]
    d_cam = scene.pixel_rays(cfg["camera"], device)
    no_rays = torch.zeros((0, 3), dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    imgs = torch.stack([
        scene.render_frame(cfg, pose, d_cam, no_rays,
                           lap * motion["step_m"], gen).image
        for pose in scene.trajectory(lap, motion["step_m"])])
    pin = isinstance(device, torch.device) and device.type == "cuda"
    return torch.empty(imgs.shape, dtype=imgs.dtype,
                       pin_memory=pin).copy_(imgs)


def _defaults_hold(T, tr: dict) -> None:
    """`track_frame` takes the cell size, patch and iterations; the other
    tracker settings the configuration states are the port's defaults,
    which are checked here."""
    want = {(T.tracker.klt.track_features, "min_det"): tr["min_det"],
            (T.tracker.klt.track_features, "min_ncc"): tr["min_ncc"],
            (T.tracker.klt.track_features, "fb_threshold"):
                tr["fb_threshold"],
            (T.tracker.harris.detect_features, "min_response"):
                tr["min_response"],
            (T.tracker.harris.detect_features, "border"): tr["border"]}
    for (fn, name), value in want.items():
        got = inspect.signature(fn).parameters[name].default
        if got != value:
            raise SystemExit(f"limo_bench: the configuration states "
                             f"{name} = {value}, the port uses {got}")


class Cell:
    """Set-up on construction (its parts' seconds in `setup_parts`);
    `frame()` runs one timed frame; `check()` compares the sampled frames
    with the reference."""

    def __init__(self, T, cfg: dict, traffic: dict, seed: int, device,
                 seconds: float):
        t0 = time.perf_counter()
        self.T, self.cfg, self.dev = T, cfg, device
        self.dcfg = common.depth_config(T, cfg)
        self.cam = common.camera(T, cfg)
        self.l2c = common.lidar_to_cam(T, device)
        self.ocfg = T.OdometryConfig(**cfg["odometry"])
        self.tr = tr = cfg["tracker"]
        if tr["max_features"] != self.dcfg.max_features:
            raise SystemExit("limo_bench: the tracker's lanes are the "
                             "association's features")
        _defaults_hold(T, tr)
        self.vo = T.vo.pipeline  # where odometry_step finds its stages
        self.lap = common.make_lap(cfg, seed, device)
        self.images = render_images(cfg, device)
        t1 = time.perf_counter()
        period = 1.0 / cfg["lidar"]["rate_hz"]
        self.stamps = torch.arange(100000, dtype=torch.float32,
                                   device=device) * period
        self.samples = common.sample_frames(seed, traffic["check_every"],
                                            traffic["check_frames"])
        self.kept = {}
        self.outputs = []
        self.ts = T.init_tracker(self._upload_image(0), tr["max_features"],
                                 levels=tr["pyramid_levels"],
                                 cell_size=tr["cell_size"])
        cloud0, valid0, sem0 = self._upload_scan(0)
        state = T.OdometryState.create(self.dcfg, self.ocfg, cfg["max_tracks"],
                                       cfg["max_length"], device)
        self.os = state._replace(tracklets=T.prime_state(
            self.dcfg, self.cam, self.l2c, state.tracklets, cloud0, valid0,
            self._draws(0), semantic=sem0))
        self.f = 1
        self.window_start = None
        for _ in range(traffic["warmup_frames"]):
            self.frame()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.outputs.clear()
        self.window_start = self.f
        self.setup_parts = {"lap_s": t1 - t0,
                            "warmup_s": time.perf_counter() - t1}

    def _upload_image(self, f: int) -> torch.Tensor:
        k = f % self.images.shape[0]
        img = self.images[k].to(self.dev, non_blocking=self.dev.type == "cuda")
        return img.to(torch.float32) / 255.0

    def _upload_scan(self, f: int):
        k = f % self.lap.labels.shape[0]
        nb = self.dev.type == "cuda"
        return (self.lap.clouds[k].to(self.dev, non_blocking=nb),
                self.lap.valid[k].to(self.dev, non_blocking=nb),
                self.lap.labels[k].to(self.dev, non_blocking=nb))

    def _draws(self, f: int):
        k = f % self.lap.labels.shape[0]
        return (self.lap.sub_idx[k], self.lap.picks[k])

    def _step(self, inp):
        return self.T.odometry_step(self.dcfg, self.ocfg, self.cam,
                                    self.l2c, self.os, inp)

    def _observed_step(self, inp):
        """The step, with what `process_frame` returned inside it and the
        calls of `estimate_pose_gn` seen: the module's two attributes are
        wrapped for this one call and put back."""
        vo = self.vo
        process_frame, estimate_pose_gn = vo.process_frame, vo.estimate_pose_gn
        seen = {"assoc": None, "gn_calls": 0}

        def seen_process_frame(*args, **kw):
            seen["assoc"] = process_frame(*args, **kw)
            return seen["assoc"]

        def seen_estimate_pose_gn(*args, **kw):
            seen["gn_calls"] += 1
            return estimate_pose_gn(*args, **kw)

        vo.process_frame = seen_process_frame
        vo.estimate_pose_gn = seen_estimate_pose_gn
        try:
            result = self._step(inp)
        finally:
            vo.process_frame = process_frame
            vo.estimate_pose_gn = estimate_pose_gn
        return result, seen

    def frame(self) -> None:
        """One frame of the timed path, its pose and diagnostics read
        back."""
        T, f, tr = self.T, self.f, self.tr
        img = self._upload_image(f)
        cloud, valid, sem = self._upload_scan(f)
        ts, out = T.track_frame(self.ts, img, cell_size=tr["cell_size"],
                                patch=tr["patch"], iters=tr["iters"])
        inp = T.FrameInput(cloud=cloud, cloud_valid=valid, ids=out.ids,
                           ids_valid=out.valid, uv_new=out.uv_new,
                           uv_prev=out.uv_prev, stamp=self.stamps[f],
                           rng=self._draws(f), semantic=sem)
        sampled = (self.window_start is not None
                   and f - self.window_start in self.samples)
        if sampled:
            (os, R_cw, t_cw, diag), seen = self._observed_step(inp)
        else:
            os, R_cw, t_cw, diag = self._step(inp)
        host = torch.cat([R_cw.reshape(9), t_cw, diag]).cpu()
        if self.window_start is not None:
            self.outputs.append(host)
            if sampled:
                self.kept[f] = Kept(self.ts, out, ts, self.os, os,
                                    seen["assoc"], seen["gn_calls"], host)
        self.ts, self.os, self.f = ts, os, f + 1

    def failed(self) -> int:
        """Frames of the window with a pose or diagnostic that is not
        finite."""
        return sum(int(not torch.isfinite(o).all()) for o in self.outputs)

    def release(self) -> None:
        self.ts = self.os = None

    def check(self) -> dict:
        """The numbers compared, summed over the sampled frames (the
        `_px`, `_rel`, `_deg` and `_m` numbers: their largest):

          * `lanes_apart`: lanes whose survival or emit flag differs from
            the reference's tracker step, or whose id or previous
            position the output does not pass through;
          * `track_px`: where both keep a lane, the largest gap of its
            tracked position (the output's, the state's) and of its flow;
          * `births_apart`: lanes that a detection took on one side only,
            or on both at another position or id (the reference detects
            around the port's survivors), and the gap of the next id;
          * `codes_apart`, `depth_rel`: `oracle` on the port's tracks:
            emitted lanes whose code differs, and the largest relative
            gap of their depths where the codes agree;
          * `inliers_apart`: the gap of the motion tracks and of the GN's
            inliers in the returned diagnostics;
          * `accept_apart`: frames whose retry (a second GN call) or
            acceptance (the state's last motion replaced) differs, or
            whose ring, frame count or motion flag differs;
          * `rot_deg`, `trans_m`: the largest gap of the returned pose,
            of every window pose after the BA and of the last motion, over
            the frames whose BA holds 3 x `min_motion_tracks` landmarks or
            more (the count the program trusts a motion from);
            `rot_deg_sparse`, `trans_m_sparse`: the same over the other
            frames.  With a handful of landmarks the window is barely
            posed and 6 iterations leave it far from converged, so float32
            arithmetic moves the result by tenths of a degree: the
            reference's own float32 run did as much on such a frame."""
        cfg, p = self.cfg, self.cfg["depth_estimator"]
        c = cfg["camera"]
        cam = oracle.Camera(c["width"], c["height"], c["focal"], c["cx"],
                            c["cy"])
        rcam = ref.Camera(float(c["focal"]), float(c["cx"]), float(c["cy"]))
        R, t32 = scene.R_CL, scene.T_CL.astype(np.float32)
        tr = self.tr
        params = ref.TrackerParams(**{k: tr[k]
                                      for k in ref.TrackerParams._fields})
        oparams = ref.OdometryParams(**cfg["odometry"])
        lap = self.images.shape[0]
        dev = self.dev
        total = dict.fromkeys(NUMBERS, 0.0)
        for f in sorted(self.kept):
            kp = self.kept[f]
            a, b, out = kp.tracker_before, kp.tracker_after, kp.tracker_out

            # the tracker
            step = ref.tracker_step(
                ref.grey(self.images[(f - 1) % lap].to(dev)),
                ref.grey(self.images[f % lap].to(dev)),
                ref.TrackerIn(a.uv, a.ids, a.age, a.valid, int(a.next_id),
                              a.flow),
                tr["pyramid_levels"], params,
                occupied=(out.uv_new, b.age >= 2))
            survived = (b.age >= 2).to(dev)
            total["lanes_apart"] += float(
                (survived != step.survived).sum()
                + (out.valid.to(dev) != step.emit).sum()
                + (out.ids != a.ids).sum()
                + (out.uv_prev != a.uv).any(1).sum())
            both = survived & step.survived
            if both.any():
                gaps = [(x.to(dev, torch.float64) - y)[both].norm(dim=1).max()
                        for x, y in ((out.uv_new, step.uv_f),
                                     (b.uv, step.uv_f),
                                     (b.flow, step.flow))]
                total["track_px"] = max(total["track_px"],
                                        float(torch.stack(gaps).max()))
            born = (b.age == 1).to(dev)
            same = born & step.born
            total["births_apart"] += float(
                (born != step.born).sum()
                + (same & ((b.uv.to(dev, torch.float64) != step.uv).any(1)
                           | (b.ids.to(dev, torch.int64) != step.ids))).sum()
                + abs(int(b.next_id) - step.next_id))

            # the depth association, on the port's tracks
            k = f % lap
            cur = oracle.frame(self.lap.clouds[k].numpy(),
                               self.lap.valid[k].numpy(),
                               self.lap.labels[k].numpy(), cam, R, t32, p)
            lanes = out.valid.cpu().numpy()
            d_ref, c_ref = oracle.depths(cur, cam, out.uv_new.cpu().numpy(),
                                         lanes, p)
            _, depths, codes = kp.assoc
            d, codes = depths.cpu().numpy(), codes.cpu().numpy()
            agree = lanes & (codes.astype(np.int64) == c_ref)
            total["codes_apart"] += float((lanes & ~agree).sum())
            pos = agree & (d > 0) & (d_ref > 0)
            if pos.any():
                rel = np.abs(d[pos] - d_ref[pos]) / d_ref[pos]
                total["depth_rel"] = max(total["depth_rel"], float(rel.max()))

            # the odometry tail, from the port's table and state
            table = kp.assoc[0].table
            o0, o1 = kp.odometry_before, kp.odometry_after
            vo = ref.odometry_tail(
                rcam, ref.Table(table.track_id, table.length, table.uv,
                                table.depth),
                ref.OdometryIn(o0.win_R, o0.win_t, o0.win_valid,
                               int(o0.frame_idx), o0.rel_R, o0.rel_t,
                               bool(o0.motion_ok)), oparams, device=dev)
            host = kp.host.to(torch.float64)
            total["inliers_apart"] += (abs(float(host[12]) - vo.n_usable)
                                       + abs(float(host[13]) - vo.n_inliers))
            accepted = not (torch.equal(o1.rel_R, o0.rel_R)
                            and torch.equal(o1.rel_t, o0.rel_t))
            total["accept_apart"] += float(
                ((kp.gn_calls == 2) != vo.retry) or accepted != vo.accepted
                or int(o1.frame_idx) != vo.frame_idx
                or bool(o1.motion_ok) != vo.motion_ok
                or not torch.equal(o1.win_valid.to(dev), vo.win_valid))
            posed = vo.n_landmarks >= 3 * oparams.min_motion_tracks
            rot, trans = (("rot_deg", "trans_m") if posed else
                          ("rot_deg_sparse", "trans_m_sparse"))
            pairs = [(host[:9].reshape(3, 3).to(dev), host[9:12].to(dev),
                      vo.R_cw, vo.t_cw),
                     (o1.win_R, o1.win_t, vo.win_R, vo.win_t),
                     (o1.rel_R, o1.rel_t, vo.rel_R, vo.rel_t)]
            for Rp, tp, Rr, trf in pairs:
                Rp = Rp.to(dev, torch.float64)
                total[rot] = max(total[rot], float(
                    ref.angle_deg(Rp, Rr).max()))
                total[trans] = max(total[trans], float(
                    (tp.to(dev, torch.float64) - trf).norm(dim=-1).max()))
        total["frames_checked"] = float(len(self.kept))
        return total
