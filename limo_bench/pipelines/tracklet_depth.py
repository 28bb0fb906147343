"""The reference's own product, the `tracklet_depth_node` of
`tracklets_depth_ros_tool` on its 4-way-sync path with a semantic image,
in a closed loop: per frame the node takes the lidar scan, the label
image and the tracks (made by `tracks.make_cycle` in set-up, as viso2
makes them for LIMO), runs `process_frame` and publishes the depths,
which are read back with their codes before the next frame is handed
over.

The ground plane comes from the road labels (`fit_ground_plane_semantic`);
the older feature of each new track is estimated against the last cloud,
the newest features against the current one.

The check works each sampled frame out again with `oracle`, from the
sensor data and the tracks alone: the ground planes of the last and the
current scan, the current raster, the depth and code of every emitted
track's newest feature and the depth of every new track's older one. It
compares them with what the port returned and with the port's track
table, raster and ground plane after that frame.  Where no road point
lies under the camera the plane is not ok and no output reads its
inliers, so the raster's ground flags are compared only where it is ok.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import common, oracle, scene
from ..tracks import make_cycle

NUMBERS = ("codes_apart", "depth_apart", "depth_rel", "raster_apart",
           "table_apart")
PREV_REL = 1e-3


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
        self.lap = common.make_lap(cfg, seed, device)
        t1 = time.perf_counter()
        self.stamps = torch.arange(100000, dtype=torch.float32,
                                   device=device) * (1.0 / cfg["lidar"]["rate_hz"])
        self.samples = common.sample_frames(seed, traffic["check_every"],
                                            traffic["check_frames"])
        self.cycle = make_cycle(cfg, seed, device)
        pin = device.type == "cuda"
        self.tracks = [torch.from_numpy(getattr(self.cycle, name))
                       for name in ("ids", "valid", "uv_new", "uv_prev")]
        if pin:
            self.tracks = [t.pin_memory() for t in self.tracks]
        t2 = time.perf_counter()
        self.kept = {}
        self.outputs = []
        cloud0, valid0, sem0 = self._upload_scan(0)
        state = T.TrackletDepthState.create(self.dcfg, cfg["max_tracks"],
                                            cfg["max_length"], device)
        self.state = T.prime_state(self.dcfg, self.cam, self.l2c, state,
                                   cloud0, valid0, self._draws(0),
                                   semantic=sem0)
        self.f = 1
        self.window_start = None
        for _ in range(traffic["warmup_frames"]):
            self.frame()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.outputs.clear()
        self.window_start = self.f
        self.setup_parts = {"lap_s": t1 - t0, "tracks_s": t2 - t1,
                            "warmup_s": time.perf_counter() - t2}

    def _upload_scan(self, f: int):
        k = f % self.lap.labels.shape[0]
        nb = self.dev.type == "cuda"
        return (self.lap.clouds[k].to(self.dev, non_blocking=nb),
                self.lap.valid[k].to(self.dev, non_blocking=nb),
                self.lap.labels[k].to(self.dev, non_blocking=nb))

    def _draws(self, f: int):
        k = f % self.lap.labels.shape[0]
        return (self.lap.sub_idx[k], self.lap.picks[k])

    def frame(self) -> None:
        """One frame of the timed path, its depths and codes read back."""
        T, f = self.T, self.f
        j, off = self.cycle.index(f)
        nb = self.dev.type == "cuda"
        ids, ok, uv_new, uv_prev = (x[j].to(self.dev, non_blocking=nb)
                                    for x in self.tracks)
        cloud, valid, sem = self._upload_scan(f)
        inp = T.FrameInput(cloud=cloud, cloud_valid=valid, ids=ids + off,
                           ids_valid=ok, uv_new=uv_new, uv_prev=uv_prev,
                           stamp=self.stamps[f], rng=self._draws(f),
                           semantic=sem)
        state, depths, codes = T.process_frame(self.dcfg, self.cam, self.l2c,
                                               self.state, inp)
        out = torch.stack([depths, codes.to(depths.dtype)]).cpu()
        if self.window_start is not None:
            self.outputs.append(out)
            if f - self.window_start in self.samples:
                self.kept[f] = (out, state.table, state.frame_last.grid,
                                state.frame_last.planes[0], state.gp_last.ok)
        self.state, self.f = state, f + 1

    def failed(self) -> int:
        """Frames of the window with a depth that is not finite."""
        return sum(int(not torch.isfinite(o).all()) for o in self.outputs)

    def release(self) -> None:
        self.state = None

    def check(self) -> dict:
        """The numbers compared, summed over the sampled frames (the
        largest relative gap: the largest): emitted lanes whose code
        differs; depths set on one side only (returned, and the table's
        newest and seeded entries), or, seeded, more than PREV_REL
        apart; the largest relative gap of the newest depths where the
        codes agree; raster cells whose point differs, or whose ground
        flag differs where the plane is ok, or every occupied cell where
        the plane's ok differs; table entries apart (`_table_depths`)."""
        cfg, p = self.cfg, self.cfg["depth_estimator"]
        c = cfg["camera"]
        cam = oracle.Camera(c["width"], c["height"], c["focal"], c["cx"],
                            c["cy"])
        R, t32 = scene.R_CL, scene.T_CL.astype(np.float32)
        lap = self.lap.labels.shape[0]
        L = cfg["max_length"]
        made = {}

        def ref_frame(f):
            k = f % lap
            if k not in made:
                if len(made) > 4:
                    made.clear()
                made[k] = oracle.frame(
                    self.lap.clouds[k].numpy(), self.lap.valid[k].numpy(),
                    self.lap.labels[k].numpy(), cam, R, t32, p)
            return made[k]

        total = dict.fromkeys(NUMBERS, 0.0)
        for f in sorted(self.kept):
            out, table, grid, zplane, plane_ok = self.kept[f]
            now, before = self.cycle.at(f), self.cycle.at(f - 1)
            lanes = now.valid
            is_new = lanes & ~np.isin(now.ids, before.ids[before.valid])
            cur, last = ref_frame(f), ref_frame(f - 1)
            d_new, c_new = oracle.depths(cur, cam, now.uv_new, lanes, p)
            d_old, _ = oracle.depths(last, cam, now.uv_prev, is_new, p)

            d, codes = out[0].numpy(), out[1].numpy().astype(np.int64)
            same = lanes & (codes == c_new)
            total["codes_apart"] += float((lanes & ~same).sum())
            table_d, table_apart = _table_depths(table, now, is_new, L,
                                                 self.cycle, f)
            total["table_apart"] += float(table_apart)
            # The newest features' depths where the codes agree; the older
            # features' codes are not returned, so a depth of theirs more
            # than PREV_REL apart counts as apart.
            for got in (d, table_d[0]):
                total["depth_apart"] += float(
                    (lanes & ((got > 0) != (d_new > 0))).sum())
                both = same & (got > 0) & (d_new > 0)
                if both.any():
                    rel = np.abs(got[both] - d_new[both]) / d_new[both]
                    total["depth_rel"] = max(total["depth_rel"],
                                             float(rel.max()))
            got, want = table_d[1][is_new], d_old[is_new]
            both = (got > 0) & (want > 0)
            total["depth_apart"] += float(
                ((got > 0) != (want > 0)).sum()
                + (np.abs(got[both] - want[both]) > PREV_REL * want[both])
                .sum())
            r = cur.raster
            g = grid.cpu().numpy()
            apart = g != r.grid
            if bool(plane_ok) != cur.plane_ok:
                apart |= g >= 0
            elif cur.plane_ok:
                apart |= (zplane.cpu().numpy() < 0) != r.flag
            total["raster_apart"] += float(apart.sum())
        total["frames_checked"] = float(len(self.kept))
        return total


def _table_depths(table, now, is_new, L: int, cycle, f: int):
    """The port's track table after frame f, read for the emitted lanes:
    (depths of the newest and of the previous entry [2, M], -1 where
    the lane's track is missing), and the count of entries apart from
    what the frame's tracks make: lanes whose track is missing, slots
    held by a track not emitted, newest and seeded positions that are
    not the frame's, lengths that are not the frames the track was seen
    plus its seed (at most L)."""
    M = len(now.ids)
    tid = table.track_id.cpu().numpy()
    length = table.length.cpu().numpy()
    uv = table.uv.cpu().numpy()
    depth = table.depth.cpu().numpy()
    lanes = now.valid
    active = tid >= 0
    order = np.argsort(tid)
    pos = np.clip(np.searchsorted(tid[order], now.ids), 0, len(tid) - 1)
    slot = order[pos]
    found = lanes & (tid[slot] == now.ids) & active[slot]
    apart = int((lanes & ~found).sum())
    apart += abs(int(active.sum()) - int(found.sum()))
    seen = np.ones(M, np.int64)  # frames the track was emitted, up to f
    alive = lanes.copy()
    for g in range(f - 1, max(f - L, 0), -1):
        then = cycle.at(g)
        alive &= then.valid & (then.ids == now.ids)
        seen += alive
    want_len = np.minimum(seen + 1, L)
    s = slot[found]
    apart += int((length[s] != want_len[found]).sum())
    apart += int((uv[s, 0] != now.uv_new[found]).any(-1).sum())
    seeded = found & is_new
    apart += int((uv[slot[seeded], 1] != now.uv_prev[seeded]).any(-1).sum())
    out = np.full((2, M), -1.0)
    out[0, found] = depth[s, 0]
    out[1, found] = depth[s, 1]
    return out, apart
