"""The tracks that the tracklet-depth node is fed, as viso2 feeds LIMO:
persistent feature tracks over the benchmark's scene, made from the
seed on the host.

A fixed set of lanes (the node's `max_features`) each holds one track at
a time.  A track follows a landmark on the scene's ground or walls: each
frame the landmark is projected with the lap's pose and the observation
gets Gaussian pixel noise.  A track ends when its point leaves the image
(or comes nearer than `min_depth_m`), or with the assumed loss per
frame; the lane then takes a new landmark at once, the point seen
through a uniformly drawn pixel of that frame (a pixel on the sky gives
none, and the lane waits a frame).  The pixels of each lap frame are
drawn and cast once, as a pool (`pool` per lap frame) that births take
in turn.  A new track is first emitted in the
frame after its birth, with its birth observation as `uv_prev`; ids
increase in order of birth, lane by lane.

A run replays the tracks of one lap (`make_cycle`), made in set-up, as
it replays the lap's sensor data: each pass takes ids of its own, so at
the start of a pass every track is new, as after a tracker's reset.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import scene


class TrackFrame(NamedTuple):
    ids: np.ndarray  # [M] int32
    valid: np.ndarray  # [M] bool: emitted this frame
    uv_new: np.ndarray  # [M, 2] float32
    uv_prev: np.ndarray  # [M, 2] float32


class TrackStream:
    """Frame after frame of tracks over the cyclic lap."""

    def __init__(self, cfg: dict, seed: int, device="cpu"):
        cam, tr = cfg["camera"], cfg["tracks"]
        self.cam = cam
        self.lanes = cfg["depth_estimator"].get("max_features", 2048)
        self.noise = tr["noise_px"]
        self.loss = tr["loss_per_frame"]
        self.min_depth = tr["min_depth_m"]
        self.margin = tr["border_px"]
        motion = cfg["motion"]
        self.poses = scene.trajectory(motion["lap_frames"], motion["step_m"])
        self.z_end = motion["lap_frames"] * motion["step_m"]
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, 3]))
        N = self.lanes
        self.X = np.zeros((N, 3))
        self.uv = np.zeros((N, 2))
        self.ids = np.full(N, -1, np.int32)
        self.alive = np.zeros(N, bool)
        self.next_id = 0
        self.frame = 0
        self._cast_pools(tr["pool"], device)
        self._spawn(np.ones(N, bool), 0)
        self.frame = 1

    def _project(self, X: np.ndarray, k: int):
        R_wc, c = self.poses[k]
        p = (X - c) @ R_wc  # R_wc^T (X - c), row-wise
        z = p[:, 2]
        safe = np.where(z > 0, z, 1.0)
        f, cx, cy = self.cam["focal"], self.cam["cx"], self.cam["cy"]
        uv = np.stack([f * p[:, 0] / safe + cx, f * p[:, 1] / safe + cy], 1)
        m = self.margin
        inside = ((z > self.min_depth) & (uv[:, 0] >= m)
                  & (uv[:, 0] <= self.cam["width"] - 1 - m)
                  & (uv[:, 1] >= m)
                  & (uv[:, 1] <= self.cam["height"] - 1 - m))
        return uv, inside

    def _cast_pools(self, pool: int, device) -> None:
        """`pool` uniformly drawn pixels of every lap frame, cast once:
        per lap frame the pixels whose ray hits the scene and the hits."""
        m, cam = self.margin, self.cam
        lap = len(self.poses)
        px = np.stack([
            self.rng.uniform(m, cam["width"] - 1 - m, (lap, pool)),
            self.rng.uniform(m, cam["height"] - 1 - m, (lap, pool))], -1)
        d_cam = np.stack([(px[..., 0] - cam["cx"]) / cam["focal"],
                          (px[..., 1] - cam["cy"]) / cam["focal"],
                          np.ones((lap, pool))], -1)
        R = np.stack([r for r, _ in self.poses])
        c = np.stack([c for _, c in self.poses])
        d = np.einsum("kij,kpj->kpi", R, d_cam).reshape(-1, 3)
        o = np.repeat(c, pool, axis=0)
        t, _, _ = scene.cast(torch.from_numpy(o).to(device),
                             torch.from_numpy(d).to(device), self.z_end)
        t = t.cpu().numpy().reshape(lap, pool)
        X = o.reshape(lap, pool, 3) + np.where(
            np.isfinite(t), t, 0.0)[..., None] * d.reshape(lap, pool, 3)
        hit = np.isfinite(t)
        self.pool_px = [px[k][hit[k]] for k in range(lap)]
        self.pool_X = [X[k][hit[k]] for k in range(lap)]
        self.pool_next = np.zeros(lap, np.int64)

    def _spawn(self, lanes: np.ndarray, k: int) -> None:
        """New landmarks for `lanes` from lap frame k's pool."""
        idx = np.nonzero(lanes)[0]
        size = len(self.pool_X[k])
        if len(idx) == 0 or size == 0:
            return
        take = (self.pool_next[k] + np.arange(len(idx))) % size
        self.pool_next[k] += len(idx)
        self.X[idx] = self.pool_X[k][take]
        self.uv[idx] = self.pool_px[k][take] + self.rng.normal(
            0, self.noise, (len(idx), 2))
        self.ids[idx] = self.next_id + np.arange(len(idx), dtype=np.int32)
        self.next_id += len(idx)
        self.alive[idx] = True

    def next(self) -> TrackFrame:
        """The next frame's tracks."""
        k = self.frame % len(self.poses)
        uv, inside = self._project(self.X, k)
        lost = self.rng.random(self.lanes) < self.loss
        keep = self.alive & inside & ~lost
        uv_new = uv + self.rng.normal(0, self.noise, uv.shape)
        out = TrackFrame(ids=self.ids.copy(), valid=keep.copy(),
                         uv_new=np.where(keep[:, None], uv_new,
                                         0.0).astype(np.float32),
                         uv_prev=np.where(keep[:, None], self.uv,
                                          0.0).astype(np.float32))
        self.uv = np.where(keep[:, None], uv_new, self.uv)
        self.alive = keep
        self.ids = np.where(keep, self.ids, -1).astype(np.int32)
        self._spawn(~keep, k)
        self.frame += 1
        return out


class Cycle(NamedTuple):
    """The tracks of stream frames 1 to C (one lap), on the host."""

    ids: np.ndarray  # [C, M] int32
    valid: np.ndarray  # [C, M] bool
    uv_new: np.ndarray  # [C, M, 2] float32
    uv_prev: np.ndarray  # [C, M, 2] float32
    span: int  # the ids one pass takes

    def index(self, f: int) -> tuple[int, int]:
        """(row, id offset) of frame f >= 1 of a run."""
        C = self.ids.shape[0]
        return (f - 1) % C, ((f - 1) // C) * self.span

    def at(self, f: int) -> TrackFrame:
        """Frame f's tracks, ids with their pass's offset (frame 0, the
        primed scan, has none)."""
        if f < 1:
            M = self.ids.shape[1]
            return TrackFrame(np.full(M, -1, np.int32), np.zeros(M, bool),
                              np.zeros((M, 2), np.float32),
                              np.zeros((M, 2), np.float32))
        j, off = self.index(f)
        return TrackFrame(self.ids[j] + np.int32(off), self.valid[j],
                          self.uv_new[j], self.uv_prev[j])


def make_cycle(cfg: dict, seed: int, device="cpu") -> Cycle:
    """One lap of tracks from the seed."""
    stream = TrackStream(cfg, seed, device)
    made = [stream.next() for _ in range(cfg["motion"]["lap_frames"])]
    return Cycle(*(np.stack([getattr(tf, name) for tf in made])
                   for name in TrackFrame._fields), span=stream.next_id)
