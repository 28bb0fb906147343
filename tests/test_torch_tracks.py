"""Track table and the per-frame tracklet-depth step: the port against
the JAX functions.

Bars: match_tracks / update_tracks bit-exact over a randomized sequence
(GC, seeding, overflow, invalid lanes); 4 frames of process_frame from
a mid-sequence JAX state carried over with `state_from_numpy`, with
JAX's RANSAC draws injected: the track tables' ids, ages, lengths, uv
windows and stamps bit-exact, the same depth entries present, and the
depth values within 5e-7 relative (the median difference is 0), but
for entries stored from road-pass depths, which keep the estimator's
5e-3 (`_assert_tables_match`).  The depths are not bit-exact: XLA's CPU
backend contracts a*b+c into fused multiply-adds and turns x / const
into x * (1/const), eager PyTorch does neither, so primary-pass depths
differ in the last ulps (observed <= 3.2e-7), and the road pass's
ill-conditioned fp32 plane fit turns such differences into more
(observed: 1 of 116 entries 1.3e-3 off, from a road-pass depth).  The
rasterization and neighbor stages feeding the estimator are bit-exact
(tests/test_torch_projection_neighbors.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (CAMERA, R_LC, SMALL, T_LC, assert_trees_equal,
                          jax_ransac_draws, to_numpy, to_port)
import mono_lidar_depth_tpu as J
from mono_lidar_depth_tpu.io.kitti import make_synthetic_scan, pad_cloud
from mono_lidar_depth_tpu.tracks import pipeline as JP
from mono_lidar_depth_tpu.tracks import table as JT
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch.convert import state_from_numpy, state_to_numpy
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.tracks import table as TT


def _random_update(rng, M, id_space):
    ids = rng.choice(id_space, M, replace=False).astype(np.int32)
    valid = rng.random(M) < 0.85
    uv_new = rng.uniform(0, 300, (M, 2)).astype(np.float32)
    uv_prev = rng.uniform(0, 300, (M, 2)).astype(np.float32)
    d_new = np.where(rng.random(M) < 0.7, rng.uniform(1, 60, M), -1.0)
    d_prev = np.where(rng.random(M) < 0.7, rng.uniform(1, 60, M), -1.0)
    return (ids, valid, uv_new, uv_prev, d_new.astype(np.float32),
            d_prev.astype(np.float32))


@pytest.mark.parametrize("T_slots,M,id_space", [(64, 48, 80), (32, 48, 64)])
def test_table_updates_bitexact(T_slots, M, id_space):
    """The second case overflows the table (more new tracks than slots)."""
    rng = np.random.default_rng(T_slots)
    jtab = JT.TrackTable.create(T_slots, 6)
    ttab = state_from_numpy(to_numpy(jtab), "cpu")
    for step in range(8):
        ids, valid, uv_new, uv_prev, d_new, d_prev = _random_update(
            rng, M, id_space)
        stamp = np.float32(0.1 * step)
        jm = JT.match_tracks(jtab, jnp.asarray(ids), jnp.asarray(valid))
        tm = TT.match_tracks(ttab, torch.from_numpy(ids),
                             torch.from_numpy(valid))
        assert np.array_equal(tm[0].numpy(), np.asarray(jm[0]))
        assert np.array_equal(tm[1].numpy(), np.asarray(jm[1]))
        jtab, jslot = JT.update_tracks(
            jtab, *map(jnp.asarray, (ids, valid, uv_new, uv_prev, d_new,
                                     d_prev, stamp)), match=jm)
        ttab, tslot = TT.update_tracks(
            ttab, *map(torch.from_numpy, (ids, valid, uv_new, uv_prev, d_new,
                                          d_prev)), torch.tensor(stamp))
        assert_trees_equal(state_to_numpy(ttab), to_numpy(jtab),
                           path=f"step {step}")
        assert np.array_equal(tslot.numpy(), np.asarray(jslot))
    assert (np.asarray(jtab.track_id) >= 0).sum() > T_slots // 2


def _frames(cfg, n, seed):
    """Distinct clouds and drifting tracks; some ids drop out and come
    back, so tracks are both carried and newly seeded."""
    rng = np.random.default_rng(seed)
    M = cfg.max_features
    base = rng.uniform([4, 4], [CAMERA["width"] - 4, CAMERA["height"] - 4],
                       (M, 2))
    uv = np.clip(base[None] + np.cumsum(rng.normal(0, 1.0, (n + 1, M, 2)),
                                        axis=0),
                 [1, 1], [CAMERA["width"] - 2, CAMERA["height"] - 2]
                 ).astype(np.float32)
    out = []
    for k in range(1, n + 1):
        scan = make_synthetic_scan(rng, cfg.max_points - 400)
        cloud, cvalid = pad_cloud(scan, len(scan), cfg.max_points)
        ids_valid = rng.random(M) < 0.9
        out.append(dict(cloud=cloud, cloud_valid=cvalid,
                        ids=np.arange(M, dtype=np.int32),
                        ids_valid=ids_valid, uv_new=uv[k], uv_prev=uv[k - 1],
                        stamp=np.float32(0.1 * k)))
    return out


def _jax_frame(f, key):
    return JP.FrameInput(**{k: jnp.asarray(v) for k, v in f.items()},
                         rng=key)


def _port_frame(cfg, f, key):
    draws = jax_ransac_draws(key, f["cloud_valid"],
                             cfg.ransac_subsample_points,
                             cfg.ransac_num_hypotheses)
    return T.FrameInput(**{k: torch.tensor(v) for k, v in f.items()},
                        rng=RansacDraws(*draws))


def _assert_tables_match(ttab, jtab, road_successes):
    """Bit-exact but for the depths.  A primary-pass depth may differ by
    a few f32 ulps (XLA and torch round the plane-intersection
    arithmetic differently; observed <= 3.2e-7 relative), so every depth
    entry is held within 5e-7, except entries stored from road-pass
    depths, whose fp32 plane fit is ill-conditioned (test_torch_depth's
    float64 witness): at most `road_successes` of them, within 5e-3
    (observed: one entry, 1.3e-3)."""
    ttab, jtab = state_to_numpy(ttab), to_numpy(jtab)
    for name in ("track_id", "age", "length", "uv", "stamps"):
        assert np.array_equal(getattr(ttab, name), getattr(jtab, name)), name
    has = jtab.depth > 0
    assert np.array_equal(ttab.depth > 0, has)
    assert np.array_equal(ttab.depth[~has], jtab.depth[~has])
    rel = np.abs(ttab.depth[has] - jtab.depth[has]) / jtab.depth[has]
    assert np.median(rel) == 0.0 and rel.max() < 5e-3
    assert (rel > 5e-7).sum() <= road_successes


def test_process_frame_four_frames():
    cfg_kw = dict(SMALL)
    jcfg, tcfg = J.DepthEstimatorConfig(**cfg_kw), T.DepthEstimatorConfig(
        **cfg_kw)
    jcam, tcam = J.PinholeCamera(**CAMERA), T.PinholeCamera(**CAMERA)
    jT = J.SE3(jnp.asarray(R_LC), jnp.asarray(T_LC))
    tT = T.SE3(torch.from_numpy(R_LC), torch.from_numpy(T_LC))
    frames = _frames(jcfg, 5, seed=21)
    keys = jax.random.split(jax.random.PRNGKey(2), 6)

    # JAX runs the first frame; the port starts from that state.
    jstate = JP.TrackletDepthState.create(jcfg, cfg_kw["max_features"], 8)
    prime = _frames(jcfg, 1, seed=20)[0]
    jstate = JP.prime_state(jcfg, jcam, jT, jstate,
                            jnp.asarray(prime["cloud"]),
                            jnp.asarray(prime["cloud_valid"]), keys[0])
    jstate, _, _ = JP.process_frame(jcfg, jcam, jT, jstate,
                                    _jax_frame(frames[0], keys[1]))
    tstate = to_port(jstate)
    assert_trees_equal(state_to_numpy(tstate), to_numpy(jstate))

    for k in range(1, 5):
        jstate, jd, jc = JP.process_frame(jcfg, jcam, jT, jstate,
                                          _jax_frame(frames[k], keys[k + 1]))
        tstate, td, tc = T.process_frame(
            tcfg, tcam, tT, tstate, _port_frame(tcfg, frames[k], keys[k + 1]))
        _assert_tables_match(tstate.table, jstate.table,
                             int(np.asarray(jstate.counters)[16]))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert np.array_equal(tstate.counters.numpy(),
                              np.asarray(jstate.counters))
        assert np.array_equal(tstate.gp_last.inlier_mask.numpy(),
                              np.asarray(jstate.gp_last.inlier_mask))
        # The cached frame is the current frame's rasterization.
        assert np.array_equal(tstate.frame_last.grid.numpy(),
                              np.asarray(jstate.frame_last.grid))
    counters = np.asarray(jstate.counters)
    assert counters[1] + counters[16] > 50  # primary and road successes
    assert (np.asarray(jstate.table.length) >= 4).sum() > 100


def test_semantic_frames_raise():
    """A frame with a label image used to raise; now its ground plane
    comes from the label image: an image without a ground label gives no
    plane (ok False), one that is all road gives one, and neither draws
    from the frame's generator."""
    cfg = T.DepthEstimatorConfig(**SMALL)
    f = _frames(cfg, 1, seed=0)[0]
    cam = T.PinholeCamera(**CAMERA)
    l2c = T.SE3(torch.from_numpy(R_LC), torch.from_numpy(T_LC))
    state = T.TrackletDepthState.create(cfg, cfg.max_features, 8, "cpu")
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    for label, ok in ((0, False), (7, True)):
        frame = T.FrameInput(
            **{k: torch.tensor(v) for k, v in f.items()}, rng=gen,
            semantic=torch.full((128, 384), label, dtype=torch.int32))
        new_state, depths, codes = T.process_frame(cfg, cam, l2c, state,
                                                   frame)
        assert bool(new_state.gp_last.ok) == ok
        assert depths.shape == codes.shape == (cfg.max_features,)
    assert torch.equal(gen.get_state(), before)
