"""The semantic ground plane and the tracklet step in semantic mode: the
port against the JAX functions on the CPU.

Bars: `fit_ground_plane_semantic` on the same points, mask and label
image: `ok` equal, `coeffs` within 1e-4, `inlier_mask` equal on every
point farther than 1e-4 from `inlier_threshold`; `SyntheticSequence.
semantic(i)` equal to the PNG the writer puts on disk; `process_frame`
with a label image has no random draws, so the track table is bit-exact
over a short sequence but for the depths (held as in
tests/test_torch_tracks.py) and at least 99.9% of the codes agree;
`process_sequence` equals the frame loop bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu as J
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.io import synthetic_dataset as jsyn
from mono_lidar_depth_tpu.io.kitti import KittiSequence as JKittiSequence
from mono_lidar_depth_tpu.io.kitti import pad_cloud
from mono_lidar_depth_tpu.tracks import pipeline as JP
from mono_lidar_depth_tpu_torch.convert import state_to_numpy
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as tsyn

from torch_parity import assert_trees_equal, to_numpy, to_port

SPEC = dict(frames=5, image_width=384, image_height=128, focal=240.0,
            lidar_rows=20, lidar_cols=500, step=0.7)
SMALL = dict(max_points=16384, max_features=256, image_width=384,
             image_height=128, ransac_num_hypotheses=128,
             ransac_subsample_points=1024, radiusSearch_count_min=1)


@pytest.fixture(scope="module")
def seq():
    return tsyn.render_sequence(tsyn.SyntheticSpec(**SPEC), seed=4)


def _calib(seq):
    R = seq.Tr[:, :3].astype(np.float32)
    t = seq.Tr[:, 3].astype(np.float32)
    return R, t, np.asarray(J.PinholeCamera(*seq.camera).intrinsics())


def _both(points, valid, labels, R, t, K, **kw):
    want = to_numpy(J.fit_ground_plane_semantic(
        jnp.asarray(points), jnp.asarray(valid), jnp.asarray(labels),
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(K), **kw))
    got = state_to_numpy(T.fit_ground_plane_semantic(
        torch.from_numpy(points), torch.from_numpy(valid),
        torch.from_numpy(labels), torch.from_numpy(R), torch.from_numpy(t),
        torch.from_numpy(K), **kw))
    return got, want


def _assert_planes_agree(got, want, points, valid, threshold):
    assert bool(got.ok) == bool(want.ok)
    assert got.ok.shape == () and got.coeffs.shape == (4,)
    assert got.inlier_mask.dtype == np.bool_
    np.testing.assert_allclose(got.coeffs, want.coeffs, atol=1e-4, rtol=0)
    # distance to the first-pass plane decides the mask; a point within
    # 1e-4 of the threshold may fall on either side
    differ = got.inlier_mask != want.inlier_mask
    if differ.any():
        seed_plane = want.coeffs  # the refit moves the plane by < 1e-4 here
        dist = np.abs(points.astype(np.float64) @ seed_plane[:3]
                      + seed_plane[3])
        assert (np.abs(dist[differ] - threshold) < 1e-3).all()
        assert differ.sum() <= 2
    assert not got.inlier_mask[~valid].any()


@pytest.mark.parametrize("threshold", [10.2, 0.3])
@pytest.mark.parametrize("k", [0, 3])
def test_semantic_plane_on_a_rendered_frame(seq, k, threshold):
    """A rendered scan and its label image, plus a point with z = 0 in the
    camera frame, one behind the camera and one with a huge quotient far
    outside the image: the integer cast of such pixel coordinates differs
    between XLA, PyTorch's CPU and the card, and all of them must stay out
    of the seed set."""
    R, t, K = _calib(seq)
    xyzi, n = list(seq.scans(SMALL["max_points"]))[k]
    cloud, valid = pad_cloud(xyzi, n, SMALL["max_points"])
    # lidar x is the camera's z: x = -t_z puts a point on the image plane
    cloud[n] = [-t[2], 0.3, 3.0]
    cloud[n + 1] = [-15.0, 0.5, 3.0]  # behind the camera
    cloud[n + 2] = [1e-3 - t[2], 4e4, 3e4]  # a huge quotient
    valid[n:n + 3] = True
    labels = seq.semantic(k).astype(np.int32)
    got, want = _both(cloud, valid, labels, R, t, K,
                      inlier_threshold=threshold)
    _assert_planes_agree(got, want, cloud, valid, threshold)
    assert bool(got.ok)
    if threshold == 0.3:
        # the ground: normal along lidar z, more than 100 inliers
        assert abs(got.coeffs[2]) > 0.99 and got.inlier_mask.sum() > 100
        assert not got.inlier_mask[n:n + 3].any()
    else:
        assert got.inlier_mask[:n].all()  # the refit spans the scene


def test_semantic_plane(rng):
    """The scene of tests/test_ransac.py::test_semantic_plane."""
    H, W, f = 64, 96, 60.0
    ground_xz = rng.uniform([-3, 5], [3, 40], size=(3000, 2))
    ground = np.column_stack([
        ground_xz[:, 0], np.full(3000, 1.5) + rng.normal(size=3000) * 0.01,
        ground_xz[:, 1]]).astype(np.float32)
    other = rng.uniform([-3, -3, 5], [3, 1.0, 40],
                        size=(2000, 3)).astype(np.float32)
    pts = np.concatenate([ground, other])
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)
    img = np.zeros((H, W), dtype=np.int32)
    proj = ground @ K.T
    uv = (proj[:, :2] / proj[:, 2:3]).astype(int)
    ok = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    img[uv[ok, 1], uv[ok, 0]] = 7
    valid = np.ones(len(pts), bool)
    got, want = _both(pts, valid, img, np.eye(3, dtype=np.float32),
                      np.zeros(3, np.float32), K, inlier_threshold=0.1)
    _assert_planes_agree(got, want, pts, valid, 0.1)
    assert bool(got.ok)
    assert abs(abs(got.coeffs[1]) - 1.0) < 0.05
    np.testing.assert_allclose(abs(got.coeffs[3]), 1.5, atol=0.1)


@pytest.mark.parametrize("labels,want_ok", [((6, 7, 8, 9), True),
                                            ((8,), False), ((), False)])
def test_semantic_plane_labels_and_empty_seed(seq, labels, want_ok):
    """Other label sets; with no seed point the fit is not ok and the
    coefficients stay finite in both."""
    R, t, K = _calib(seq)
    xyzi, n = next(iter(seq.scans(SMALL["max_points"])))
    cloud, valid = pad_cloud(xyzi, n, SMALL["max_points"])
    got, want = _both(cloud, valid, seq.semantic(0).astype(np.int32), R, t,
                      K, ground_labels=labels, inlier_threshold=0.3)
    assert bool(got.ok) == bool(want.ok) == want_ok
    assert np.isfinite(got.coeffs).all() and np.isfinite(want.coeffs).all()
    if want_ok:
        _assert_planes_agree(got, want, cloud, valid, 0.3)


def test_sequence_semantic_matches_the_written_png(tmp_path, seq):
    jsyn.generate_kitti_sequence(str(tmp_path), "99",
                                 jsyn.SyntheticSpec(**SPEC), seed=4)
    disk = JKittiSequence(str(tmp_path), "99", 384, 128)
    for i in range(len(seq)):
        sem = seq.semantic(i)
        assert sem.dtype == np.uint8 and sem.shape == (128, 384)
        assert np.array_equal(sem, disk.semantic(i))
    labs = set(np.unique(seq.semantic(0)).tolist())
    assert tsyn.LABEL_ROAD in labs and tsyn.LABEL_WALL in labs
    assert seq.semantic(len(seq)) is None and seq.semantic(-1) is None


def _frames(seq, cfg):
    """Per frame: cloud, mask, labels and drifting tracks, as numpy."""
    rng = np.random.default_rng(9)
    M = cfg.max_features
    n = len(seq)
    base = rng.uniform([4, 40], [380, 124], (M, 2))
    uv = np.clip(base[None] + np.cumsum(rng.normal(0, 1.0, (n, M, 2)), 0),
                 [1, 1], [382, 126]).astype(np.float32)
    out = []
    for k, (xyzi, count) in enumerate(seq.scans(cfg.max_points)):
        cloud, cvalid = pad_cloud(xyzi, count, cfg.max_points)
        out.append(dict(cloud=cloud, cloud_valid=cvalid,
                        ids=np.arange(M, dtype=np.int32),
                        ids_valid=rng.random(M) < 0.9, uv_new=uv[k],
                        uv_prev=uv[max(k - 1, 0)],
                        stamp=np.float32(seq.times[k]),
                        semantic=seq.semantic(k).astype(np.int32)))
    return out


def _assert_tables_match(ttab, jtab, road_successes, other_codes):
    """Ids, ages, lengths, uv windows and stamps bit-exact and the same
    depth entries present; the depth values within 5e-7 relative (XLA
    contracts multiply-adds, eager PyTorch does not), but for at most
    `road_successes` entries from road-pass depths, whose fp32 plane fit
    is ill-conditioned (tests/test_torch_depth.py): within 5e-3; and but
    for the `other_codes` lanes so far that succeeded in both packages
    with different codes, whose depths come from different fits."""
    ttab, jtab = state_to_numpy(ttab), to_numpy(jtab)
    for name in ("track_id", "age", "length", "uv", "stamps"):
        assert np.array_equal(getattr(ttab, name), getattr(jtab, name)), name
    has = jtab.depth > 0
    assert np.array_equal(ttab.depth > 0, has)
    assert np.array_equal(ttab.depth[~has], jtab.depth[~has])
    rel = np.abs(ttab.depth[has] - jtab.depth[has]) / jtab.depth[has]
    assert np.median(rel) < 2e-7
    assert (rel > 5e-7).sum() <= road_successes
    assert (rel > 5e-3).sum() <= other_codes


def _port_frame(f, semantic=True):
    f = dict(f) if semantic else dict(f, semantic=None)
    rng = RansacDraws(torch.zeros(1024, dtype=torch.int64),
                      torch.zeros((128, 3), dtype=torch.int64))
    return T.FrameInput(**{k: None if v is None else torch.tensor(v)
                           for k, v in f.items()}, rng=rng)


@pytest.mark.parametrize("threshold", [0.3, 10.2])
def test_process_frame_semantic_mode(seq, threshold):
    """Four frames in semantic mode through both packages from a primed
    state: tables bit-exact but for depths, codes and counters equal."""
    kw = dict(SMALL, ransac_plane_refinement_treshold=threshold)
    jcfg, tcfg = J.DepthEstimatorConfig(**kw), T.DepthEstimatorConfig(**kw)
    jcam, tcam = J.PinholeCamera(*seq.camera), seq.camera
    R, t, _ = _calib(seq)
    jl2c = J.SE3(jnp.asarray(R), jnp.asarray(t))
    tl2c = seq.lidar_to_cam("cpu")
    frames = _frames(seq, jcfg)
    M = jcfg.max_features
    key = jnp.zeros(2, jnp.uint32)  # unused in semantic mode

    jstate = JP.prime_state(
        jcfg, jcam, jl2c, JP.TrackletDepthState.create(jcfg, M, 8),
        jnp.asarray(frames[0]["cloud"]), jnp.asarray(frames[0]["cloud_valid"]),
        key, semantic=jnp.asarray(frames[0]["semantic"]))
    tstate = T.prime_state(
        tcfg, tcam, tl2c, T.TrackletDepthState.create(tcfg, M, 8, "cpu"),
        torch.tensor(frames[0]["cloud"]),
        torch.tensor(frames[0]["cloud_valid"]), None,
        semantic=torch.tensor(frames[0]["semantic"]))
    np.testing.assert_allclose(tstate.gp_last.coeffs.numpy(),
                               np.asarray(jstate.gp_last.coeffs), atol=1e-4)
    assert np.array_equal(tstate.frame_last.grid.numpy(),
                          np.asarray(jstate.frame_last.grid))
    differ = lanes = 0
    for f in frames[1:]:
        jstate, jd, jc = JP.process_frame(jcfg, jcam, jl2c, jstate, JP.FrameInput(
            **{k: jnp.asarray(v) for k, v in f.items()}, rng=key))
        tstate, td, tc = T.process_frame(tcfg, tcam, tl2c, tstate,
                                         _port_frame(f))
        differ += int((tc.numpy() != np.asarray(jc)).sum())
        lanes += tc.numel()
        _assert_tables_match(tstate.table, jstate.table,
                             int(np.asarray(jstate.counters)[16]), differ)
        np.testing.assert_allclose(tstate.gp_last.coeffs.numpy(),
                                   np.asarray(jstate.gp_last.coeffs),
                                   atol=1e-4)
        assert np.abs(tstate.counters.numpy()
                      - np.asarray(jstate.counters)).sum() <= 2 * differ
        assert np.array_equal(tstate.gp_last.inlier_mask.numpy(),
                              np.asarray(jstate.gp_last.inlier_mask))
    # The scan is a regular grid on planes, so the spans that
    # `max_spanning_triangle` compares come close to ties: in the fourth
    # frame one lane (of 1,024) picks another triangle in XLA, which fails
    # the planarity gate there (TriangleNotPlanar, then SuccessRoad) and
    # passes it here (Success).  The estimator's bar: 99.9% of codes.
    print(f"semantic mode: {differ} of {lanes} codes differ")
    assert differ / lanes <= 1e-3
    counters = np.asarray(jstate.counters)
    assert counters[1] > 20 and counters.sum() > 800


def test_semantic_is_used_only_with_the_road_pass(seq):
    """`do_use_ransac_plane=False`: no plane at all, label image or not,
    as in the JAX package."""
    cfg = T.DepthEstimatorConfig(**dict(SMALL, do_use_ransac_plane=False))
    f = _frames(seq, cfg)[1]
    state = T.TrackletDepthState.create(cfg, cfg.max_features, 8, "cpu")
    a = T.process_frame(cfg, seq.camera, seq.lidar_to_cam("cpu"), state,
                        _port_frame(f))
    b = T.process_frame(cfg, seq.camera, seq.lidar_to_cam("cpu"), state,
                        _port_frame(f, semantic=False))
    assert_trees_equal(state_to_numpy(a), state_to_numpy(b))
    assert not bool(a[0].gp_last.ok)


@pytest.mark.parametrize("semantic", [True, False])
def test_process_sequence_equals_the_frame_loop(seq, semantic):
    cfg = T.DepthEstimatorConfig(**SMALL)
    cam, l2c = seq.camera, seq.lidar_to_cam("cpu")
    frames = [_port_frame(f, semantic) for f in _frames(seq, cfg)[1:]]
    rng = np.random.default_rng(1)
    draws = [RansacDraws(torch.from_numpy(rng.integers(0, 9000, 1024)),
                         torch.from_numpy(rng.integers(0, 1024, (128, 3))))
             for _ in frames]
    frames = [f._replace(rng=d) for f, d in zip(frames, draws)]
    state0 = T.TrackletDepthState.create(cfg, cfg.max_features, 8, "cpu")

    state, depths, codes = state0, [], []
    for f in frames:
        state, d, c = T.process_frame(cfg, cam, l2c, state, f)
        depths.append(d)
        codes.append(c)

    stacked = T.FrameInput(*(
        None if xs[0] is None else
        RansacDraws(*(torch.stack(p) for p in zip(*xs)))
        if isinstance(xs[0], RansacDraws) else torch.stack(xs)
        for xs in zip(*frames)))
    final, sd, sc = T.process_sequence(cfg, cam, l2c, state0, stacked)
    assert sd.shape == (len(frames), cfg.max_features) and sc.shape == sd.shape
    assert torch.equal(sd, torch.stack(depths))
    assert torch.equal(sc, torch.stack(codes))
    assert_trees_equal(state_to_numpy(final), state_to_numpy(state))

    # one generator for all frames draws in frame order
    gen_frames = stacked._replace(rng=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    a = T.process_sequence(cfg, cam, l2c, state0, gen_frames)
    state = state0
    for f in frames:
        state, _, _ = T.process_frame(cfg, cam, l2c, state,
                                      f._replace(rng=gen))
    assert_trees_equal(state_to_numpy(a[0]), state_to_numpy(state))
