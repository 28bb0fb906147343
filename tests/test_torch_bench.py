"""bench_torch.py, the port's counterpart of bench.py, against bench.py.

Bars: the scene equal to bench.py's to the bit; with JAX's RANSAC draws
injected (`jax.random.split(PRNGKey(0), n)`, frame f's key, as bench.py
gives them), the depth legs' codes and counters equal to bench.py's
`depth_frame` run through the JAX package, in exact and in fast mode,
and their depths within tests/test_torch_depth.py's bars (5e-3 relative
on agreeing successes, median under 1e-6); the combined leg's poses
over ba_window + 2 frames from a fresh state within
tests/test_torch_vo.py's slice bar (1e-3; rotation entries, translation
in m) with the diagnostics' counts equal; the window_ba leg within
tests/test_torch_vo.py's 1e-4 (landmarks 1e-3), the pose_gn leg's
rotations too, and its translations within 1e-5 of |t| (see
`test_pose_gn_leg_matches_bench_py` for why).  The JSON line's
keys are read from bench.py's source, so a change there fails here.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_ransac_draws
import bench_torch as B
import chip_smoke
import mono_lidar_depth_tpu as J
from mono_lidar_depth_tpu.io.kitti import make_synthetic_scan, pad_cloud
from mono_lidar_depth_tpu.tracks.pipeline import FrameInput as JFrame
from mono_lidar_depth_tpu.vo import ba as jba, pipeline as jvo
from mono_lidar_depth_tpu.vo import pose as jpose
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch.core import neighbors
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws

# bench.py's scene at a size the CPU tests afford: the KITTI camera, its
# 120,000-point clouds on the default 384x1248 grid (fewer points leave
# most windows empty), fewer features and RANSAC hypotheses.
SMALL = dict(max_features=256, ransac_num_hypotheses=128,
             ransac_subsample_points=1024)
JCAM = J.PinholeCamera(**B.KITTI_CAMERA)
JT = J.SE3(jnp.asarray(B.R_LC), jnp.asarray(B.T_LC))


def _bench_py_scene(n_frames, points, jcfg):
    """bench.py's arrays (bench.py:91-124 and :288-289), built with the
    JAX package as bench.py builds them."""
    M = jcfg.max_features
    rng = np.random.default_rng(0)
    clouds, valids = [], []
    for _ in range(n_frames):
        scan = make_synthetic_scan(rng, points)
        c, v = pad_cloud(scan, len(scan), jcfg.max_points)
        clouds.append(c)
        valids.append(v)
    base_uv = rng.uniform([8, 8], [1218, 362], (M, 2))
    drift = rng.normal(0.0, 1.5, (n_frames, M, 2))
    uv_new = np.clip(base_uv[None] + np.cumsum(drift, axis=0),
                     [1, 1], [1225, 369]).astype(np.float32)
    uv_prev = np.concatenate([uv_new[:1], uv_new[:-1]], axis=0)
    ids = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (n_frames, M))
    ids_valid = jnp.ones((n_frames, M), dtype=bool)
    stamp = jnp.arange(n_frames, dtype=jnp.float32) * 0.1
    lm = rng.uniform([-20, -5, 5], [20, 5, 60], (M, 3)).astype(np.float32)
    return dict(clouds=np.stack(clouds), valids=np.stack(valids),
                ids=np.asarray(ids), ids_valid=np.asarray(ids_valid),
                uv_new=uv_new, uv_prev=uv_prev, stamp=np.asarray(stamp),
                lm=lm)


@pytest.mark.parametrize("n_frames,points,cfg_kw", [
    (2, 120_000, {}), (3, 6000, dict(max_points=8192, max_features=256))])
def test_bench_scene_equals_bench_py(n_frames, points, cfg_kw):
    """Array for array, to the bit; the configuration is the JAX
    package's defaults (bench.py's where the reference's parameters.yaml
    is absent) with region growing off."""
    tcfg = T.DepthEstimatorConfig(**cfg_kw) if cfg_kw else None
    sc = B.bench_scene(n_frames, points, tcfg)
    jcfg = J.DepthEstimatorConfig(**cfg_kw).replace(
        do_use_depth_segmentation=False)
    assert sc.cfg.__dict__ == jcfg.__dict__
    want = _bench_py_scene(n_frames, points, jcfg)
    for name, w in want.items():
        got = getattr(sc, name)
        assert got.dtype == w.dtype and got.shape == w.shape, name
        assert got.tobytes() == w.tobytes(), name


@pytest.fixture(scope="module")
def small():
    """The small scene on the CPU, and JAX's per-frame draws of it."""
    n = T.OdometryConfig().ba_window + 2
    sc = B.bench_scene(n, cfg=T.DepthEstimatorConfig(**SMALL))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    draws = [RansacDraws(*jax_ransac_draws(
        keys[f], sc.valids[f], sc.cfg.ransac_subsample_points,
        sc.cfg.ransac_num_hypotheses)) for f in range(n)]
    return sc, keys, draws


def _jax_depth_frame(c, cloud, cvalid, uv, uvv, key):
    """bench.py:135-146."""
    gp = J.fit_ground_plane_ransac(
        cloud, cvalid, key,
        distance_threshold=c.ransac_plane_distance_treshold,
        num_hypotheses=c.ransac_num_hypotheses,
        subsample=c.ransac_subsample_points,
        use_refinement=c.ransac_plane_use_refinement,
        refinement_threshold=c.ransac_plane_refinement_treshold)
    return J.estimate_depths(c, JCAM, JT, cloud, cvalid, uv, uvv, gp)


@pytest.mark.parametrize("fast", [False, True])
def test_depth_leg_matches_bench_py(small, fast):
    sc, keys, draws = small
    n = 3
    tcfg = sc.cfg.replace(fast_rasterization=fast)
    jcfg = J.DepthEstimatorConfig(**SMALL).replace(
        do_use_depth_segmentation=False, fast_rasterization=fast)
    cam, l2c = B.camera_and_extrinsics("cpu")
    frames = B.scene_frames(sc, "cpu")
    frames = T.FrameInput(*(x[:n] for x in frames[:7]), rng=None)
    acc, outs = B.depth_leg(tcfg, cam, l2c, frames, draws)
    want_acc = 0.0
    for f in range(n):
        j = _jax_depth_frame(jcfg, jnp.asarray(sc.clouds[f]),
                             jnp.asarray(sc.valids[f]),
                             jnp.asarray(sc.uv_new[f]),
                             jnp.ones(sc.uv_new.shape[1], bool), keys[f])
        tc, jc = outs[f].codes.numpy(), np.asarray(j.codes)
        differ = np.flatnonzero(tc != jc)
        assert differ.size == 0, (f, differ, tc[differ], jc[differ])
        assert np.array_equal(outs[f].counters.numpy(),
                              np.asarray(j.counters)), f
        td, jd = outs[f].depths.numpy(), np.asarray(j.depths)
        ok = jd > 0
        assert ok.sum() > 0.2 * ok.size, f
        rel = np.abs(td - jd)[ok] / jd[ok]
        assert rel.max() < 5e-3 and np.median(rel) < 1e-6, (f, rel.max())
        want_acc += float(jnp.sum(j.depths) + jnp.sum(j.codes)
                          + jnp.sum(j.counters))
    np.testing.assert_allclose(float(acc), want_acc, rtol=1e-5)


def test_combined_leg_matches_odometry_step(small):
    """ba_window + 2 frames of `odometry_step` from a fresh state, the
    first BA windows included."""
    sc, keys, draws = small
    ocfg = T.OdometryConfig()
    M = sc.cfg.max_features
    cam, l2c = B.camera_and_extrinsics("cpu")
    frames = B.scene_frames(sc, "cpu")
    state0 = T.OdometryState.create(sc.cfg, ocfg, M, 12, "cpu")
    _, acc, poses = B.combined_leg(sc.cfg, ocfg, cam, l2c, state0, frames,
                                   draws)
    jcfg = J.DepthEstimatorConfig(**SMALL).replace(
        do_use_depth_segmentation=False)
    jocfg = jvo.OdometryConfig()
    state = jvo.OdometryState.create(jcfg, jocfg, max_tracks=M, max_length=12)
    for f, (tR, tt, tdiag) in enumerate(poses):
        state, jR, jt, jdiag = jvo.odometry_step(
            jcfg, jocfg, JCAM, JT, state, JFrame(
                cloud=jnp.asarray(sc.clouds[f]),
                cloud_valid=jnp.asarray(sc.valids[f]),
                ids=jnp.asarray(sc.ids[f]), ids_valid=jnp.asarray(
                    sc.ids_valid[f]), uv_new=jnp.asarray(sc.uv_new[f]),
                uv_prev=jnp.asarray(sc.uv_prev[f]),
                stamp=jnp.asarray(sc.stamp[f]), rng=keys[f]))
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
        jdiag, tdiag = np.asarray(jdiag), tdiag.numpy()
        assert np.array_equal(tdiag[:2], jdiag[:2]), (f, tdiag, jdiag)
        assert abs(tdiag[2] - jdiag[2]) < 1e-4, (f, tdiag, jdiag)
        assert f == 0 or jdiag[1] >= jocfg.min_motion_tracks, f
    assert int(state.frame_idx) == len(poses)
    assert np.isfinite(float(acc))


@pytest.fixture(scope="module")
def full_width():
    """bench.py's landmarks and features at its full 2,048 features."""
    sc = B.bench_scene(T.OdometryConfig().ba_window + 2, 6000,
                       T.DepthEstimatorConfig(max_points=8192))
    assert sc.cfg.max_features == 2048
    return sc, T.PinholeCamera(**B.KITTI_CAMERA)


def test_pose_gn_leg_matches_bench_py(full_width):
    """bench.py's pose_gn body (:288-304).  Its features are random
    against its landmarks: the GN finds at most one inlier and walks to
    |t| ~ 300 m, where the fp32 spacing is 3e-5 m.  So the translation
    is held to 1e-5 of |t| against JAX (test_torch_vo.py: 1e-4 m on a
    well-posed problem; observed: at most 4.0e-4 m, 1.3e-6 of |t|), and
    the port's fp32 solve to 2e-5 of |t| of its own float64 solve, which
    shows that the difference is fp32 arithmetic (observed: at most
    3.1e-6; JAX's solve 2.1e-6 from that float64 one)."""
    sc, cam = full_width
    lm, uv = torch.from_numpy(sc.lm), torch.from_numpy(sc.uv_new)
    usable = torch.ones(uv.shape[:2], dtype=torch.bool)
    _, gn = B.pose_gn_leg(cam, lm, uv, usable)
    _, gn64 = B.pose_gn_leg(cam, lm.double(), uv.double(), usable)
    assert len(gn) == len(sc.uv_new)
    for f, (est, e64) in enumerate(zip(gn, gn64)):
        j = jpose.estimate_pose_gn(JCAM, jnp.asarray(sc.lm),
                                   jnp.asarray(sc.uv_new[f]),
                                   jnp.ones(sc.lm.shape[0], bool),
                                   R_init=jnp.eye(3), t_init=jnp.zeros(3))
        np.testing.assert_allclose(est.rotation.numpy(),
                                   np.asarray(j.rotation), atol=1e-4)
        t, jt = est.translation.numpy(), np.asarray(j.translation)
        size = np.linalg.norm(jt)
        assert np.abs(t - jt).max() <= 1e-5 * size, (f, t, jt)
        assert np.abs(t - e64.translation.numpy()).max() <= 2e-5 * size, f
        assert int(est.num_inliers) == int(j.num_inliers) <= 1, f


def test_window_ba_leg_matches_bench_py(full_width):
    """bench.py's window_ba body (:307-332): every window of ba_window
    frames at test_torch_vo.py's bars."""
    sc, cam = full_width
    ocfg = T.OdometryConfig()
    Wb, M = ocfg.ba_window, sc.lm.shape[0]
    _, ba = B.window_ba_leg(cam, ocfg, torch.from_numpy(sc.lm),
                            torch.from_numpy(sc.uv_new))
    assert len(ba) == len(sc.uv_new) - Wb
    for k, pb in enumerate(ba):
        j = jba.run_ba(JCAM, jba.BAProblem(
            R=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (Wb, 3, 3)),
            t=jnp.zeros((Wb, 3), jnp.float32), landmarks=jnp.asarray(sc.lm),
            obs_uv=jnp.asarray(sc.uv_new[k:k + Wb]),
            obs_mask=jnp.ones((Wb, M), bool),
            depth_prior=jnp.full((Wb, M), 12.0),
            depth_mask=jnp.ones((Wb, M), bool),
            fixed=jnp.arange(Wb) == Wb - 1, lm_valid=jnp.ones((M,), bool)),
            iters=ocfg.ba_iters, depth_weight=ocfg.depth_weight)
        np.testing.assert_allclose(pb.R.numpy(), np.asarray(j.problem.R),
                                   atol=1e-4)
        np.testing.assert_allclose(pb.t.numpy(), np.asarray(j.problem.t),
                                   atol=1e-4)
        np.testing.assert_allclose(pb.landmarks.numpy(),
                                   np.asarray(j.problem.landmarks), atol=1e-3)


def test_reps_do_the_same_work(small):
    """A rep reseeds the leg's generator and starts from the same state:
    two reps give the same checksum, and the state is not changed."""
    sc, _, _ = small
    ocfg = T.OdometryConfig()
    cam, l2c = B.camera_and_extrinsics("cpu")
    frames = B.scene_frames(sc, "cpu")
    frames = T.FrameInput(*(x[:3] for x in frames[:7]), rng=None)
    gen = torch.Generator()
    state = T.OdometryState.create(sc.cfg, ocfg, sc.cfg.max_features, 12,
                                   "cpu")
    state, _, _ = B.combined_leg(sc.cfg, ocfg, cam, l2c, state, frames,
                                 gen.manual_seed(B.SEED))
    before = [x.clone() for x in jax.tree.leaves(
        state, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    sums = [float(B.combined_leg(sc.cfg, ocfg, cam, l2c, state, frames,
                                 gen.manual_seed(B.SEED))[1])
            for _ in range(2)]
    assert sums[0] == sums[1]
    after = jax.tree.leaves(state,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    depth = [float(B.depth_leg(sc.cfg, cam, l2c, frames,
                               gen.manual_seed(B.SEED))[0])
             for _ in range(2)]
    assert depth[0] == depth[1]


def test_run_prints_bench_py_keys(capsys):
    result, launches = B.run("cpu", n_frames=6,
                             cfg=T.DepthEstimatorConfig(**SMALL), reps=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[-1])
    keys = chip_smoke.bench_py_keys()  # read from bench.py's source
    assert len(keys) == 21 and keys[0] == "metric"
    assert keys[-1] == "spread_pct_window_ba"
    assert list(printed) == keys
    assert printed == result
    assert printed["timing_reps"] == 1
    for k, v in printed.items():
        if isinstance(v, float) and not k.startswith("spread_pct_"):
            assert np.isfinite(v) and v > 0, k
    assert set(launches) == {"depth_assoc", "depth_assoc_fast", "combined",
                             "combined_fast", "serving", "pose_gn",
                             "window_ba"}
    assert set(launches.values()) == {0}  # the CPU runs the plain version


def test_launch_count_is_checked():
    """On the card every estimate_depths / odometry_step call launches
    the gather once; a count of 0 means the plain version ran."""
    assert B._counted("leg", 4, torch.device("cpu"), lambda: 7) == (7, 0)
    with pytest.raises(RuntimeError, match="0 gather_neighbors launches"):
        B._counted("leg", 4, torch.device("cuda", 0), lambda: None)

    def launches_three():
        neighbors.launches += 3

    with pytest.raises(RuntimeError, match="3 gather_neighbors launches"):
        B._counted("leg", 4, torch.device("cuda", 0), launches_three)
    neighbors.launches = 0


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert B.main([]) != 0
    assert B.main(["--device", "cuda:0"]) != 0
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.run("cuda", n_frames=6)


@pytest.mark.parametrize("shift", [0.0, 2e-3])
def test_phase_10_lane_report(shift):
    """chip_smoke.py's `_cascade_split` (phase 10's report of where a
    lane's cascade parts between the card and the CPU) on two CPU runs of
    frame 0 of bench.py's scene in fast mode, the second from a
    lidar-to-camera translation moved by `shift`: with no shift every
    step of every lane is bit-equal and every op of the RANSAC refit and
    the eigensolver reads 0 ulp; with one, the codes part on some lanes,
    and on each the neighbours (step 1) differ first."""
    sc = B.bench_scene(1)
    cfg = sc.cfg.replace(fast_rasterization=True)
    draws = chip_smoke._numpy_draws(np.random.default_rng(0), cfg,
                                    int(sc.valids[0].sum()))
    cpu = torch.device("cpu")
    cam, l2c = B.camera_and_extrinsics(cpu)
    cloud, valid = (torch.from_numpy(sc.clouds[0]),
                    torch.from_numpy(sc.valids[0]))
    runs = []
    for t in (l2c, l2c._replace(translation=l2c.translation + shift)):
        with chip_smoke._CascadeTrace() as trace:
            gp = B.ground_plane(cfg, cloud, valid, RansacDraws(
                *(torch.from_numpy(a) for a in draws)))
            est = T.estimate_depths(
                cfg, cam, t, cloud, valid, torch.from_numpy(sc.uv_new[0]),
                torch.ones(cfg.max_features, dtype=torch.bool), gp)
        runs.append((trace.calls, est.codes.numpy()))
    (c_calls, c_codes), (g_calls, g_codes) = runs
    differ = np.flatnonzero(g_codes != c_codes)
    lanes = list(differ[:3]) if shift else [0, 5, 700]
    assert (len(differ) > 0) == (shift > 0)
    for lane in lanes:
        first, lines = chip_smoke._cascade_split(
            cfg, cam, sc.uv_new[0][lane], int(lane), g_calls, c_calls,
            (cpu, cpu))
        assert len(lines) == 6, lines
        if shift:
            assert first == "1 neighbours" and "DIFFER" in lines[0]
        else:
            assert first == "none" and all("bit-equal" in ln for ln in lines)
            assert "first op to part: none" in lines[4]


def test_op_chain_replays_the_ports_own_ops():
    """chip_smoke.py's `_op_chain` (phase 10's op-by-op replay) records the
    ops of the port's function itself, each named by its file and line in
    the port: here the road normal of lane 1:1208's saved scatter, whose
    eigensolver calls `torch.arccos` and `torch.cos` in core/geometry.py.
    On one device every op reads 0 ulp, and an input written in place
    after an op read it fails the replay rather than replaying the wrong
    value."""
    from pathlib import Path

    from mono_lidar_depth_tpu_torch.core import geometry

    root = Path(__file__).parent
    bits = json.loads((root / "fixtures" / "phase10_road_scatter.json")
                      .read_text())["lanes"]["1:1208"]
    A = np.array(bits, np.uint32).view(np.float32).reshape(1, 3, 3)
    cpu = torch.device("cpu")
    chain = chip_smoke._op_chain(geometry.smallest_eigenvector_sym3x3, (A,),
                                 {}, (cpu, cpu), 0)
    src = (root.parent / "mono_lidar_depth_tpu_torch" / "core"
           / "geometry.py").read_text().splitlines()
    line = {op: next(n for n, s in enumerate(src, 1) if f"torch.{op}(" in s)
            for op in ("arccos", "cos")}
    for op, n in line.items():
        assert (f"core/geometry.py:{n}", op, 0) in chain, (op, chain)
    assert all(u == 0 for *_, u in chain)
    assert chip_smoke._chain_text(chain).endswith(
        "ulp (first op to part: none)")

    def writes_its_input(x):
        y = x * 2.0
        x.add_(1.0)
        return y

    with pytest.raises(AssertionError, match="written later"):
        chip_smoke._op_chain(writes_its_input, (A.copy(),), {}, (cpu, cpu))
