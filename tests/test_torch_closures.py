"""The port's loop-closure backend (vo/closures.py) against the JAX
package's (eval/kitti_eval.py), on the CPU.

  * Host numpy (proposal, union, consistency filter, weight calibration,
    the numpy SO(3) maps): the same inputs give EQUAL outputs (calibrated
    weights to 1e-6; the SO(3) maps away from pi).
  * `run_pose_graph_backend` on the same poses and closures: optimized
    positions within 1e-4 of the trajectory's extent and rotations within
    2e-3 rad of JAX's (fp32 solves of 20 GN iterations; see
    tests/test_torch_pose_graph.py).
  * `closure_constraint_from_frames` on the 84-frame 384x128 loop of
    tests/test_kitti_synthetic.py, written to disk once, for each
    candidate pair, with JAX's PRNGKey(0) RANSAC draws injected: `accept`
    equal, Z_R within 2e-3 rad, Z_t within 2e-2 m, w6 within 2e-2
    absolute.  The grey image reaches the tracker through eager
    `/ 255.0` in the port and XLA's multiplication by the reciprocal in
    JAX, one ulp apart on half the byte values, so the KLT tracks differ
    by tiny amounts.
  * Config 4 end to end, port copies of tests/test_kitti_synthetic.py's
    two loop-closure tests with the reference's bars; in the drift leg
    the port's VO poses also go through JAX's proposal, verification and
    backend: the same candidates, the same verified closures, and ATE
    after the backend within 5% of JAX's.
"""

import numpy as np
import jax
import pytest

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.eval import kitti_eval as jeval
from mono_lidar_depth_tpu.io.kitti import KittiSequence as JKittiSequence
from mono_lidar_depth_tpu.io.synthetic_dataset import (
    SyntheticSpec as JSpec, generate_kitti_sequence)
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.eval import kitti_eval as teval
from mono_lidar_depth_tpu_torch.io.kitti import KittiSequence
from mono_lidar_depth_tpu_torch.io.synthetic_dataset import (SyntheticSpec,
                                                             render_sequence)
from mono_lidar_depth_tpu_torch.vo import closures as tcl
from mono_lidar_depth_tpu_torch.vo.metrics import ate_rmse

from torch_parity import inject_jax_frame_draws, jax_ransac_draws

W, H = 384, 128
SPEC = dict(frames=84, image_width=W, image_height=H, focal=240.0,
            lidar_rows=20, lidar_cols=500, step=0.55, loop=True)
CFG = dict(max_points=16384, max_features=384, image_width=W, image_height=H,
           radiusSearch_count_min=1, ransac_num_hypotheses=256,
           ransac_subsample_points=1024)
PROPOSE = dict(min_gap=30, radius=8.0, stride=2, max_candidates=8)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """The 84-frame loop on disk, through each package's loader."""
    root = str(tmp_path_factory.mktemp("kitti_loop"))
    generate_kitti_sequence(root, "98", JSpec(**SPEC))
    return (JKittiSequence(root, "98", image_width=W, image_height=H),
            KittiSequence(root, "98", image_width=W, image_height=H))


@pytest.fixture(scope="module")
def vo(disk):
    """The port's VO over the loop, the module's one VO run, on the JAX
    package's RANSAC draws and f32 images: the trajectory the reference's
    own tests see, up to fp32 rounding."""
    cfg = T.DepthEstimatorConfig(**CFG)
    with pytest.MonkeyPatch.context() as mp:
        inject_jax_frame_draws(mp, disk[1], cfg)
        return T.eval_vo_sequence(disk[1], cfg, max_tracks=384, max_length=8,
                                  verbose=False, device="cpu")


@pytest.fixture
def jax_draws(monkeypatch):
    """Every verification direction of the port draws JAX's PRNGKey(0)
    RANSAC sample of its own cloud."""
    cfg = T.DepthEstimatorConfig(**CFG)

    def rng(cloud_valid):
        return RansacDraws(*jax_ransac_draws(
            jax.random.PRNGKey(0), cloud_valid.cpu().numpy(),
            cfg.ransac_subsample_points, cfg.ransac_num_hypotheses))

    monkeypatch.setattr(tcl, "_closure_rng", rng)


def _drifted(poses, yaw_deg=1.5, scale=1.12):
    """tests/test_kitti_synthetic.py's drift: the relative motions
    recomposed with a constant yaw bias and scale error per frame."""
    yaw = np.radians(yaw_deg)
    dR = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]])
    out = [poses[0]]
    for k in range(len(poses) - 1):
        rel = np.linalg.inv(poses[k]) @ poses[k + 1]
        rel[:3, :3] = rel[:3, :3] @ dR
        rel[:3, 3] *= scale
        out.append(out[-1] @ rel)
    return np.stack(out)


def _loop_poses(F=90, radius=12.0, seed=0, noise=0.02):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2.2 * np.pi, F)
    P = np.tile(np.eye(4), (F, 1, 1))
    for k in range(F):
        c, s = np.cos(th[k]), np.sin(th[k])
        P[k, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        P[k, :3, 3] = [radius * np.sin(th[k]), 0.0,
                       radius * (1 - np.cos(th[k]))]
    P[:, :3, 3] += np.cumsum(rng.normal(0, noise, (F, 3)), 0)
    return P


# ---- host numpy: equal outputs -----------------------------------------

@pytest.mark.parametrize("kw", [
    dict(min_gap=30, radius=2.0, stride=2, max_candidates=8),
    dict(min_gap=20, radius=4.0, stride=1, max_candidates=5,
         min_candidates=6),
    dict(min_gap=10, radius=30.0, stride=3, max_candidates=4),
])
def test_propose_loop_closures_equal(kw):
    poses = _loop_poses()
    for p in (poses, poses[:, :3, 3], _drifted(poses, 1.0, 1.05)):
        assert tcl.propose_loop_closures(p, **kw) == \
            jeval.propose_loop_closures(p, **kw)
    assert tcl.propose_loop_closures(poses, **kw)


def test_appearance_proposal_and_union_equal():
    seq = render_sequence(SyntheticSpec(**SPEC))
    kw = dict(min_gap=30, stride=2, max_candidates=10)
    got = tcl.propose_loop_closures_appearance(seq, list(range(84)), **kw)
    want = jeval.propose_loop_closures_appearance(seq, list(range(84)),
                                                  **kw)
    assert got == want and len(got) >= 3
    img = seq.image(5)
    np.testing.assert_array_equal(tcl._appearance_descriptor(img, 10, 32),
                                  jeval._appearance_descriptor(img, 10, 32))
    metric = tcl.propose_loop_closures(_loop_poses(84), min_gap=30)
    for sup in (0, 2, 6):
        assert tcl.union_closure_candidates(metric, got, sup=sup) == \
            jeval.union_closure_candidates(metric, got, sup=sup)


def _closures(poses, pairs, rng, bad=()):
    """(i, j, Z_R, Z_t, w6) measured from `poses` with noise; pairs in
    `bad` get a 30 deg / 7 m error."""
    out = []
    for k, (i, j) in enumerate(pairs):
        Z = np.linalg.inv(poses[i]) @ poses[j]
        ZR = Z[:3, :3] @ tcl._so3_exp(rng.normal(0, 0.003, 3))
        Zt = Z[:3, 3] + rng.normal(0, 0.05, 3)
        if k in bad:
            ZR = ZR @ tcl._so3_exp(np.array([0.0, np.radians(30), 0.0]))
            Zt = Zt + np.array([7.0, 0.0, 0.0])
        out.append((i, j, ZR, Zt, rng.uniform(0.2, 1.0, 6).astype(
            np.float32)))
    return out


def _remeasure_from(poses, noise_rng):
    cache = {}

    def remeasure(a, b):
        if (a, b) not in cache:
            Z = np.linalg.inv(poses[a]) @ poses[b]
            cache[(a, b)] = (Z[:3, :3],
                             Z[:3, 3] + noise_rng.normal(0, 0.02, 3),
                             np.ones(6, np.float32))
        return cache[(a, b)]

    return remeasure


def _same_closures(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g[0], g[1]) == (w[0], w[1])
        for a, b in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["many", "one bad", "lone", "lone bad",
                                  "isolated"])
def test_filter_and_calibration_equal(case):
    poses = _loop_poses()
    rng = np.random.default_rng(7)
    pairs = {"many": [(0, 80), (2, 82), (4, 84), (6, 86), (40, 75)],
             "one bad": [(0, 80), (2, 82), (4, 84), (6, 86)],
             "lone": [(3, 83)], "lone bad": [(3, 83)],
             "isolated": [(0, 80), (2, 82), (30, 45)]}[case]
    bad = (1,) if case == "one bad" else (0,) if case == "lone bad" else ()
    cls = _closures(poses, pairs, rng, bad)
    for with_remeasure in (False, True):
        kw_t, kw_j = {}, {}
        if with_remeasure:  # one measurement per pair, the same for both
            kw_t = dict(remeasure=_remeasure_from(
                poses, np.random.default_rng(1)))
            kw_j = dict(remeasure=_remeasure_from(
                poses, np.random.default_rng(1)))
        got = tcl.filter_consistent_closures(poses, cls, **kw_t)
        want = jeval.filter_consistent_closures(poses, cls, **kw_j)
        _same_closures(got, want)
    got = tcl.calibrate_closure_weights(poses, cls)
    want = jeval.calibrate_closure_weights(poses, cls)
    assert [c[:2] for c in got] == [c[:2] for c in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[4], w[4], atol=1e-6, rtol=0)


def test_so3_maps_equal():
    rng = np.random.default_rng(4)
    for w in list(rng.normal(size=(50, 3))) + [np.zeros(3),
                                                np.array([1e-9, 0, 0])]:
        w = w / max(1.0, np.linalg.norm(w) / 3.0)  # |w| <= 3 < pi
        R = tcl._so3_exp(w)
        np.testing.assert_array_equal(R, jeval._so3_exp(w))
        np.testing.assert_array_equal(tcl._so3_log(R), jeval._so3_log(R))
        np.testing.assert_allclose(tcl._so3_log(R), w if np.linalg.norm(
            w) >= 1e-8 else np.zeros(3), atol=1e-7)


# ---- the backend on the same inputs ------------------------------------

def _backend_close(got, want, pos_share=1e-4, rot_rad=2e-3):
    extent = float(np.ptp(want[:, :3, 3], axis=0).max())
    dt = float(np.abs(got[:, :3, 3] - want[:, :3, 3]).max())
    E = got[:, :3, :3].transpose(0, 2, 1) @ want[:, :3, :3]
    dr = float((np.linalg.norm(E - E.transpose(0, 2, 1), axis=(1, 2))
                / (2 * np.sqrt(2))).max())
    print(f"backend: positions {dt:.3e} m of {extent:.1f} m, rotations "
          f"{dr:.3e} rad")
    assert np.isfinite(got).all()
    assert dt <= pos_share * extent and dr <= rot_rad, (dt, extent, dr)


@pytest.mark.parametrize("case", ["no closures", "closures", "remeasure"])
def test_backend_matches_jax(case):
    gt = _loop_poses(noise=0.0)
    drift = _drifted(gt, 0.3, 1.03)
    rng = np.random.default_rng(3)
    cls = [] if case == "no closures" else _closures(
        gt, [(0, 80), (2, 82), (5, 85)] if case == "closures"
        else [(2, 82)], rng)
    kw_t, kw_j = {}, {}
    if case == "remeasure":
        kw_t = dict(remeasure=_remeasure_from(gt, np.random.default_rng(2)))
        kw_j = dict(remeasure=_remeasure_from(gt, np.random.default_rng(2)))
    got = tcl.run_pose_graph_backend(drift, cls, device="cpu", **kw_t)
    want = jeval.run_pose_graph_backend(drift, cls, **kw_j)
    _backend_close(got, want)
    if cls:
        assert ate_rmse(got[:, :3, 3], gt[:, :3, 3]) < ate_rmse(
            drift[:, :3, 3], gt[:, :3, 3])


# ---- the sequence accessor the verification reads ----------------------

def test_scan_equals_scans(disk):
    seq = render_sequence(SyntheticSpec(**dict(SPEC, frames=4)))
    for s in (seq, disk[1]):
        for i, (xyzi, n) in enumerate(s.scans(5000)):
            if i >= 4:
                break
            a, m = s.scan(i, 5000)
            assert m == n and np.array_equal(a, xyzi)
            assert a.shape == (5000, 4) and a.dtype == np.float32


# ---- verification against JAX ------------------------------------------

def test_closure_constraint_matches_jax(disk, jax_draws):
    jseq, tseq = disk
    jcfg = jeval.DepthEstimatorConfig(**CFG)
    tcfg = T.DepthEstimatorConfig(**CFG)
    pairs = tcl.propose_loop_closures(tseq.gt_poses, **PROPOSE)
    assert len(pairs) >= 4
    n_ok = 0
    for i, j in pairs:
        got = tcl.closure_constraint_from_frames(
            tseq, tcfg, i, j, max_features=tcfg.max_features, device="cpu")
        want = jeval.closure_constraint_from_frames(
            jseq, jcfg, i, j, max_features=jcfg.max_features)
        assert (got is None) == (want is None), (i, j)
        if got is None:
            continue
        n_ok += 1
        ZR, Zt, w6 = got
        E = np.asarray(ZR, np.float64).T @ np.asarray(want[0], np.float64)
        angle = np.linalg.norm(E - E.T) / (2 * np.sqrt(2))
        print(f"pair {i},{j}: |dR| {angle:.2e} rad, |dt| "
              f"{np.abs(Zt - np.asarray(want[1])).max():.2e} m, |dw6| "
              f"{np.abs(w6 - want[2]).max():.2e}")
        assert angle <= 2e-3
        np.testing.assert_allclose(Zt, np.asarray(want[1]), atol=2e-2)
        np.testing.assert_allclose(w6, want[2], atol=2e-2)
        assert ZR.shape == (3, 3) and w6.dtype == np.float32
    assert n_ok >= 1


# ---- config 4 end to end -----------------------------------------------

def test_posegraph_loop_closure_end_to_end(disk, vo, jax_draws):
    """Port copy of tests/test_kitti_synthetic.py::
    test_posegraph_loop_closure_end_to_end: the optimized trajectory beats
    raw VO."""
    _, seq = disk
    cfg = T.DepthEstimatorConfig(**CFG)
    poses = vo["poses"]
    cands = T.eval.propose_loop_closures(poses, **PROPOSE)
    closures = []
    for (i, j) in cands:
        z = teval.closure_constraint_from_frames(
            seq, cfg, vo["frame_ids"][i], vo["frame_ids"][j],
            max_features=cfg.max_features, device="cpu")
        if z is not None:
            closures.append((i, j, *z))
    assert len(closures) >= 1, (cands, "no closure verified")
    opt = T.eval.run_pose_graph_backend(poses, closures, device="cpu")
    gt = seq.gt_poses[vo["frame_ids"]]
    ate_vo = ate_rmse(poses[:, :3, 3], gt[:, :3, 3])
    ate_pg = ate_rmse(opt[:, :3, 3], gt[:, :3, 3])
    print(f"config 4: {len(cands)} proposed, {len(closures)} verified, "
          f"ATE {ate_vo:.3f} -> {ate_pg:.3f} m")
    assert np.isfinite(ate_pg)
    assert ate_pg < ate_vo, (ate_vo, ate_pg)


def test_posegraph_closure_under_high_drift(disk, vo, jax_draws):
    """Port copy of tests/test_kitti_synthetic.py::
    test_posegraph_closure_under_high_drift, then the same drifted poses
    through the JAX package's proposal, verification and backend."""
    jseq, seq = disk
    cfg = T.DepthEstimatorConfig(**CFG)
    jcfg = jeval.DepthEstimatorConfig(**CFG)
    ids = vo["frame_ids"]
    drifted = _drifted(vo["poses"])
    gt = seq.gt_poses[ids]
    ate_drift = ate_rmse(drifted[:, :3, 3], gt[:, :3, 3])
    assert ate_drift > 2.0, f"drift injection too weak ({ate_drift:.2f} m)"
    kw = dict(PROPOSE, radius=2.0)
    cands = tcl.propose_loop_closures(drifted, **kw)
    assert cands, "drift-aware proposal found nothing"
    assert cands == jeval.propose_loop_closures(drifted, **kw)

    def verify(fn, s, c, a, b, **extra):
        return fn(s, c, ids[a], ids[b], max_features=c.max_features, **extra)

    closures, jclosures = [], []
    for (i, j) in cands:
        z = verify(tcl.closure_constraint_from_frames, seq, cfg, i, j,
                   device="cpu")
        zj = verify(jeval.closure_constraint_from_frames, jseq, jcfg, i, j)
        if z is not None:
            closures.append((i, j, *z))
        if zj is not None:
            jclosures.append((i, j, *zj))
    assert len(closures) >= 1, (cands, "no closure verified")
    assert [c[:2] for c in closures] == [c[:2] for c in jclosures]

    def remeasure(a, b):
        return verify(tcl.closure_constraint_from_frames, seq, cfg, a, b,
                      device="cpu")

    def jremeasure(a, b):
        return verify(jeval.closure_constraint_from_frames, jseq, jcfg, a, b)

    opt = tcl.run_pose_graph_backend(drifted, closures, remeasure=remeasure,
                                     device="cpu")
    jopt = jeval.run_pose_graph_backend(drifted, jclosures,
                                        remeasure=jremeasure)
    ate_pg = ate_rmse(opt[:, :3, 3], gt[:, :3, 3])
    ate_j = ate_rmse(jopt[:, :3, 3], gt[:, :3, 3])
    print(f"config 4b: {len(cands)} proposed, {len(closures)} verified, ATE "
          f"{ate_drift:.3f} -> {ate_pg:.3f} m (JAX on the same poses: "
          f"{ate_j:.3f} m)")
    assert np.isfinite(ate_pg)
    assert ate_pg < 0.7 * ate_drift, (ate_drift, ate_pg)
    assert abs(ate_pg - ate_j) <= 0.05 * ate_j, (ate_pg, ate_j)
