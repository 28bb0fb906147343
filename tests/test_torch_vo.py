"""VO layer: Lie maps, the 6x6 solver, pose GN, window BA and the whole
odometry step — the port against the JAX functions.

Bars: se3_exp / so3_log / solve6_spd within fp32 tolerance;
estimate_pose_gn and run_ba on the same problem within 1e-4; the slice
as a whole — 6 frames of odometry_step from the same mid-sequence
state (carried over with `state_from_numpy`), JAX's RANSAC draws
injected — per-frame R_cw / t_cw within 1e-3 (rotation entries,
translation in m), the diagnostics' track and inlier counts equal and
the mean reprojection error within 1e-4 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import (R_LC, SMALL, jax_ransac_draws, to_numpy, to_port)
import mono_lidar_depth_tpu as J
from mono_lidar_depth_tpu.tracks.pipeline import FrameInput as JFrame
from mono_lidar_depth_tpu.vo import ba as jba, lie as jlie, linalg6 as jl6
from mono_lidar_depth_tpu.vo import pipeline as jvo, pose as jpose
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch.convert import state_to_numpy
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.vo import ba as tba, lie as tlie
from mono_lidar_depth_tpu_torch.vo import linalg6 as tl6, pose as tpose

CAM = dict(width=384, height=128, focal_length=240.0, cx=192.0, cy=64.0)
JCAM, TCAM = J.PinholeCamera(**CAM), T.PinholeCamera(**CAM)


def _phis(rng):
    axes = rng.normal(size=(64, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0, 3.0, 40), [0.0, 1e-7, 1e-4],
                             np.pi - rng.uniform(0, 1e-3, 21)])
    return (axes * angles[:, None]).astype(np.float32)


def test_lie_maps():
    rng = np.random.default_rng(0)
    phi = _phis(rng)
    xi = np.concatenate([rng.normal(size=(64, 3)), phi], 1).astype(
        np.float32)
    jR, jt = jlie.se3_exp(jnp.asarray(xi))
    tR, tt = tlie.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=2e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-5)
    jphi = np.asarray(jlie.so3_log(jR))
    tphi = tlie.so3_log(torch.tensor(np.asarray(jR))).numpy()
    # Near theta = pi the log is ill-conditioned in fp32 (the axis comes
    # from sqrt((diag + 1) / 2)): compare as rotations there.
    ok = np.abs(np.linalg.norm(jphi, axis=1) - np.pi) > 1e-2
    np.testing.assert_allclose(tphi[ok], jphi[ok], atol=1e-5)
    np.testing.assert_allclose(
        tlie.so3_exp(torch.from_numpy(tphi)).numpy(),
        np.asarray(jlie.so3_exp(jnp.asarray(jphi))), atol=1e-3)
    jlog = np.asarray(jlie.se3_log(jR, jt))
    tlog = tlie.se3_log(torch.tensor(np.asarray(jR)),
                        torch.tensor(np.asarray(jt))).numpy()
    np.testing.assert_allclose(tlog[ok], jlog[ok], atol=1e-4)


def test_solve6_spd():
    rng = np.random.default_rng(1)
    for _ in range(20):
        A = rng.normal(size=(6, 6))
        H = (A @ A.T + 0.5 * np.eye(6)).astype(np.float32)
        g = rng.normal(size=6).astype(np.float32)
        want = np.linalg.solve(H.astype(np.float64), g.astype(np.float64))
        j = np.asarray(jl6.solve6_spd(jnp.asarray(H), jnp.asarray(g)))
        t = tl6.solve6_spd(torch.from_numpy(H), torch.from_numpy(g)).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(t, j, atol=1e-4 * scale)
        np.testing.assert_allclose(t, want, atol=1e-4 * scale)
        np.testing.assert_allclose(
            tl6.inv6_spd(torch.from_numpy(H)).numpy(),
            np.asarray(jl6.inv6_spd(jnp.asarray(H))), atol=1e-3,
            rtol=1e-4)


def _gn_problem(rng, N=256):
    X = rng.uniform([-10, -3, 5], [10, 3, 50], (N, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.005])))
    t = np.array([0.1, -0.05, 0.8], np.float32)
    p = X @ R.T + t
    uv = np.stack([240 * p[:, 0] / p[:, 2] + 192,
                   240 * p[:, 1] / p[:, 2] + 64], 1)
    uv += rng.normal(0, 0.3, uv.shape)
    uv[:20] += rng.uniform(20, 40, (20, 2))  # gross outliers
    valid = rng.random(N) < 0.95
    return X, uv.astype(np.float32), valid


def test_estimate_pose_gn():
    X, uv, valid = _gn_problem(np.random.default_rng(2))
    j = jpose.estimate_pose_gn(JCAM, jnp.asarray(X), jnp.asarray(uv),
                               jnp.asarray(valid))
    t = tpose.estimate_pose_gn(TCAM, torch.from_numpy(X),
                               torch.from_numpy(uv), torch.from_numpy(valid))
    np.testing.assert_allclose(t.rotation.numpy(), np.asarray(j.rotation),
                               atol=1e-4)
    np.testing.assert_allclose(t.translation.numpy(),
                               np.asarray(j.translation), atol=1e-4)
    assert np.array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.num_inliers) == int(j.num_inliers) > 200
    np.testing.assert_allclose(float(t.mean_error), float(j.mean_error),
                               rtol=1e-4)
    np.testing.assert_allclose(t.hessian.numpy(), np.asarray(j.hessian),
                               rtol=1e-3, atol=1e-2)


def _ba_problem(rng, K=5, L=256):
    lm = rng.uniform([-10, -3, 5], [10, 3, 50], (L, 3)).astype(np.float32)
    Rs, ts, uvs, ds = [], [], [], []
    for k in range(K):
        R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.01 * k, 0.0])))
        t = np.array([0.0, 0.0, -1.0 * k], np.float32)
        p = lm @ R.T + t
        uvs.append(np.stack([240 * p[:, 0] / p[:, 2] + 192,
                             240 * p[:, 1] / p[:, 2] + 64], 1)
                   + rng.normal(0, 0.5, (L, 2)))
        ds.append(p[:, 2] + rng.normal(0, 0.05, L))
        # perturbed initial poses
        Rs.append(R @ np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, 0.003, 3).astype(np.float32)))))
        ts.append(t + rng.normal(0, 0.05, 3))
    obs_mask = rng.random((K, L)) < 0.9
    return dict(
        R=np.stack(Rs).astype(np.float32), t=np.stack(ts).astype(np.float32),
        landmarks=(lm + rng.normal(0, 0.1, lm.shape)).astype(np.float32),
        obs_uv=np.stack(uvs).astype(np.float32), obs_mask=obs_mask,
        depth_prior=np.stack(ds).astype(np.float32),
        depth_mask=obs_mask & (rng.random((K, L)) < 0.6),
        fixed=np.arange(K) == K - 1, lm_valid=rng.random(L) < 0.97)


def test_run_ba():
    pb = _ba_problem(np.random.default_rng(3))
    j = jba.run_ba(JCAM, jba.BAProblem(**{k: jnp.asarray(v)
                                          for k, v in pb.items()}),
                   iters=6, depth_weight=2.0)
    t = tba.run_ba(TCAM, tba.BAProblem(**{k: torch.from_numpy(np.asarray(v))
                                          for k, v in pb.items()}),
                   iters=6, depth_weight=2.0)
    np.testing.assert_allclose(t.problem.R.numpy(), np.asarray(j.problem.R),
                               atol=1e-4)
    np.testing.assert_allclose(t.problem.t.numpy(), np.asarray(j.problem.t),
                               atol=1e-4)
    np.testing.assert_allclose(t.problem.landmarks.numpy(),
                               np.asarray(j.problem.landmarks), atol=1e-3)
    np.testing.assert_allclose(float(t.final_cost), float(j.final_cost),
                               rtol=1e-4)
    assert float(j.final_cost) < 0.5 * float(j.initial_cost)


# ---------------------------------------------------------------- slice

def _world(rng):
    """Ground (1.5 m below the camera) and facades flanking the road."""
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
    return np.concatenate(parts).astype(np.float32)


def _sequence(rng, F, M, P):
    """Clouds (lidar frame) and persistent tracks of a camera driving
    1 m per frame with a slight yaw."""
    world = _world(rng)
    lm = world[rng.choice(len(world), M, replace=False)]
    out, prev = [], None
    R_wc, c = np.eye(3), np.zeros(3)
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.01, 0.0])), np.float64)
    for f in range(F + 1):
        R_cw, t_cw = R_wc.T, -R_wc.T @ c
        p_cam = world @ R_cw.T + t_cw
        cloud = np.zeros((P, 3), np.float32)
        n = min(len(p_cam), P)
        cloud[:n] = (p_cam @ R_LC)[:n]
        cvalid = np.zeros(P, bool)
        cvalid[:n] = True
        l_cam = lm @ R_cw.T + t_cw
        z = np.maximum(l_cam[:, 2], 1e-3)
        uv = (np.stack([240 * l_cam[:, 0] / z + 192,
                        240 * l_cam[:, 1] / z + 64], 1)
              + rng.normal(0, 0.2, (M, 2))).astype(np.float32)
        vis = ((l_cam[:, 2] > 1) & (uv[:, 0] > 2) & (uv[:, 0] < 382)
               & (uv[:, 1] > 2) & (uv[:, 1] < 126))
        if prev is not None:
            out.append(dict(cloud=cloud, cloud_valid=cvalid,
                            ids=np.arange(M, dtype=np.int32),
                            ids_valid=vis & prev[1], uv_new=uv,
                            uv_prev=prev[0], stamp=np.float32(f)))
        prev = (uv, vis)
        R_wc = R_wc @ dR
        c = c + R_wc @ np.array([0.0, 0.0, 1.0])
    return out


def test_odometry_step_six_frames():
    cfg_kw = dict(SMALL)
    jcfg, tcfg = J.DepthEstimatorConfig(**cfg_kw), T.DepthEstimatorConfig(
        **cfg_kw)
    ocfg_kw = dict(ba_window=5, ba_iters=5)
    jocfg, tocfg = jvo.OdometryConfig(**ocfg_kw), T.OdometryConfig(**ocfg_kw)
    M, P = cfg_kw["max_features"], cfg_kw["max_points"]
    jT = J.SE3(jnp.asarray(R_LC), jnp.zeros(3, jnp.float32))
    tT = T.SE3(torch.from_numpy(R_LC), torch.zeros(3))
    seq = _sequence(np.random.default_rng(7), 9, M, P)
    keys = jax.random.split(jax.random.PRNGKey(0), len(seq))

    # JAX runs the first three frames; the port starts from that state.
    state = jvo.OdometryState.create(jcfg, jocfg, M, 8)
    for k in range(3):
        state, *_ = jvo.odometry_step(
            jcfg, jocfg, JCAM, jT, state,
            JFrame(**{n: jnp.asarray(v) for n, v in seq[k].items()},
                   rng=keys[k]))
    tstate = to_port(state)
    for k in range(3, 9):
        f = seq[k]
        state, jR, jt, jdiag = jvo.odometry_step(
            jcfg, jocfg, JCAM, jT, state,
            JFrame(**{n: jnp.asarray(v) for n, v in f.items()}, rng=keys[k]))
        draws = jax_ransac_draws(keys[k], f["cloud_valid"],
                                 tcfg.ransac_subsample_points,
                                 tcfg.ransac_num_hypotheses)
        tstate, tR, tt, tdiag = T.odometry_step(
            tcfg, tocfg, TCAM, tT, tstate,
            T.FrameInput(**{n: torch.tensor(v) for n, v in f.items()},
                         rng=RansacDraws(*draws)))
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
        jdiag, tdiag = np.asarray(jdiag), tdiag.numpy()
        assert np.array_equal(tdiag[:2], jdiag[:2]), (k, tdiag, jdiag)
        assert abs(tdiag[2] - jdiag[2]) < 1e-4
        assert jdiag[1] >= 12  # the motion solve was accepted
    # The carried state agrees too (window poses; the track ids exactly).
    tnp, jnp_ = state_to_numpy(tstate), to_numpy(state)
    np.testing.assert_allclose(tnp.win_t, jnp_.win_t, atol=1e-3)
    assert np.array_equal(tnp.tracklets.table.track_id,
                          jnp_.tracklets.table.track_id)
    assert int(tnp.frame_idx) == int(jnp_.frame_idx) == 9


def test_run_odometry_matches():
    """The host loop from a fresh state, 4 frames, draws injected."""
    cfg_kw = dict(SMALL)
    ocfg_kw = dict(ba_window=5, ba_iters=5)
    M, P = cfg_kw["max_features"], cfg_kw["max_points"]
    seq = _sequence(np.random.default_rng(8), 4, M, P)
    keys = jax.random.split(jax.random.PRNGKey(1), len(seq))
    jposes, jdiags = jvo.run_odometry(
        J.DepthEstimatorConfig(**cfg_kw), jvo.OdometryConfig(**ocfg_kw),
        JCAM, J.SE3(jnp.asarray(R_LC), jnp.zeros(3, jnp.float32)),
        [JFrame(**{n: jnp.asarray(v) for n, v in f.items()}, rng=k)
         for f, k in zip(seq, keys)], max_tracks=M, max_length=8)
    tcfg = T.DepthEstimatorConfig(**cfg_kw)
    tframes = [T.FrameInput(
        **{n: torch.tensor(v) for n, v in f.items()},
        rng=RansacDraws(*jax_ransac_draws(k, f["cloud_valid"],
                                          tcfg.ransac_subsample_points,
                                          tcfg.ransac_num_hypotheses)))
        for f, k in zip(seq, keys)]
    tposes, tdiags = T.run_odometry(
        tcfg, T.OdometryConfig(**ocfg_kw), TCAM,
        T.SE3(torch.from_numpy(R_LC), torch.zeros(3)), tframes,
        max_tracks=M, max_length=8, device="cpu")
    assert tposes.shape == jposes.shape == (4, 4, 4)
    # From a cold start the first frame's motion is unobservable (no
    # previous-frame depths) and the BA window's gauge is weakly held,
    # so fp32 differences grow faster than in the mid-sequence test
    # above: 1.4e-3 by frame 4 (6e-5 at frame 2).  Held to 5e-3 here;
    # the slice's 1e-3 bar is test_odometry_step_six_frames.
    np.testing.assert_allclose(tposes, jposes, atol=5e-3)
    for td, jd in zip(tdiags, jdiags):
        assert np.array_equal(td[:2], np.asarray(jd)[:2])
