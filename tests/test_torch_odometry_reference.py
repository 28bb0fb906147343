"""The port's tracker and visual odometry against the plain float64
reference (`tests/reference_odometry.py`, written apart from the port),
on the CPU at a small size: a tracker step on a rendered textured pair,
pose Gauss-Newton from a warm start and from identity (the retry's
start), a 3-frame window bundle adjustment and a whole odometry tail.

Each comparison is run twice: on the port's own float32 inputs, where it
must hold, and on the same inputs rounded to bfloat16, where it must
fail, so that every tolerance is tight enough to see a step down in
precision.  Each tolerance states its reason.
"""

import math
import types

import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu_torch as T
import reference_odometry as R
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as sd
from mono_lidar_depth_tpu_torch.vo import ba as tba
from mono_lidar_depth_tpu_torch.vo import pipeline as vp
from mono_lidar_depth_tpu_torch.vo.pose import estimate_pose_gn

ROUNDED = [False, True]  # the port's inputs as they are / in bfloat16


def bf16(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype) if rounded else x


def expect(within: bool, rounded: bool, what: str) -> None:
    """Within the tolerance on the port's own inputs, outside it once
    they are rounded to bfloat16."""
    assert within == (not rounded), (what, rounded)


# ---------------------------------------------------------------------------
# the tracker


@pytest.fixture(scope="module")
def frames():
    """Three rendered 128x96 grey images of the textured corridor."""
    spec = sd.SyntheticSpec(frames=3, image_width=128, image_height=96,
                            focal=80.0, lidar_rows=8, lidar_cols=100)
    seq = sd.render_sequence(spec, seed=3)
    return [torch.from_numpy(seq.image(k)) for k in range(3)]


@pytest.mark.parametrize("rounded", ROUNDED)
def test_tracker_step(frames, rounded):
    """Two frames of `track_frame` with 64 lanes: from frame 0 to 1 (no
    flow yet), then 1 to 2 from the port's state (the constant-velocity
    guess).  Survival, emit flags, births and ids equal; tracked
    positions within 1e-3 px: float32 sampling and 8 Newton steps per
    level leave up to 3.6e-4 px against float64 at this size, and
    bfloat16 images (3 significant digits) move them by about 1 px."""
    imgs = [bf16(x.to(torch.float32) / 255.0, rounded) for x in frames]
    p = R.TrackerParams()
    state = T.init_tracker(imgs[0], 64, levels=3, cell_size=p.cell_size)
    worst, discrete = 0.0, 0
    for k in (1, 2):
        before = state
        state, out = T.track_frame(before, imgs[k], cell_size=p.cell_size,
                                   patch=p.patch, iters=p.iters)
        survived = state.age >= 2
        ref = R.tracker_step(
            R.grey(frames[k - 1]), R.grey(frames[k]),
            R.TrackerIn(before.uv, before.ids, before.age, before.valid,
                        int(before.next_id), before.flow),
            3, p, occupied=(out.uv_new, survived))
        assert survived.sum() > 10 and ref.born.sum() > 5
        discrete += int((survived != ref.survived).sum()
                        + (out.valid != ref.emit).sum()
                        + (ref.born != (state.age == 1)).sum()
                        + (state.ids.long() != ref.ids)[ref.born].sum()
                        + abs(int(state.next_id) - ref.next_id))
        born = ref.born
        assert torch.equal(state.uv.double()[born], ref.uv[born])
        both = survived & ref.survived
        worst = max(worst, float((out.uv_new.double() - ref.uv_f)[both]
                                 .norm(dim=1).max()))
    if not rounded:
        assert discrete == 0
    expect(worst < 1e-3, rounded, worst)


# ---------------------------------------------------------------------------
# pose Gauss-Newton


CAM = T.PinholeCamera(width=384, height=128, focal_length=240.0, cx=191.6,
                      cy=64.2)
RCAM = R.Camera(240.0, 191.6, 64.2)


def rotation(axis, deg):
    axis = np.asarray(axis, np.float64)
    phi = np.radians(deg) * axis / np.linalg.norm(axis)
    Rm, _ = R.exp_se3(torch.tensor(np.r_[0, 0, 0, phi]))
    return Rm


def scene_points(rng, n):
    """Points 4-40 m ahead of the camera, spread over the image."""
    z = rng.uniform(4, 40, n)
    u = rng.uniform(10, 374, n)
    v = rng.uniform(10, 118, n)
    return np.stack([(u - 191.6) / 240 * z, (v - 64.2) / 240 * z, z], 1)


def project(Rm, t, X):
    p = X @ Rm.T + t
    return np.stack([240 * p[:, 0] / p[:, 2] + 191.6,
                     240 * p[:, 1] / p[:, 2] + 64.2], 1)


@pytest.fixture(scope="module")
def motion():
    """300 landmarks, a frame's motion, noisy pixels with 10% outliers."""
    rng = np.random.default_rng(11)
    X = scene_points(rng, 300)
    Rt = rotation([0.1, 1, 0.05], 3.0).numpy()
    tt = np.array([0.05, -0.02, -0.8])
    uv = project(Rt, tt, X) + rng.normal(0, 0.4, (300, 2))
    out = rng.random(300) < 0.1
    uv[out] += rng.normal(0, 25, (out.sum(), 2))
    valid = rng.random(300) < 0.95
    return X, uv, valid, Rt, tt


@pytest.mark.parametrize("start", ["warm", "identity"])
@pytest.mark.parametrize("rounded", ROUNDED)
def test_pose_gn(motion, start, rounded):
    """`estimate_pose_gn` from a warm start (a motion 0.5 deg and 5 cm
    off, as the last accepted motion is) and from identity (the retry's
    start): inliers equal, pose within 2e-5 deg and 1e-5 m, mean error
    within 1e-5 px.  Float32 Gauss-Newton on 300 points lands about
    1.5e-6 deg and 1e-6 m from the float64 solution; bfloat16 landmarks
    and pixels move it by 7.6e-3 deg and 4.6e-3 m."""
    X, uv, valid, Rt, tt = motion
    if start == "warm":
        R0 = (rotation([1, 0, 0], 0.5).numpy() @ Rt)
        t0 = tt + np.array([0.03, 0.0, 0.04])
    else:
        R0, t0 = np.eye(3), np.zeros(3)
    f32 = torch.float32
    est = estimate_pose_gn(CAM, bf16(torch.tensor(X, dtype=f32), rounded),
                           bf16(torch.tensor(uv, dtype=f32), rounded),
                           torch.tensor(valid),
                           R_init=torch.tensor(R0, dtype=f32),
                           t_init=torch.tensor(t0, dtype=f32), iters=10)
    ref = R.pose_gn(RCAM, torch.tensor(X), torch.tensor(uv),
                    torch.tensor(valid), torch.tensor(R0), torch.tensor(t0),
                    10)
    assert 200 < ref.n_inliers < 290
    rot = float(R.angle_deg(est.rotation.double(), ref.R))
    trans = float((est.translation.double() - ref.t).norm())
    if not rounded:
        assert torch.equal(est.inliers, ref.inliers)
        assert abs(float(est.mean_error) - ref.mean_error) < 1e-5
    expect(rot < 2e-5 and trans < 1e-5, rounded, (rot, trans))


# ---------------------------------------------------------------------------
# the window bundle adjustment


def window(rng, K=3, L=128):
    """K camera-from-world poses 0.8 m apart, L landmarks seen in all of
    them with 0.5 px noise and a few outliers, depth priors on 60% with
    2% noise; the estimate to refine is the truth disturbed."""
    Rs, ts = [], []
    for k in range(K):
        Rk = rotation([0, 1, 0], 1.5 * k).numpy()
        c = np.array([0.1 * k, 0.0, 0.8 * k])  # camera centre
        Rs.append(Rk)
        ts.append(-Rk @ c)
    Xw = scene_points(rng, L) + np.array([0, 0, 2.0])
    obs = np.stack([project(Rs[k], ts[k], Xw) for k in range(K)])
    obs += rng.normal(0, 0.5, obs.shape)
    bad = rng.random((K, L)) < 0.03
    obs[bad] += rng.normal(0, 15, (bad.sum(), 2))
    z = np.stack([(Xw @ Rs[k].T + ts[k])[:, 2] for k in range(K)])
    prior = z * (1 + rng.normal(0, 0.02, z.shape))
    has_d = rng.random((K, L)) < 0.6
    seen = rng.random((K, L)) < 0.9
    Rs_est = [rotation([1, 0.3, 0], 0.3 * k).numpy() @ Rs[k]
              for k in range(K)]
    ts_est = [ts[k] + rng.normal(0, 0.05, 3) * (k > 0) for k in range(K)]
    Xw_est = Xw + rng.normal(0, 0.2, Xw.shape)
    return (np.stack(Rs_est), np.stack(ts_est), Xw_est, obs, seen,
            np.where(has_d, prior, -1.0), has_d & seen)


@pytest.mark.parametrize("rounded", ROUNDED)
def test_window_ba(rounded):
    """`run_ba` over 3 frames and 128 landmarks (the oldest pose fixed, 6
    iterations, depth weight 2): poses within 2e-5 deg and 2e-5 m,
    landmarks within 1e-3 m.  The float32 Schur complement leaves
    6e-7 deg, 1.9e-6 m and 1.3e-4 m against float64 here; bfloat16
    pixels, priors and starting points move them by 2.8e-2 deg, 2.2e-2 m
    and 3.8 m."""
    rng = np.random.default_rng(5)
    Rs, ts, Xw, obs, seen, prior, has_d = window(rng)
    K, L = seen.shape
    fixed = np.arange(K) == K - 1
    lm_ok = seen.sum(0) >= 2
    f32 = torch.float32

    def t32(x):
        return bf16(torch.tensor(x, dtype=f32), rounded)

    problem = tba.BAProblem(
        R=torch.tensor(Rs, dtype=f32), t=t32(ts), landmarks=t32(Xw),
        obs_uv=t32(obs), obs_mask=torch.tensor(seen),
        depth_prior=t32(prior), depth_mask=torch.tensor(has_d),
        fixed=torch.tensor(fixed), lm_valid=torch.tensor(lm_ok))
    got = tba.run_ba(CAM, problem, iters=6, depth_weight=2.0,
                     compute_cost=False).problem
    Rr, tr, Xr = (torch.tensor(Rs), torch.tensor(ts), torch.tensor(Xw))
    for _ in range(6):
        Rr, tr, Xr = R.ba_iteration(
            RCAM, Rr, tr, Xr, torch.tensor(obs), torch.tensor(seen),
            torch.tensor(prior), torch.tensor(has_d), torch.tensor(fixed),
            torch.tensor(lm_ok), 2.0)
    moved = float(R.angle_deg(torch.tensor(Rs), Rr).max())
    assert moved > 0.05  # the BA did work
    rot = float(R.angle_deg(got.R.double(), Rr).max())
    trans = float((got.t.double() - tr).norm(dim=1).max())
    lm = float((got.landmarks.double() - Xr)[torch.tensor(lm_ok)]
               .norm(dim=1).max())
    expect(rot < 2e-5 and trans < 2e-5 and lm < 1e-3, rounded,
           (rot, trans, lm))


# ---------------------------------------------------------------------------
# the odometry tail


def tail_inputs(rng, bad_warm_start: bool):
    """A track table after 8 frames of forward motion (slot 0 the
    current frame), and the odometry state before it: the window's poses,
    the last motion (or, with `bad_warm_start`, one that puts every
    landmark behind the camera, so that the retry from identity has to
    recover)."""
    Tn, Lc, W = 512, 12, 5
    F = 8
    poses = []
    for k in range(F + 1):
        Rk = rotation([0, 1, 0], 0.8 * k).numpy()
        poses.append((Rk, -Rk @ np.array([0.05 * k, 0.0, 0.8 * k])))
    Xw = scene_points(rng, Tn) + np.array([0, 0, 7.0])
    length = rng.integers(1, Lc + 1, Tn)
    active = rng.random(Tn) < 0.85
    uv = np.zeros((Tn, Lc, 2))
    depth = -np.ones((Tn, Lc))
    for j in range(Lc):
        Rk, tk = poses[max(F - j, 0)]
        uv[:, j] = project(Rk, tk, Xw) + rng.normal(0, 0.4, (Tn, 2))
        z = (Xw @ Rk.T + tk)[:, 2]
        has = rng.random(Tn) < 0.7
        depth[:, j] = np.where(has, z * (1 + rng.normal(0, 0.01, Tn)), -1)
    uv[rng.random(Tn) < 0.05, 0] += 30.0
    keep = (np.arange(Lc)[None] < length[:, None]) & active[:, None]
    uv = np.where(keep[..., None], uv, 0.0)
    depth = np.where(keep, depth, -1.0)
    tid = np.where(active, np.arange(Tn), -1)
    R_prev, t_prev = poses[F - 1]
    R_pp, t_pp = poses[F - 2]
    rel_R = R_prev @ R_pp.T
    rel_t = t_prev - rel_R @ t_pp
    if bad_warm_start:
        rel_t = rel_t + np.array([0.0, 0.0, -60.0])
    win = [poses[F - 1 - j] for j in range(W)]
    return dict(track_id=tid, length=length, uv=uv, depth=depth,
                win_R=np.stack([r for r, _ in win]),
                win_t=np.stack([t for _, t in win]), rel_R=rel_R,
                rel_t=rel_t)


@pytest.mark.parametrize("bad_warm_start", [False, True],
                         ids=["warm", "retry"])
@pytest.mark.parametrize("rounded", ROUNDED)
def test_odometry_tail(bad_warm_start, rounded, monkeypatch):
    """`vo/pipeline._odometry_tail` whole, from a table and a state:
    motion tracks, inliers, the retry, acceptance, the window ring and
    the frame count equal; the returned pose, the window after the BA
    and the last motion within 2e-5 deg and 3e-5 m (float32 GN and BA
    against float64 over 384 landmarks: 1.5e-6 deg, 2.8e-6 m), which
    bfloat16 pixels and depths exceed by far (2.8e-2 deg, 1e-2 m)."""
    d = tail_inputs(np.random.default_rng(21), bad_warm_start)
    f32 = torch.float32
    cfg = T.DepthEstimatorConfig(max_features=64)
    ocfg = T.OdometryConfig()
    Tn, Lc = d["uv"].shape[:2]
    state = T.OdometryState.create(cfg, ocfg, Tn, Lc, "cpu")
    state = state._replace(
        win_R=torch.tensor(d["win_R"], dtype=f32),
        win_t=torch.tensor(d["win_t"], dtype=f32),
        win_valid=torch.ones(5, dtype=torch.bool),
        frame_idx=torch.tensor(7, dtype=torch.int32),
        rel_R=torch.tensor(d["rel_R"], dtype=f32),
        rel_t=torch.tensor(d["rel_t"], dtype=f32),
        motion_ok=torch.tensor(not bad_warm_start))
    table = state.tracklets.table._replace(
        track_id=torch.tensor(d["track_id"], dtype=torch.int32),
        length=torch.tensor(d["length"], dtype=torch.int32),
        uv=bf16(torch.tensor(d["uv"], dtype=f32), rounded),
        depth=bf16(torch.tensor(d["depth"], dtype=f32), rounded))
    calls = []
    gn = vp.estimate_pose_gn
    monkeypatch.setattr(vp, "estimate_pose_gn",
                        lambda *a, **k: calls.append(1) or gn(*a, **k))
    new, R_cw, t_cw, diag = vp._odometry_tail(
        cfg, ocfg, CAM, state, types.SimpleNamespace(table=table), None,
        None)
    ref = R.odometry_tail(
        RCAM, R.Table(torch.tensor(d["track_id"]), torch.tensor(d["length"]),
                      torch.tensor(d["uv"], dtype=f32).double(),
                      torch.tensor(d["depth"], dtype=f32).double()),
        R.OdometryIn(state.win_R, state.win_t, state.win_valid, 7,
                     state.rel_R, state.rel_t, not bad_warm_start),
        R.OdometryParams(**ocfg._asdict()))
    assert ref.retry == bad_warm_start and ref.accepted and ref.ran_ba
    assert ref.n_landmarks > 200
    accepted = not torch.equal(new.rel_t, state.rel_t)
    discrete = ((len(calls) == 2) == ref.retry and accepted == ref.accepted
                and int(diag[0]) == ref.n_usable
                and int(new.frame_idx) == ref.frame_idx
                and torch.equal(new.win_valid, ref.win_valid))
    if not rounded:
        assert discrete and int(diag[1]) == ref.n_inliers
    gaps = [(R.angle_deg(R_cw.double(), ref.R_cw).max(),
             (t_cw.double() - ref.t_cw).norm()),
            (R.angle_deg(new.win_R.double(), ref.win_R).max(),
             (new.win_t.double() - ref.win_t).norm(dim=1).max()),
            (R.angle_deg(new.rel_R.double(), ref.rel_R),
             (new.rel_t.double() - ref.rel_t).norm())]
    rot = max(float(g[0]) for g in gaps)
    trans = max(float(g[1]) for g in gaps)
    expect(rot < 2e-5 and trans < 3e-5, rounded, (rot, trans))


def test_rotation_helpers():
    """`angle_deg` reads small angles without acos's loss and `exp_se3`
    is a rotation with the series near zero."""
    Rm = rotation([0.3, 1, -0.2], 1e-5)
    assert float(R.angle_deg(torch.eye(3, dtype=torch.float64), Rm)) == (
        pytest.approx(1e-5, rel=1e-6))
    for deg in (0.0, 1e-7, 30.0):
        Rm = rotation([1, 2, 3], deg)
        assert torch.allclose(Rm @ Rm.T, torch.eye(3, dtype=torch.float64),
                              atol=1e-12)
        assert math.isclose(float(torch.linalg.det(Rm)), 1.0, rel_tol=1e-12)
