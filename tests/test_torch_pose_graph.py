"""The port's pose graph (vo/pose_graph.py) against the JAX package's, on
the CPU, from the same numpy inputs.

Bars, measured first:
  * `_edge_lin`: residuals and Jacobians within 1e-5 of their largest
    entry on random poses whose residual rotations stay under 2.5 rad
    (measured 4e-7; toward pi the rotation log is ill-conditioned and the
    two packages part), 2e-6 absolute near the identity;
  * `_affine_scan`: within 1e-5 of the largest value (measured 1.4e-7);
  * the chain preconditioner's M^-1 r: within 1e-4 of the largest value;
  * `graph_cost`, `sequential_edges`: fp32 rounding (rtol 1e-5);
  * `optimize_pose_graph`: positions within a share of the trajectory's
    extent and rotations within an angle of JAX's, per graph, each bar a
    few times what was measured.  The 40-pose circle solved to
    convergence agrees to 1.4e-7 of the extent; the straight 4541-pose
    chain at 2 GN iterations to 1.2e-7 and 3.1e-5 rad.  Where fp32 itself
    cannot settle the answer the two fp32 runs still agree far closer than
    either agrees with a float64 run of the port: the circle at the
    reference tests' 4 and 10 GN iterations (3.2e-4 and 3.1e-5 of the
    extent against float64's 5.4e-3 and 7.5e-4) and a drifted 220-pose
    loop (1.4e-4 against 7.2e-3, at 20 and at 40 GN iterations alike).
    The CG iteration count is not compared.
The reference's own bars of tests/test_pose_graph.py are held on the
port's result too, and the odometry-bias tests are ported with theirs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mono_lidar_depth_tpu.eval import kitti_eval as jeval
from mono_lidar_depth_tpu.vo import pose_graph as J
from mono_lidar_depth_tpu_torch.vo import closures as tcl
from mono_lidar_depth_tpu_torch.vo import metrics as tmetrics
from mono_lidar_depth_tpu_torch.vo import pose_graph as T

import test_pose_graph as ref
import torch_parity  # noqa: F401  (one torch thread per worker)

KITTI00_POSES = 4541


def _port(g: J.PoseGraph) -> T.PoseGraph:
    return T.PoseGraph(*(torch.from_numpy(np.array(x)) for x in g))


def _rot(rng, n, scale):
    """n rotation matrices exp(scale * normal) in numpy float32."""
    w = rng.normal(size=(n, 3)) * scale
    th = np.linalg.norm(w, axis=1, keepdims=True)
    k = w / np.maximum(th, 1e-12)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    th = th[:, :, None]
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    return R.astype(np.float32)


def _angle(Ra, Rb):
    """Largest rotation angle (rad) between two stacks of rotations, from
    the skew part of Ra^T Rb (arccos of the trace has a floor of ~3e-4 rad
    on fp32 matrices)."""
    E = np.asarray(Ra, np.float64).transpose(0, 2, 1) @ np.asarray(
        Rb, np.float64)
    return float((np.linalg.norm(E - E.transpose(0, 2, 1), axis=(1, 2))
                  / (2 * np.sqrt(2))).max())


@pytest.mark.parametrize("scale,near", [(0.3, False), (1e-3, True)])
def test_edge_lin_matches_jax(scale, near):
    rng = np.random.default_rng(3)
    E = 64
    Ri = _rot(rng, E, scale if not near else 1.0)
    if near:  # poses and measurement near each other: residual ~ 0
        Rj = Ri @ _rot(rng, E, scale)
        ti = rng.normal(size=(E, 3)).astype(np.float32)
        tj = ti + scale * rng.normal(size=(E, 3)).astype(np.float32)
        ZR = np.einsum("eji,ejk->eik", Ri, Rj) @ _rot(rng, E, scale)
        Zt = np.einsum("eji,ej->ei", Ri, tj - ti).astype(np.float32)
    else:
        Rj, ZR = _rot(rng, E, scale), _rot(rng, E, scale)
        ti, tj, Zt = (5 * rng.normal(size=(E, 3)).astype(np.float32)
                      for _ in range(3))
    args = [np.ascontiguousarray(a, np.float32)
            for a in (Ri, ti, Rj, tj, ZR, Zt)]
    want = jax.vmap(J._edge_lin)(*map(jnp.asarray, args))
    got = T._edge_lin(*map(torch.from_numpy, args))
    for name, g, w in zip(("r0", "Ji", "Jj"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        if name == "r0" and not near:
            assert np.linalg.norm(w[:, 3:], axis=1).max() < 2.5
        bar = 2e-6 if near else 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, atol=bar, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("N", [1, 255, 256, 257, 600])
def test_affine_scan_matches_jax(N):
    rng = np.random.default_rng(N)
    A = (0.3 * rng.normal(size=(N, 6, 6))).astype(np.float32)
    b = rng.normal(size=(N, 6)).astype(np.float32)
    want = np.asarray(J._affine_scan(jnp.asarray(A), jnp.asarray(b)))
    got = T._affine_scan(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    # and against the recurrence folded element by element with
    # `_affine_combine`, in float64
    A64, b64 = torch.from_numpy(A).double(), torch.from_numpy(b).double()
    acc = (torch.zeros(6, 6, dtype=torch.float64), b64[0])
    seq = [acc[1]]
    for k in range(1, N):
        acc = T._affine_combine(acc, (A64[k], b64[k]))
        seq.append(acc[1])
    np.testing.assert_allclose(got, torch.stack(seq).numpy(),
                               atol=1e-5 * np.abs(want).max(), rtol=0)


def _chain_system(N, rng):
    """Chain blocks of a real graph: the circle of tests/test_pose_graph.py
    (N = 40) or a drifted 600-pose loop."""
    g = (ref._build_graph(rng)[0] if N == 40
         else _loop_graph(N, np.random.default_rng(N)))
    gt = _port(g)
    lin = T._linearize(gt, 0, 8, 0.5)
    return T._chain_blocks(gt, lin)


@pytest.mark.parametrize("N", [40, 600])
def test_chain_preconditioner_matches_jax(N):
    rng = np.random.default_rng(11)
    D, B = _chain_system(N, rng)
    r = rng.normal(size=(N, 6)).astype(np.float32)
    want = np.asarray(J._chain_preconditioner(
        jnp.asarray(D.numpy()), jnp.asarray(B.numpy()))(jnp.asarray(r)))
    got = T._chain_preconditioner(D, B)(torch.from_numpy(r)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_graph_cost_and_sequential_edges(rng):
    g, *_ = ref._build_graph(rng)
    want = float(J.graph_cost(g))
    got = float(T.graph_cost(_port(g)))
    assert got == pytest.approx(want, rel=1e-5)
    R_gt, t_gt = ref._circle_traj(20)
    i, j, ZR, Zt = J.sequential_edges(jnp.asarray(R_gt), jnp.asarray(t_gt))
    ti, tj, tZR, tZt = T.sequential_edges(torch.from_numpy(R_gt),
                                          torch.from_numpy(t_gt))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(j))
    np.testing.assert_allclose(tZR.numpy(), np.asarray(ZR), atol=1e-6)
    np.testing.assert_allclose(tZt.numpy(), np.asarray(Zt), rtol=1e-5,
                               atol=1e-5)
    g6 = g._replace(edge_weight=jnp.asarray(np.random.default_rng(2).uniform(
        0, 3, (g.edge_i.shape[0], 6)).astype(np.float32)))
    assert float(T.graph_cost(_port(g6))) == pytest.approx(
        float(J.graph_cost(g6)), rel=1e-5)


def _loop_graph(N, rng, drift=0.02, n_loop=12, radius=60.0):
    """tests/test_pose_graph.py's drifted circle at N poses."""
    th = np.linspace(0, 2 * np.pi, N, endpoint=False)
    t_gt = np.stack([radius * np.cos(th), radius * np.sin(th),
                     np.zeros(N)], 1).astype(np.float32)
    R_gt = np.zeros((N, 3, 3), np.float32)
    for k in range(N):
        fwd = np.array([-np.sin(th[k]), np.cos(th[k]), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        R_gt[k] = np.stack([np.cross(up, fwd), up, fwd], axis=1)
    R_est, t_est, edges = [R_gt[0]], [t_gt[0]], []
    for k in range(1, N):
        ZR, Zt = ref._rel(R_gt[k - 1], t_gt[k - 1], R_gt[k], t_gt[k])
        ZR_n = ZR @ _rot(rng, 1, drift * 0.2)[0]
        Zt_n = Zt + rng.normal(size=3).astype(np.float32) * drift
        R_est.append(R_est[-1] @ ZR_n)
        t_est.append(R_est[-2] @ Zt_n + t_est[-1])
        edges.append((k - 1, k, ZR_n, Zt_n, 1.0))
    for _ in range(n_loop):
        i, j = sorted(rng.choice(N, 2, replace=False))
        if j - i >= 5:
            edges.append((i, j, *ref._rel(R_gt[i], t_gt[i], R_gt[j],
                                          t_gt[j]), 10.0))
    edges.append((N - 1, 0, *ref._rel(R_gt[N - 1], t_gt[N - 1], R_gt[0],
                                      t_gt[0]), 10.0))
    E = len(edges)
    return J.PoseGraph(
        R=jnp.asarray(np.stack(R_est).astype(np.float32)),
        t=jnp.asarray(np.stack(t_est).astype(np.float32)),
        edge_i=jnp.asarray(np.array([e[0] for e in edges], np.int32)),
        edge_j=jnp.asarray(np.array([e[1] for e in edges], np.int32)),
        Z_R=jnp.asarray(np.stack([e[2] for e in edges]).astype(np.float32)),
        Z_t=jnp.asarray(np.stack([e[3] for e in edges]).astype(np.float32)),
        edge_weight=jnp.asarray(np.array([e[4] for e in edges], np.float32)),
        edge_valid=jnp.ones(E, bool),
        fixed=jnp.asarray(np.arange(N) == 0))


def kitti00_graph(seed: int = 0):
    """The 4541-pose graph of __graft_entry__.py: a straight chain, 20
    closures of span 301, 0.05 m position noise."""
    rng = np.random.default_rng(seed)
    Np = KITTI00_POSES
    ang = np.linspace(0, 1.0, Np).astype(np.float32)
    Rg = np.tile(np.eye(3, dtype=np.float32), (Np, 1, 1))
    tg = np.stack([ang * 300, np.zeros(Np, np.float32), ang * 500], 1)
    i, j, Z_R, Z_t = J.sequential_edges(jnp.asarray(Rg), jnp.asarray(tg))
    ci = np.linspace(0, Np - 302, 20).astype(np.int32)
    cj = ci + 301
    cZ_R = np.einsum("nij,nik->njk", Rg[ci], Rg[cj]).astype(np.float32)
    cZ_t = np.einsum("nij,ni->nj", Rg[ci], tg[cj] - tg[ci]).astype(
        np.float32)
    E = (Np - 1) + 20
    return J.PoseGraph(
        R=jnp.asarray(Rg),
        t=jnp.asarray(tg + rng.normal(0, 0.05, tg.shape).astype(np.float32)),
        edge_i=jnp.concatenate([i, jnp.asarray(ci)]),
        edge_j=jnp.concatenate([j, jnp.asarray(cj)]),
        Z_R=jnp.concatenate([Z_R, jnp.asarray(cZ_R)]),
        Z_t=jnp.concatenate([Z_t, jnp.asarray(cZ_t)]),
        edge_weight=jnp.ones((E,), jnp.float32),
        edge_valid=jnp.ones((E,), bool),
        fixed=jnp.arange(Np) == 0)


def _compare(g, pos_share, rot_rad, **kw):
    want = J.optimize_pose_graph(g, **kw)
    got = T.optimize_pose_graph(_port(g), **kw)
    extent = float(np.ptp(np.asarray(g.t), axis=0).max())
    dt = float(np.abs(got.t.numpy() - np.asarray(want.t)).max())
    dr = _angle(got.R.numpy(), want.R)
    print(f"{kw}: positions {dt:.3e} m of a {extent:.1f} m extent "
          f"({dt / extent:.2e}), rotations {dr:.3e} rad")
    assert np.isfinite(got.t.numpy()).all()
    assert dt <= pos_share * extent and dr <= rot_rad, (dt, extent, dr)
    return got


def test_loop_closure_fixes_drift_matches_jax(rng):
    g, R_gt, t_gt = ref._build_graph(rng)
    drift_before = float(np.linalg.norm(np.asarray(g.t)[-1] - t_gt[-1]))
    out = _compare(g, 1e-4, 2e-3, gn_iters=10, cg_iters=80)
    err_after = np.linalg.norm(out.t.numpy() - t_gt, axis=1)
    assert float(T.graph_cost(out)) < float(T.graph_cost(_port(g)))
    assert err_after[-1] < 0.5 * max(drift_before, 1e-9)
    assert err_after.mean() < 0.6
    _compare(g, 1e-6, 1e-5, gn_iters=20, cg_iters=250)  # converged


def test_perfect_graph_stays_matches_jax(rng):
    R_gt, t_gt = ref._circle_traj(20)
    i, j, ZR, Zt = J.sequential_edges(jnp.asarray(R_gt), jnp.asarray(t_gt))
    g = J.PoseGraph(
        R=jnp.asarray(R_gt), t=jnp.asarray(t_gt), edge_i=i, edge_j=j,
        Z_R=ZR, Z_t=Zt, edge_weight=jnp.ones(len(i)),
        edge_valid=jnp.ones(len(i), bool),
        fixed=jnp.asarray(np.arange(20) == 0))
    assert float(T.graph_cost(_port(g))) < 1e-8
    out = _compare(g, 1e-5, 1e-5, gn_iters=3, cg_iters=30)
    np.testing.assert_allclose(out.t.numpy(), t_gt, atol=1e-3)


def test_fixed_pose_untouched_matches_jax(rng):
    g, *_ = ref._build_graph(rng)
    out = _compare(g, 1e-3, 3e-3, gn_iters=4, cg_iters=40)
    np.testing.assert_array_equal(out.R[0].numpy(), np.asarray(g.R[0]))
    np.testing.assert_array_equal(out.t[0].numpy(), np.asarray(g.t[0]))
    _compare(g, 1e-3, 3e-3, gn_iters=4, cg_iters=40, precondition=False)


def test_component_weights_gate_translation_matches_jax(rng):
    g, R_gt, t_gt = ref._build_graph(rng, n_loop=0)
    E, N = g.edge_i.shape[0], g.R.shape[0]
    ZR, Zt = ref._rel(R_gt[N - 1], t_gt[N - 1], R_gt[0], t_gt[0])
    Zt_bad = Zt + np.array([30.0, 0, 0], np.float32)
    w6_all = np.broadcast_to(np.asarray(g.edge_weight)[:, None],
                             (E, 6)).astype(np.float32)
    w_cl = np.array([0, 0, 0, 20, 20, 20], np.float32)
    g6 = g._replace(
        edge_i=jnp.concatenate([g.edge_i, jnp.asarray([N - 1], jnp.int32)]),
        edge_j=jnp.concatenate([g.edge_j, jnp.asarray([0], jnp.int32)]),
        Z_R=jnp.concatenate([g.Z_R, jnp.asarray(ZR, jnp.float32)[None]]),
        Z_t=jnp.concatenate([g.Z_t, jnp.asarray(Zt_bad, jnp.float32)[None]]),
        edge_weight=jnp.asarray(np.concatenate([w6_all, w_cl[None]])),
        edge_valid=jnp.ones(E + 1, bool))
    out = _compare(g6, 1e-3, 3e-3, gn_iters=6, cg_iters=60)
    R, t = out.R.numpy(), out.t.numpy()
    rel_fin = R[N - 1].T @ R[0]
    ang_fin = np.degrees(np.arccos(np.clip(
        (np.trace(ZR.T @ rel_fin) - 1) / 2, -1, 1)))
    assert ang_fin < 1.0, ang_fin
    t_fin = R[N - 1].T @ (t[0] - t[N - 1])
    assert np.linalg.norm(t_fin - Zt_bad) > 15.0


def test_220_pose_loop_matches_jax():
    g = _loop_graph(220, np.random.default_rng(220))
    _compare(g, 5e-4, 3e-3, gn_iters=20, cg_iters=250)


def test_kitti00_scale_graph_matches_jax():
    """N = 4541 at gn_iters=2: the first GN iteration exits CG early, the
    second runs to the cap of 250 in both packages."""
    g = kitti00_graph()
    out = _compare(g, 1e-6, 2e-4, gn_iters=2, cg_iters=250)
    assert float(T.graph_cost(out)) < float(T.graph_cost(_port(g)))


def test_pcg_syncs_every_eighth_iteration(rng, monkeypatch):
    """The host reads the exit flag once per `_CG_CHECK` iterations and
    leaves the loop at the first read after the exit; the state is frozen
    from the exit on, so the iterate does not depend on where the loop
    stops."""
    g, *_ = ref._build_graph(rng)
    gt = _port(g)
    reads = []
    real_bool = bool

    def counting_bool(x):
        if isinstance(x, torch.Tensor):
            reads.append(x)
        return real_bool(x)

    monkeypatch.setattr(T, "bool", counting_bool, raising=False)
    g1, iters = T._gn_step(gt, 0, 10, 250, 0.5, 1e-6, True)
    monkeypatch.undo()
    n = int(iters)
    assert 0 < n < 250
    assert len(reads) == -(-n // T._CG_CHECK)
    monkeypatch.setattr(T, "_CG_CHECK", 1000)  # no read: run to the cap
    g2, iters2 = T._gn_step(gt, 0, 10, 250, 0.5, 1e-6, True)
    assert int(iters2) == n
    assert torch.equal(g1.t, g2.t) and torch.equal(g1.R, g2.R)


def _bias_backend(poses, closures, **kw):
    return tcl.run_pose_graph_backend(poses, closures, device="cpu", **kw)


def test_odometry_bias_estimation_recovers_systematic_drift():
    """Port copy of tests/test_pose_graph.py's bias-estimation test, with
    its bars (measured in JAX: drift 28.7 m, bias-blind 21.7 m,
    bias-estimated 0.61 m)."""
    F = 200
    th = np.linspace(0, 2 * np.pi, F)
    rad = 20.0
    gt = np.tile(np.eye(4), (F, 1, 1))
    for k in range(F):
        c, s = np.cos(th[k]), np.sin(th[k])
        gt[k, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        gt[k, :3, 3] = [rad * np.sin(th[k]), 0.0, rad * (1 - np.cos(th[k]))]
    rng = np.random.default_rng(0)
    yaw = np.radians(1.5)
    dR = tcl._so3_exp(np.array([0.0, yaw, 0.0]))
    drift = [gt[0]]
    for k in range(F - 1):
        rel = np.linalg.inv(gt[k]) @ gt[k + 1]
        rel[:3, :3] = rel[:3, :3] @ dR @ tcl._so3_exp(
            rng.normal(0, 0.002, 3))
        rel[:3, 3] = rel[:3, 3] * 1.03 + rng.normal(0, 0.01, 3)
        drift.append(drift[-1] @ rel)
    drift = np.stack(drift)
    closures = []
    for (i, j) in [(0, 170), (5, 175), (10, 180),
                   (15, 185), (20, 190), (25, 195)]:
        Z = np.linalg.inv(gt[i]) @ gt[j]
        closures.append((i, j,
                         Z[:3, :3] @ tcl._so3_exp(rng.normal(0, 0.003, 3)),
                         Z[:3, 3] + rng.normal(0, 0.05, 3),
                         np.ones(6, np.float32)))
    ate_drift = float(tmetrics.ate_rmse(drift[:, :3, 3], gt[:, :3, 3]))
    assert ate_drift > 20.0
    opt0 = _bias_backend(drift, closures, consistency_filter=False,
                         bias_alternations=0)
    opt2 = _bias_backend(drift, closures, consistency_filter=False)
    ate0 = float(tmetrics.ate_rmse(opt0[:, :3, 3], gt[:, :3, 3]))
    ate2 = float(tmetrics.ate_rmse(opt2[:, :3, 3], gt[:, :3, 3]))
    print(f"drift {ate_drift:.3f} m, bias-blind {ate0:.3f}, "
          f"bias-estimated {ate2:.3f}")
    assert ate2 < 0.1 * ate_drift, (ate_drift, ate0, ate2)
    assert ate2 < 0.5 * ate0, (ate0, ate2)
    clean_closures = []
    for (i, j) in [(0, 170), (10, 180), (20, 190)]:
        Z = np.linalg.inv(gt[i]) @ gt[j]
        clean_closures.append((i, j, Z[:3, :3].copy(), Z[:3, 3].copy()))
    a = _bias_backend(gt.copy(), clean_closures, consistency_filter=False,
                      bias_alternations=0)
    b = _bias_backend(gt.copy(), clean_closures, consistency_filter=False)
    assert np.allclose(a, b, atol=1e-6)


def test_odometry_bias_multilap_alias_rejected():
    """Port copy of tests/test_pose_graph.py's multi-lap alias test, with
    its bars (measured in JAX: drift 9.65, bias-blind 0.50, bias path
    0.28)."""
    LAP, NLAP = 150, 2
    F = LAP * NLAP
    rad = 15.0
    gt = np.tile(np.eye(4), (F, 1, 1))
    for k in range(F):
        a = 2 * np.pi * (k % LAP) / LAP
        c, s = np.cos(a), np.sin(a)
        gt[k, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        gt[k, :3, 3] = [rad * np.sin(a), 0.0, rad * (1 - np.cos(a))]
    rng = np.random.default_rng(1)
    cls = []
    for (i, j) in [(0, 150), (30, 180), (60, 210), (90, 240), (120, 270)]:
        Z = np.linalg.inv(gt[i]) @ gt[j]
        cls.append((i, j, Z[:3, :3] @ tcl._so3_exp(rng.normal(0, 0.003, 3)),
                    Z[:3, 3] + rng.normal(0, 0.05, 3),
                    np.ones(6, np.float32)))

    def integrate(yaw_deg, scale):
        dR = tcl._so3_exp(np.array([0.0, np.radians(yaw_deg), 0.0]))
        r = np.random.default_rng(1)
        out = [gt[0]]
        for k in range(F - 1):
            rel = np.linalg.inv(gt[k]) @ gt[k + 1]
            rel[:3, :3] = rel[:3, :3] @ dR @ tcl._so3_exp(
                r.normal(0, 0.003, 3))
            rel[:3, 3] = rel[:3, 3] * scale + r.normal(0, 0.015, 3)
            out.append(out[-1] @ rel)
        return np.stack(out)

    drift = integrate(0.4, 1.02)
    ate_d = float(tmetrics.ate_rmse(drift[:, :3, 3], gt[:, :3, 3]))
    assert ate_d > 5.0
    o0 = _bias_backend(drift, cls, consistency_filter=False,
                       bias_alternations=0)
    o2 = _bias_backend(drift, cls, consistency_filter=False)
    a0 = float(tmetrics.ate_rmse(o0[:, :3, 3], gt[:, :3, 3]))
    a2 = float(tmetrics.ate_rmse(o2[:, :3, 3], gt[:, :3, 3]))
    print(f"drift {ate_d:.3f} m, bias-blind {a0:.3f}, bias path {a2:.3f}")
    assert a2 < 0.05 * ate_d, (ate_d, a0, a2)
    assert a2 < 0.8 * a0, (a0, a2)
    clean = integrate(0.0, 1.0)
    c0 = _bias_backend(clean, cls, consistency_filter=False,
                       bias_alternations=0)
    c2 = _bias_backend(clean, cls, consistency_filter=False)
    assert np.allclose(c0, c2, atol=1e-6)
    # the same drifted input through the JAX backend
    j2 = jeval.run_pose_graph_backend(drift, cls, consistency_filter=False)
    aj = float(tmetrics.ate_rmse(j2[:, :3, 3], gt[:, :3, 3]))
    print(f"JAX bias path {aj:.3f}")
    assert abs(a2 - aj) <= 0.05 * aj + 0.02
