"""RANSAC, histogram segmentation and the depth estimator: the port
against the JAX functions at the small size.

Bars: RANSAC with JAX's draws injected — inlier_mask and ok exact,
coeffs within 1e-5; filter_points_min_dist_blob exact; estimate_depths
and estimate_depths_pair — >= 99.9% of codes agree and depths on
agreeing successes within 5e-3 relative (the TPU-vs-CPU bars of
tests_tpu/test_tpu_parity.py (b)).  On the CPU the two agree far more
tightly than that: every code is equal and the depths agree to a few
f32 ulps, and the tests also hold that.  Road-pass depths are the
exception: their fp32 plane fit is ill-conditioned, so they are held
lane by lane against a float64 witness (`_assert_depths_agree`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (CAMERA, R_LC, SMALL, T_LC, aligned,
                          assert_on_f64_fit, assert_trees_equal,
                          f64_plane_fit, fit_bound, jax_ransac_draws,
                          to_numpy, to_port)
import mono_lidar_depth_tpu as J
from mono_lidar_depth_tpu.core import depth_estimator as JDE
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.core.histogram import (
    filter_points_min_dist_blob as jax_blob)
from mono_lidar_depth_tpu.io.kitti import make_synthetic_scan, pad_cloud
from mono_lidar_depth_tpu_torch.convert import state_to_numpy
from mono_lidar_depth_tpu_torch.core import ransac as tr
from mono_lidar_depth_tpu_torch.core.histogram import (
    filter_points_min_dist_blob as torch_blob)

JCAM = J.PinholeCamera(**CAMERA)
TCAM = T.PinholeCamera(**CAMERA)
JT = J.SE3(jnp.asarray(R_LC), jnp.asarray(T_LC))
TT = T.SE3(torch.from_numpy(R_LC), torch.from_numpy(T_LC))
P, M = SMALL["max_points"], SMALL["max_features"]
S_SUB, N_HYP = SMALL["ransac_subsample_points"], SMALL["ransac_num_hypotheses"]


def _scene(seed):
    rng = np.random.default_rng(seed)
    n = P - 500
    cloud, valid = pad_cloud(make_synthetic_scan(rng, n), n, P)
    uv = rng.uniform([1, 1], [CAMERA["width"] - 2, CAMERA["height"] - 2],
                     (M, 2)).astype(np.float32)
    fvalid = rng.random(M) < 0.95
    return cloud, valid, uv, fvalid


def _ransac_both(cloud, valid, seed):
    key = jax.random.PRNGKey(seed)
    jgp = J.fit_ground_plane_ransac(
        jnp.asarray(cloud), jnp.asarray(valid), key,
        num_hypotheses=N_HYP, subsample=S_SUB)
    sub_idx, picks = jax_ransac_draws(key, valid, S_SUB, N_HYP)
    tgp = T.fit_ground_plane_ransac(
        torch.from_numpy(cloud), torch.from_numpy(valid),
        sub_idx=sub_idx, picks=picks, num_hypotheses=N_HYP,
        subsample=S_SUB)
    return jax.tree.map(np.asarray, jgp), state_to_numpy(tgp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_injected_draws(seed):
    cloud, valid, _, _ = _scene(seed)
    jgp, tgp = _ransac_both(cloud, valid, seed)
    assert np.array_equal(tgp.inlier_mask, jgp.inlier_mask)
    assert bool(tgp.ok) == bool(jgp.ok) and bool(jgp.ok)
    np.testing.assert_allclose(tgp.coeffs, jgp.coeffs, atol=1e-5)


def test_ransac_generator_draws():
    """The port's own draws (torch.Generator) find the same ground."""
    cloud, valid, _, _ = _scene(0)
    jgp, _ = _ransac_both(cloud, valid, 0)
    tgp = T.fit_ground_plane_ransac(
        torch.from_numpy(cloud), torch.from_numpy(valid),
        torch.Generator().manual_seed(0), num_hypotheses=N_HYP,
        subsample=S_SUB)
    assert bool(tgp.ok)
    np.testing.assert_allclose(tgp.coeffs.numpy(), jgp.coeffs, atol=2e-2)


@pytest.mark.parametrize("bin_width,min_count", [(0.3, 3), (0.1, 1),
                                                 (1.0, 5)])
def test_histogram_bitexact(bin_width, min_count):
    rng = np.random.default_rng(11)
    N, K = 512, 88
    # Clustered depths with exact ties and bin-edge values.
    centers = rng.uniform(1, 60, (N, 3))
    which = rng.integers(0, 3, (N, K))
    depths = (np.take_along_axis(centers, which, 1)
              + rng.normal(0, 0.2, (N, K))).astype(np.float32)
    depths[:, :4] = np.round(depths[:, :4] / bin_width) * bin_width
    depths[:16] = 5.0
    depths[16:20] = 1000.0 + np.arange(K)
    mask = rng.random((N, K)) < 0.6
    mask[20:24] = False
    want = jax.tree.map(np.asarray, jax_blob(
        jnp.asarray(depths), jnp.asarray(mask), bin_width, min_count, 502))
    got = torch_blob(torch.from_numpy(depths), torch.from_numpy(mask),
                     bin_width, min_count, 502)
    assert_trees_equal(state_to_numpy(got), want)
    assert want.found.mean() > 0.2


def _road_scene(seed):
    """Flat ground 1.73 m below the lidar with 2 cm of height noise and
    features over the lower image: no clutter, so the road pass succeeds
    with the any-far veto on, as it does on the main path."""
    rng = np.random.default_rng(seed)
    n = P - 500
    r, th = rng.uniform(2, 40, n), rng.uniform(-np.pi / 3, np.pi / 3, n)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       -1.73 + 0.02 * rng.normal(size=n), np.zeros(n)],
                      1).astype(np.float32)
    cloud, valid = pad_cloud(ground, n, P)
    uv = rng.uniform([1, 70], [CAMERA["width"] - 2, CAMERA["height"] - 2],
                     (M, 2)).astype(np.float32)
    return cloud, valid, uv, rng.random(M) < 0.95


def _road_witness(jcfg, jframe, uv, coeffs):
    """The road pass's M-estimator fit of every lane in float64, from
    the same fp32 road-window points: (depth, kappa) per feature.

    The reference fits the plane with a closed-form fp32 3x3
    eigensolver, whose normal has an error of about eps * ev2 / (ev1 -
    ev0); the ray intersection scales it by |c/(n.c) - r/(n.r)|.  kappa
    is that product, so an fp32 road depth is good to about
    kappa * eps, and two fp32 evaluations that round differently (JAX
    and the port) differ by up to a small multiple of it.  The 1/d
    weights of road points on the plane make kappa large: 1e3-1e6."""
    _, nb2 = JDE._gather_two_scales(jcfg, JCAM, jframe, jnp.asarray(uv))
    p = np.asarray(nb2.points_cam, np.float64)
    mask = np.asarray(nb2.mask & nb2.flags)
    n_cam = R_LC.astype(np.float64) @ np.asarray(coeffs[:3], np.float64)
    d_cam = float(coeffs[3]) - n_cam @ T_LC.astype(np.float64)
    dist = np.abs(p @ n_cam + d_cam) / np.linalg.norm(n_cam)
    w = np.where(mask, 1 / np.maximum(dist, 1e-9), 0.0)
    c = (w[..., None] * p).sum(1) / np.maximum(w.sum(1), 1e-300)[:, None]
    q = (p - c[:, None]) * np.sqrt(w)[..., None]
    ev, vec = np.linalg.eigh(np.einsum("nki,nkj->nij", q, q))
    n = vec[..., 0]
    ray = np.column_stack([
        (uv[:, 0] - CAMERA["cx"]) / CAMERA["focal_length"],
        (uv[:, 1] - CAMERA["cy"]) / CAMERA["focal_length"], np.ones(len(uv))])
    nc, nr = (n * c).sum(1), (n * ray).sum(1)
    with np.errstate(all="ignore"):
        amp = np.linalg.norm(c / nc[:, None] - ray / nr[:, None], axis=1)
        return nc / nr, ev[:, 2] / (ev[:, 1] - ev[:, 0]) * amp


# Road depths of JAX and the port differ by at most ROAD_C * kappa *
# eps32 (observed <= 60 on this file's scenes, <= 420 over 16 scenes).
ROAD_C = 1024
EPS32 = float(np.finfo(np.float32).eps)


def _assert_depths_agree(t_est, j_est, witness=None):
    """The bars, plus what the CPU shows: identical codes and counters
    and a median depth difference at the f32 ulp level.

    Road successes (code 16) are held lane by lane when `witness` (see
    `_road_witness`) is given: the port's depth within max(5e-3, ROAD_C
    * kappa * eps32) of JAX's and of the float64 depth, and JAX's own
    depth within the same bound of the float64 depth, which shows that
    the bound measures fp32 arithmetic and not the port.  Without a
    witness road depths keep the 5e-3 bar of every other success."""
    tc, jc = t_est.codes.numpy(), np.asarray(j_est.codes)
    td, jd = t_est.depths.numpy(), np.asarray(j_est.depths)
    assert np.mean(tc == jc) >= 0.999
    assert np.array_equal(tc, jc)
    assert np.array_equal(t_est.counters.numpy(), np.asarray(j_est.counters))
    both = (tc == jc) & (jd > 0)
    assert both.sum() > 0
    rel = np.abs(td - jd) / np.maximum(np.abs(jd), 1e-30)
    road = both & (jc == 16)
    held = both & ~road if witness is not None else both
    assert rel[held].max() < 5e-3
    assert np.median(rel[held]) < 1e-6
    if witness is None or not road.any():
        return
    d64, kappa = witness
    bound = np.maximum(5e-3, ROAD_C * kappa * EPS32)[road]
    for name, err in (("port-jax", rel), ("port-f64", np.abs(td - d64) / d64),
                      ("jax-f64", np.abs(jd - d64) / d64)):
        assert (err[road] <= bound).all(), (name, (err[road] / bound).max())


@pytest.mark.parametrize("overrides", [
    {},
    {"road_any_far_veto": False},
    {"fast_rasterization": True},
    {"grid_collision_rule": "first", "radiusSearch_count_min": 1},
    {"do_use_PCA": True, "plane_estimator_use_mestimator": False,
     "plane_estimator_use_leastsquares": True},
    {"plane_estimator_use_mestimator": False,
     "plane_estimator_use_triangle_maximation": True,
     "do_use_histogram_segmentation": False},
])
def test_estimate_depths(overrides):
    cfg_kw = dict(SMALL, **overrides)
    jcfg, tcfg = J.DepthEstimatorConfig(**cfg_kw), T.DepthEstimatorConfig(
        **cfg_kw)
    cloud, valid, uv, fvalid = _scene(4)
    jest, test, witness = _estimate_both(jcfg, tcfg, cloud, valid, uv,
                                         fvalid, 4)
    _assert_depths_agree(test, jest, witness)
    # The primary pass succeeds; with the any-far veto off, so does the
    # road pass (the scene's clutter vetoes every road window otherwise).
    codes = np.asarray(jest.codes)
    assert (codes == 1).sum() > 0
    if overrides == {"road_any_far_veto": False}:
        assert (codes == 16).sum() > 10


def _estimate_both(jcfg, tcfg, cloud, valid, uv, fvalid, seed):
    """JAX's and the port's estimate_depths from JAX's ground plane, and
    the float64 road witness."""
    jgp, _ = _ransac_both(cloud, valid, seed)
    jgpj = J.GroundPlane(*map(jnp.asarray, jgp))
    jest = J.estimate_depths(jcfg, JCAM, JT, jnp.asarray(cloud),
                             jnp.asarray(valid), jnp.asarray(uv),
                             jnp.asarray(fvalid), jgpj)
    jframe = J.rasterize_cloud(jcfg, JCAM, JT, jnp.asarray(cloud),
                               jnp.asarray(valid), jgpj)
    test = T.estimate_depths(tcfg, TCAM, TT, torch.from_numpy(cloud),
                             torch.from_numpy(valid), torch.from_numpy(uv),
                             torch.from_numpy(fvalid), to_port(jgp))
    return jest, test, _road_witness(jcfg, jframe, uv, jgp.coeffs)


@pytest.mark.parametrize("veto", [True, False])
def test_road_pass_depths(veto):
    """A clutter-free ground scene: the road pass succeeds with the any-
    far veto on (the main-path setting) and off, and its depths are held
    against JAX's and against the float64 fit."""
    cfg_kw = dict(SMALL, road_any_far_veto=veto)
    jcfg, tcfg = J.DepthEstimatorConfig(**cfg_kw), T.DepthEstimatorConfig(
        **cfg_kw)
    cloud, valid, uv, fvalid = _road_scene(0)
    jest, test, witness = _estimate_both(jcfg, tcfg, cloud, valid, uv,
                                         fvalid, 0)
    _assert_depths_agree(test, jest, witness)
    jd = np.asarray(jest.depths)
    road = np.asarray(jest.codes) == 16
    assert road.sum() > 100
    # Observed: 116 of 120 road depths within 5e-3 of JAX's, median
    # 2.3e-7; the other 4 (up to 0.04) within 50 * kappa * eps32.
    rel = np.abs(test.depths.numpy() - jd)[road] / jd[road]
    assert (rel < 5e-3).mean() > 0.95 and np.median(rel) < 1e-6


def test_estimate_depths_pair():
    cfg = dict(SMALL)
    jcfg, tcfg = J.DepthEstimatorConfig(**cfg), T.DepthEstimatorConfig(**cfg)
    outs = []
    for seed in (5, 6):
        cloud, valid, uv, fvalid = _scene(seed)
        jgp, _ = _ransac_both(cloud, valid, seed)
        jgp = J.GroundPlane(*map(jnp.asarray, jgp))
        jframe = J.rasterize_cloud(jcfg, JCAM, JT, jnp.asarray(cloud),
                                   jnp.asarray(valid), jgp)
        outs.append((jframe, jnp.asarray(uv), jnp.asarray(fvalid), jgp))
    (fa, ua, va, ga), (fb, ub, vb, gb) = outs
    j_a, j_b = JDE.estimate_depths_pair(jcfg, JCAM, JT, fa, ua, va, ga,
                                      fb, ub, vb, gb)
    t_a, t_b = T.estimate_depths_pair(
        tcfg, TCAM, TT, to_port(fa), to_port(ua), to_port(va), to_port(ga),
        to_port(fb), to_port(ub), to_port(vb), to_port(gb))
    _assert_depths_agree(t_a, j_a)
    _assert_depths_agree(t_b, j_b)


def test_unported_configurations_raise():
    """Region growing (`do_use_depth_segmentation=True`) used to raise; it
    runs now.  On this unordered cloud the row segmentation finds no
    coherent rows, so every feature falls through to the regular
    pipeline: codes and counters as JAX's (tests/test_torch_rowseg.py
    holds the configuration on row-ordered scans)."""
    kw = dict(SMALL, do_use_depth_segmentation=True)
    jcfg, tcfg = J.DepthEstimatorConfig(**kw), T.DepthEstimatorConfig(**kw)
    cloud, valid, uv, fvalid = _scene(0)
    jest, test, witness = _estimate_both(jcfg, tcfg, cloud, valid, uv,
                                         fvalid, 0)
    _assert_depths_agree(test, jest, witness)
    assert not hasattr(T.core.depth_estimator, "_check_supported")


@pytest.mark.parametrize("options", [
    {"use_refinement": False},
    {"inliers_from_full_cloud": True},
    {"min_z": -1.0, "max_z": 3.0, "distance_threshold": 0.2},
])
def test_ransac_options(options, monkeypatch):
    """Inliers and ok as JAX's.  Without refinement the coefficients are
    the best hypothesis's, within 1e-5 of JAX's.  The refit runs in
    float64 (core/geometry.py `f32`): its plane within fit_bound of
    LAPACK's float64 fit of the same inliers, and within |JAX - float64|
    + fit_bound of JAX's float32 fit (options2: JAX's offset 1.6e-5 from
    the port's)."""
    cloud, valid, _, _ = _scene(7)
    key = jax.random.PRNGKey(7)
    jgp = to_numpy(J.fit_ground_plane_ransac(
        jnp.asarray(cloud), jnp.asarray(valid), key, num_hypotheses=N_HYP,
        subsample=S_SUB, **options))
    sub_idx, picks = jax_ransac_draws(key, valid, S_SUB, N_HYP)
    refits, real = [], tr._ls_plane
    monkeypatch.setattr(tr, "_ls_plane", lambda p, w: refits.append(
        (p.numpy(), w.numpy())) or real(p, w))
    tgp = state_to_numpy(T.fit_ground_plane_ransac(
        torch.from_numpy(cloud), torch.from_numpy(valid), sub_idx=sub_idx,
        picks=picks, num_hypotheses=N_HYP, subsample=S_SUB, **options))
    assert np.array_equal(tgp.inlier_mask, jgp.inlier_mask)
    assert bool(tgp.ok) == bool(jgp.ok)
    if not refits:
        np.testing.assert_allclose(tgp.coeffs, jgp.coeffs, atol=1e-5)
        return
    n64, c64, kappa = f64_plane_fit(*refits[0])
    n64 = aligned(n64, tgp.coeffs[:3])
    jerr, _ = assert_on_f64_fit(tgp.coeffs[:3], jgp.coeffs[:3], n64, kappa,
                                np.bool_(True))
    d64 = -float(n64 @ c64)
    d_bound = fit_bound(kappa) * np.abs(c64).sum() + 2 * np.spacing(
        np.float32(d64))
    assert abs(tgp.coeffs[3] - d64) <= d_bound
    assert abs(tgp.coeffs[3] - jgp.coeffs[3]) <= abs(
        jgp.coeffs[3] - d64) + d_bound


def test_debug_record_and_frame_entry_points():
    """collect_debug, estimate_depths_from_frame, set_all_depths_to_zero
    and the outcome counters."""
    from mono_lidar_depth_tpu.obs.stats import DepthCalcStats as JStats
    from mono_lidar_depth_tpu_torch.obs.stats import DepthCalcStats as TStats

    cfg_kw = dict(SMALL, collect_debug=True)
    jcfg, tcfg = J.DepthEstimatorConfig(**cfg_kw), T.DepthEstimatorConfig(
        **cfg_kw)
    cloud, valid, uv, fvalid = _scene(8)
    jgp, _ = _ransac_both(cloud, valid, 8)
    jgp = J.GroundPlane(*map(jnp.asarray, jgp))
    jframe = J.rasterize_cloud(jcfg, JCAM, JT, jnp.asarray(cloud),
                               jnp.asarray(valid), jgp)
    jest = JDE.estimate_depths_from_frame(jcfg, JCAM, JT, jframe,
                                          jnp.asarray(uv),
                                          jnp.asarray(fvalid), jgp)
    test = T.estimate_depths_from_frame(tcfg, TCAM, TT, to_port(jframe),
                                        torch.from_numpy(uv),
                                        torch.from_numpy(fvalid),
                                        to_port(jgp))
    _assert_depths_agree(test, jest)
    jd, td = to_numpy(jest.debug), state_to_numpy(test.debug)
    for name in ("neighbor_count", "seg_count", "hist_bin", "road_count"):
        assert np.array_equal(getattr(td, name), getattr(jd, name)), name
    for name in ("hist_lower", "hist_upper", "corners"):
        np.testing.assert_allclose(getattr(td, name), getattr(jd, name),
                                   atol=1e-5, err_msg=name)

    zcfg = dict(SMALL, set_all_depths_to_zero=True)
    jz = J.estimate_depths(J.DepthEstimatorConfig(**zcfg), JCAM, JT,
                           jnp.asarray(cloud), jnp.asarray(valid),
                           jnp.asarray(uv), jnp.asarray(fvalid))
    tz = T.estimate_depths(T.DepthEstimatorConfig(**zcfg), TCAM, TT,
                           torch.from_numpy(cloud), torch.from_numpy(valid),
                           torch.from_numpy(uv), torch.from_numpy(fvalid))
    assert_trees_equal(state_to_numpy(tz), to_numpy(jz))

    js, ts = JStats.zeros(), TStats.zeros("cpu")
    for est_j, est_t in ((jest, test), (jz, tz)):
        js, ts = js.update(est_j.counters), ts.update(est_t.counters)
    assert_trees_equal(state_to_numpy(ts), to_numpy(js))
