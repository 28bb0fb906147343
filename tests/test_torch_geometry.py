"""Geometry primitives and the local plane fits: the port against the
JAX functions on random batches, within fp32 tolerance (integer and
select outputs exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from mono_lidar_depth_tpu.core import geometry as jg, planefit as jp
from mono_lidar_depth_tpu_torch.core import geometry as tg, planefit as tp

CAM = dict(width=384, height=128, focal_length=240.0, cx=192.0, cy=64.0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_camera_and_se3():
    rng = np.random.default_rng(0)
    jc, tc = jg.PinholeCamera(**CAM), tg.PinholeCamera(**CAM)
    pts = rng.uniform([-20, -5, -2], [20, 5, 60], (500, 3)).astype(
        np.float32)
    pts[:5, 2] = 0.0
    juv, jin = jc.project(jnp.asarray(pts))
    tuv, tin = tc.project(_t(pts))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-6,
                               atol=1e-4)
    assert np.array_equal(tin.numpy(), np.asarray(jin))
    uv = rng.uniform([0, 0], [384, 128], (500, 2)).astype(np.float32)
    np.testing.assert_allclose(tc.viewing_rays(_t(uv)).numpy(),
                               np.asarray(jc.viewing_rays(jnp.asarray(uv))),
                               atol=1e-6)
    np.testing.assert_array_equal(tc.intrinsics("cpu").numpy(),
                                  np.asarray(jc.intrinsics()))
    A = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    B = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    ta, tb = rng.normal(size=3).astype(np.float32), rng.normal(
        size=3).astype(np.float32)
    j1, j2 = jg.SE3(jnp.asarray(A), jnp.asarray(ta)), jg.SE3(
        jnp.asarray(B), jnp.asarray(tb))
    t1, t2 = tg.SE3(_t(A), _t(ta)), tg.SE3(_t(B), _t(tb))
    for got, want in [(t1.apply(_t(pts)), j1.apply(jnp.asarray(pts))),
                      (t1.inverse().rotation, j1.inverse().rotation),
                      (t1.inverse().translation, j1.inverse().translation),
                      (t1.compose(t2).rotation, j1.compose(j2).rotation),
                      (t1.compose(t2).translation,
                       j1.compose(j2).translation)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_planes_and_rays():
    rng = np.random.default_rng(1)
    p = [rng.normal(size=(400, 3)).astype(np.float32) * 10 for _ in range(3)]
    p[2][:4] = p[0][:4]  # degenerate triangles: zero normal
    jn, jo = jg.plane_from_points(*map(jnp.asarray, p))
    tn, to = tg.plane_from_points(*map(_t, p))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-3)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d[:3, 2] = 0.0
    n = np.asarray(jn).copy()
    n[:3] = [0.0, 0.0, 1.0]  # parallel rays: depth -inf
    o = np.zeros_like(d)
    jpt, jd = jg.ray_plane_intersection(jnp.asarray(n), jnp.asarray(jo),
                                        jnp.asarray(o), jnp.asarray(d))
    tpt, td = tg.ray_plane_intersection(_t(n), to, _t(o), _t(d))
    finite = np.isfinite(np.asarray(jd))
    assert np.array_equal(np.isfinite(td.numpy()), finite)
    assert not finite[:3].any()
    ok = finite & (np.abs(np.sum(n * d, 1)) > 1e-2)
    np.testing.assert_allclose(td.numpy()[ok], np.asarray(jd)[ok],
                               rtol=1e-4, atol=1e-4)
    coeffs = rng.normal(size=(400, 4)).astype(np.float32)
    coeffs[0, :3] = 0.0
    np.testing.assert_allclose(
        tg.point_plane_distance(_t(p[0]), _t(coeffs)).numpy(),
        np.asarray(jg.point_plane_distance(jnp.asarray(p[0]),
                                           jnp.asarray(coeffs))),
        rtol=1e-5, atol=1e-4)


def _sym(rng, n):
    A = rng.normal(size=(n, 3, 3))
    S = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    S[:4] = np.eye(3, dtype=np.float32) * 2.0  # all-equal eigenvalues
    S[4:8] = np.diag([1.0, 1.0, 3.0]).astype(np.float32)  # repeated pair
    return S


def test_sym3x3_eigensolvers():
    rng = np.random.default_rng(2)
    S = _sym(rng, 300)
    want = np.linalg.eigvalsh(S.astype(np.float64))
    jv = np.asarray(jg.sym3x3_eigenvalues(jnp.asarray(S)))
    tv = tg.sym3x3_eigenvalues(_t(S)).numpy()
    scale = np.abs(want).max(1, keepdims=True)
    np.testing.assert_allclose(tv, jv, atol=1e-5 * scale.max())
    np.testing.assert_allclose(tv / scale, want / scale, atol=1e-4)
    evals, vecs = tg.sym3x3_eigh(_t(S))
    vecs = vecs.numpy().astype(np.float64)
    # Orthonormal rows that diagonalize S (where eigenvalues are distinct).
    np.testing.assert_allclose(vecs @ vecs.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), vecs.shape),
                               atol=1e-4)
    v0 = tg.smallest_eigenvector_sym3x3(_t(S)).numpy()
    j0 = np.asarray(jg.smallest_eigenvector_sym3x3(jnp.asarray(S)))
    distinct = np.min(np.diff(want, axis=1), axis=1) > 1e-2 * scale[:, 0]
    dots = np.abs(np.sum(v0 * j0, axis=1))
    assert (dots[distinct] > 1 - 1e-4).all()
    resid = np.einsum("nij,nj->ni", S, v0) - want[:, :1] * v0
    assert (np.linalg.norm(resid[distinct], axis=1)
            < 1e-3 * scale[distinct, 0]).all()


def _neighbor_sets(rng, N=300, K=40):
    pts = rng.uniform([-3, -2, 5], [3, 2, 30], (N, K, 3)).astype(np.float32)
    pts[: N // 2, :, 2] = 12.0 + 0.3 * pts[: N // 2, :, 0]  # planar half
    mask = rng.random((N, K)) < 0.7
    mask[:5] = False
    mask[5:10, 3:] = False  # three points or fewer
    return pts, mask


def test_triangles_and_planarity():
    pts, mask = _neighbor_sets(np.random.default_rng(3))
    for fn in ("max_spanning_triangle", "first_three_points"):
        j = getattr(jp, fn)(jnp.asarray(pts), jnp.asarray(mask))
        t = getattr(tp, fn)(_t(pts), _t(mask))
        assert np.array_equal(t.ok.numpy(), np.asarray(j.ok))
        ok = np.asarray(j.ok)
        assert np.array_equal(t.corners.numpy()[ok], np.asarray(j.corners)[ok])
        planar_j = np.asarray(jp.check_planar(j.corners, 0.1))
        planar_t = tp.check_planar(t.corners, 0.1).numpy()
        assert np.array_equal(planar_t[ok], planar_j[ok])


@pytest.mark.parametrize("fit", ["mestimator", "least_squares", "pca"])
def test_plane_fits(fit):
    rng = np.random.default_rng(4)
    pts, mask = _neighbor_sets(rng)
    if fit == "mestimator":
        prior = rng.uniform(0.05, 2.0, mask.shape).astype(np.float32)
        j = jp.mestimator_plane(jnp.asarray(pts), jnp.asarray(mask),
                                prior_dist=jnp.asarray(prior))
        t = tp.mestimator_plane(_t(pts), _t(mask), prior_dist=_t(prior))
    elif fit == "least_squares":
        j = jp.least_squares_plane(jnp.asarray(pts), jnp.asarray(mask))
        t = tp.least_squares_plane(_t(pts), _t(mask))
    else:
        j = jp.pca_classify(jnp.asarray(pts), jnp.asarray(mask), 0.005,
                            15.0, 0.5)
        t = tp.pca_classify(_t(pts), _t(mask), 0.005, 15.0, 0.5)
        for name in ("is_plane", "is_point", "is_linear", "is_cubic"):
            assert np.mean(getattr(t, name).numpy()
                           == np.asarray(getattr(j, name))) > 0.99
    np.testing.assert_allclose(t.anchor.numpy(), np.asarray(j.anchor),
                               atol=1e-4)
    has = mask.sum(1) >= 3
    dots = np.abs(np.sum(t.normal.numpy() * np.asarray(j.normal), 1))
    assert np.median(dots[has]) > 1 - 1e-6
    assert np.mean(dots[has] > 1 - 1e-3) > 0.97
    if fit != "pca":
        assert np.array_equal(t.ok.numpy(), np.asarray(j.ok))


def test_xz_flatness():
    pts, mask = _neighbor_sets(np.random.default_rng(5))
    for thr in (0.0, 0.3, 2.0):
        j = np.asarray(jp.check_xz_flatness(jnp.asarray(pts),
                                            jnp.asarray(mask), thr))
        t = tp.check_xz_flatness(_t(pts), _t(mask), thr).numpy()
        assert np.array_equal(t, j)
