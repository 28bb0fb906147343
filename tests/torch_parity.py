"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX side runs on JAX's CPU backend (tests/conftest.py); the port
runs on the CPU, where every kernel wrapper takes its plain PyTorch
version.  Inputs are made with numpy from a seed and handed to both.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mono_lidar_depth_tpu_torch.convert import state_from_numpy

# Tier-1 runs several pytest workers: one torch thread each.
torch.set_num_threads(1)

# The small size the parity tests run at.
SMALL = dict(max_points=8192, max_features=256, image_width=384,
             image_height=128, ransac_num_hypotheses=128,
             ransac_subsample_points=1024)
# lidar frame x forward, y left, z up -> camera z forward, x right, y down
R_LC = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float32)
T_LC = np.array([0.0, -0.08, 0.27], dtype=np.float32)
CAMERA = dict(width=384, height=128, focal_length=240.0, cx=192.0, cy=64.0)


def to_numpy(tree):
    """JAX tree -> the same tree with numpy leaves."""
    return jax.tree.map(np.asarray, tree)


def to_port(tree):
    """JAX tree -> the port's tree on the CPU."""
    return state_from_numpy(to_numpy(tree), "cpu")


def jax_ransac_draws(key, valid, subsample: int, num_hypotheses: int):
    """The draws fit_ground_plane_ransac makes from `key`, computed as
    mono_lidar_depth_tpu/core/ransac.py does, as int64 tensors."""
    k_sub, k_hyp = jax.random.split(key)
    n_valid = jnp.sum(jnp.asarray(valid))
    sub_idx = jax.random.randint(k_sub, (subsample,), 0,
                                 jnp.maximum(n_valid, 1))
    picks = jax.random.randint(k_hyp, (num_hypotheses, 3), 0, subsample)
    return (torch.from_numpy(np.asarray(sub_idx).astype(np.int64)),
            torch.from_numpy(np.asarray(picks).astype(np.int64)))


def inject_jax_frame_draws(mp, seq, cfg) -> None:
    """Make the port's sequence evaluators (eval/kitti_eval.py) draw the
    JAX package's RANSAC samples: prime_state's PRNGKey(1234) and frame
    f's key of `_key_chain`, drawn over each frame's cloud; and give the
    tracker the JAX package's f32 image (XLA multiplies by 1/255, eager
    PyTorch divides).  `mp` is a pytest MonkeyPatch."""
    from mono_lidar_depth_tpu.eval import kitti_eval as jeval
    from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
    from mono_lidar_depth_tpu_torch.eval import kitti_eval as teval

    keys = [jax.random.PRNGKey(1234)] + list(jeval._key_chain(len(seq)))
    draws = [RansacDraws(*jax_ransac_draws(
        key, np.arange(cfg.max_points) < count, cfg.ransac_subsample_points,
        cfg.ransac_num_hypotheses))
        for key, (_, count) in zip(keys, seq.scans(cfg.max_points))]
    mp.setattr(teval, "_frame_seed", lambda seed, f: f)
    mp.setattr(teval, "_frame_rng", lambda f, device: RansacDraws(
        *(x.to(device) for x in draws[f])))
    mp.setattr(teval, "_dev_img", lambda img: torch.from_numpy(
        np.array(jeval._dev_img(jnp.asarray(img.numpy())))))


def assert_trees_equal(got, want, path="", atol=0.0, rtol=0.0):
    """Field-by-field comparison of a port tree (numpy leaves) and a JAX
    tree (numpy leaves) with the same field names."""
    if hasattr(want, "_fields"):
        assert got._fields == want._fields, path
        for name in want._fields:
            assert_trees_equal(getattr(got, name), getattr(want, name),
                               f"{path}.{name}", atol, rtol)
        return
    if want is None:
        assert got is None, path
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]", atol, rtol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if atol == 0.0 and rtol == 0.0 or want.dtype.kind in "biu":
        mism = np.argwhere(got != want)
        assert mism.size == 0, (f"{path}: {len(mism)} mismatches, first at "
                                f"{mism[:3].tolist()}")
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=path)


class OnCard:
    """Stands in for a tensor on a card in a kernel wrapper's argument
    checks, which read only these attributes and run before any library
    is loaded."""

    def __init__(self, real, dtype=None, contiguous=True, shape=None):
        self.device = torch.device("cuda", 0)
        self.dtype = dtype or real.dtype
        self.shape = torch.Size(shape or real.shape)
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous


# The port's fits run in float64 and round once (core/geometry.py `f32`).
# Against LAPACK's float64 fit of the same formula their normals lie
# within FIT_ULP float32 ulp of 1, or, on windows whose two smallest
# eigenvalues nearly coincide, within the closed form's own float64 error
# EPS64 * kappa**2 (kappa = ev2 / (ev1 - ev0); tests/test_torch_fit_order.py
# measures 0.29 of it).
EPS64 = float(np.finfo(np.float64).eps)
FIT_ULP = 2.0 * 2.0 ** -24


def f64_plane_fit(points, weights):
    """LAPACK's float64 fit of the port's plane formula (weighted
    centroid, smallest eigenvector of the weighted scatter) on its
    float32 inputs: points [..., K, 3], weights [..., K] -> (normal
    [..., 3], center [..., 3], kappa [...])."""
    p = np.asarray(points, np.float64)
    w = np.asarray(weights, np.float64)
    ws = w.sum(-1)
    c = (w[..., None] * p).sum(-2) / np.where(ws == 0, 1.0, ws)[..., None]
    q = (p - c[..., None, :]) * np.sqrt(w)[..., None]
    ev, vec = np.linalg.eigh(np.einsum("...ki,...kj->...ij", q, q))
    with np.errstate(divide="ignore", invalid="ignore"):
        kappa = ev[..., 2] / (ev[..., 1] - ev[..., 0])
    return vec[..., 0], c, kappa


def fit_bound(kappa):
    """How far a port normal may lie from f64_plane_fit's, per component."""
    return np.maximum(FIT_ULP, EPS64 * np.nan_to_num(kappa, nan=np.inf,
                                                      posinf=np.inf) ** 2)


def aligned(normal, like):
    """normal [..., 3] with its sign turned to `like`'s side."""
    s = np.where((np.asarray(normal) * like).sum(-1) < 0, -1.0, 1.0)
    return np.asarray(normal, np.float64) * s[..., None]


def assert_on_f64_fit(port, jax_, want, kappa, ok):
    """The port's normals [..., 3] within fit_bound of the float64 fit
    `want`, and within |JAX - float64| + fit_bound of JAX's, on the lanes
    `ok`.  Returns the largest |JAX - float64| and |port - float64|."""
    bound = fit_bound(kappa)[ok]
    t = np.abs(aligned(port, want) - want).max(-1)[ok]
    j = np.abs(aligned(jax_, want) - want).max(-1)[ok]
    tj = np.abs(aligned(port, want) - aligned(jax_, want)).max(-1)[ok]
    assert (t <= bound).all(), (t / bound).max()
    assert (tj <= j + bound).all()
    return (float(j.max()) if j.size else 0.0,
            float(t.max()) if t.size else 0.0)
