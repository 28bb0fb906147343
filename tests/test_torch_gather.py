"""The fused neighbor gather's entry point (`gather_neighbors_frames`):
its plain version against the JAX package's `gather_neighbors_two_scales`
run per frame and concatenated with numpy.

Bar: every field of every scale bit-exact (mask, z, flags, points_cam,
count, indices), for one and two frames, unequal feature counts, with
and without the index plane, the default windows and an odd pair,
features on and past all four borders, non-finite feature positions and
an empty cloud.  On the CPU the entry point takes the plain version; the
CUDA kernel is held against the same plain version on the card by
chip_smoke.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import CAMERA, R_LC, SMALL, T_LC, assert_trees_equal, to_port
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.core import geometry as jgeo
from mono_lidar_depth_tpu.core import neighbors as jnb
from mono_lidar_depth_tpu.core import projection as jproj
from mono_lidar_depth_tpu.io.kitti import make_synthetic_scan, pad_cloud
from mono_lidar_depth_tpu_torch.convert import state_to_numpy
from mono_lidar_depth_tpu_torch.core import geometry as tgeo
from mono_lidar_depth_tpu_torch.core import neighbors as tnb

H, W, P = 128, 384, 8192
JCAM = jgeo.PinholeCamera(**CAMERA)
TCAM = tgeo.PinholeCamera(**CAMERA)
JT = jgeo.SE3(jnp.asarray(R_LC), jnp.asarray(T_LC))
# (half_x, half_y, scale_x, scale_y, small window, large window): the
# defaults of DepthEstimatorConfig, and an odd pair.
WINDOWS = {
    "default": (3.0, 4.5, 2.0, 1.5, (11, 8), (15, 14)),
    "odd": (2.0, 3.0, 2.5, 1.3, (9, 7), (11, 13)),
}
N_A, N_B = 200, 77


@jax.jit
def _jax_frame(cloud, valid, flags):
    return jproj.build_frame_cloud(cloud, valid, JT, JCAM, H, W,
                                   point_flags=flags)


def _frame(seed, empty=False):
    rng = np.random.default_rng(seed)
    n = P - 300
    cloud, valid = pad_cloud(make_synthetic_scan(rng, n), n, P)
    if empty:
        valid = np.zeros_like(valid)
    flags = rng.random(P) < 0.4
    return _jax_frame(jnp.asarray(cloud), jnp.asarray(valid),
                      jnp.asarray(flags))


def _features(seed, n, half_x, half_y, nonfinite=False):
    """Random positions over the grid and a margin, then centres on, at
    and beyond every border of the largest rectangle."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform([-3, -3], [W + 3, H + 3], (n, 2)).astype(np.float32)
    ex = [-20.0, -half_x - 0.5, -half_x, -0.3, 0.0, half_x - 0.1, half_x,
          W - 1 - half_x, W - 1 - half_x + 0.2, W - 1.0, W - 0.5, float(W),
          W + half_x, W + 20.0]
    ey = [-20.0, -half_y - 0.5, -half_y, -0.3, 0.0, half_y - 0.1, half_y,
          H - 1 - half_y, H - 1 - half_y + 0.2, H - 1.0, H - 0.5, float(H),
          H + half_y, H + 20.0]
    edges = ([(x, H / 2 + 0.37) for x in ex] + [(W / 2 + 0.71, y) for y in ey]
             + list(zip(ex, ey)))
    uv[:len(edges)] = edges
    if nonfinite:
        nan, inf = np.nan, np.inf
        odd = [(nan, 10), (10, nan), (nan, nan), (inf, 5), (-inf, 5),
               (5, inf), (5, -inf), (inf, -inf)]
        uv[len(edges):len(edges) + len(odd)] = odd
    return uv


@partial(jax.jit, static_argnames=("spec", "with_indices"))
def _jax_two_scales(frame, uv, spec, with_indices):
    hx, hy, sx, sy, small, large = spec
    return jnb.gather_neighbors_two_scales(frame, JCAM, uv, hx, hy, sx, sy,
                                           small, large,
                                           with_indices=with_indices)


def _want(jframes, uvs, spec, with_indices):
    """JAX per frame, the frames' fields concatenated with numpy."""
    per_frame = [jax.tree.map(np.asarray, _jax_two_scales(
        f, jnp.asarray(uv), spec, with_indices))
        for f, uv in zip(jframes, uvs)]
    return [jnb.NeighborSet(*(
        None if xs[0] is None else np.concatenate(xs, axis=0)
        for xs in zip(*(pf[k] for pf in per_frame)))) for k in range(2)]


def _scales(spec):
    hx, hy, sx, sy, small, large = spec
    return [(hx, hy, small), (hx * sx, hy * sy, large)]


def _got(jframes, uvs, spec, with_indices):
    return tnb.gather_neighbors_frames(
        [to_port(f) for f in jframes], [torch.from_numpy(uv) for uv in uvs],
        TCAM, _scales(spec), with_indices)


@pytest.mark.parametrize("windows", sorted(WINDOWS))
@pytest.mark.parametrize("with_indices", [False, True])
@pytest.mark.parametrize("n_frames", [1, 2])
def test_gather_frames_bitexact(n_frames, with_indices, windows):
    spec = WINDOWS[windows]
    hx, hy = spec[0] * spec[2], spec[1] * spec[3]
    jframes = [_frame(3), _frame(4)][:n_frames]
    uvs = [_features(5, N_A, hx, hy), _features(6, N_B, hx, hy)][:n_frames]
    want = _want(jframes, uvs, spec, with_indices)
    got = _got(jframes, uvs, spec, with_indices)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.mask.shape[0] == sum(len(uv) for uv in uvs)
        assert g.mask.dtype == torch.bool and g.flags.dtype == torch.bool
        assert g.count.dtype == torch.int32
        assert_trees_equal(state_to_numpy(g), w)
        assert w.count.sum() > 500 and w.flags.any()


def _dense_stack(seed):
    """A plane stack with most cells occupied, column 0 and row 0 too
    (a rasterized scan leaves the grid's corner empty): signed depths,
    packed subpixel offsets and the index plane."""
    rng = np.random.default_rng(seed)
    hit = rng.random((H, W)) < 0.7
    z = rng.uniform(1.0, 60.0, (H, W)) * np.where(rng.random((H, W)) < 0.3,
                                                  -1.0, 1.0)
    packed = (rng.integers(0, 4096, (H, W)) * 4096.0
              + rng.integers(0, 4096, (H, W)))
    idx = np.where(hit, rng.integers(0, P, (H, W)), -1)
    return np.stack([np.where(hit, z, 0.0), np.where(hit, packed, 0.0),
                     idx]).astype(np.float32)


@partial(jax.jit, static_argnames=("half_x", "half_y", "window",
                                   "with_indices"))
def _jax_from_stack(stack, uv, half_x, half_y, window, with_indices):
    return jnb._gather_from_stack(stack, JCAM, uv, half_x, half_y, window,
                                  with_indices, H, W)


@pytest.mark.parametrize("with_indices", [False, True])
def test_gather_nonfinite_features(with_indices):
    """A NaN position gives 0 at the integer casts (XLA's conversion), so
    it sees the occupied cells the clamps leave, at column or row 0; an
    infinite one sees nothing."""
    scales = _scales(WINDOWS["default"])
    stacks = [_dense_stack(11), _dense_stack(12)]
    uvs = [_features(7, N_A, 6.0, 6.75, nonfinite=True),
           _features(8, N_B, 6.0, 6.75, nonfinite=True)]
    got = tnb.gather_stacks_reference(
        [torch.from_numpy(s) for s in stacks],
        [torch.from_numpy(uv) for uv in uvs], TCAM, scales, with_indices)
    nan_lanes = np.isnan(uvs[0]).any(1)
    inf_lanes = np.isinf(uvs[0]).any(1) & ~nan_lanes
    assert nan_lanes.sum() == 3 and inf_lanes.sum() == 5
    for g, (half_x, half_y, window) in zip(got, scales):
        per_frame = [jax.tree.map(np.asarray, _jax_from_stack(
            jnp.asarray(s), jnp.asarray(uv), half_x, half_y, window,
            with_indices)) for s, uv in zip(stacks, uvs)]
        w = jnb.NeighborSet(*(
            None if xs[0] is None else np.concatenate(xs, axis=0)
            for xs in zip(*per_frame)))
        assert_trees_equal(state_to_numpy(g), w)
        assert (w.count[:N_A][nan_lanes] > 0).all()
        assert not w.mask[:N_A][inf_lanes].any()
        assert np.isfinite(w.points_cam).all()


@pytest.mark.parametrize("n_frames", [1, 2])
def test_gather_empty_cloud(n_frames):
    spec = WINDOWS["default"]
    jframes = [_frame(3, empty=True), _frame(4)][:n_frames]
    uvs = [_features(5, N_A, 6.0, 6.75), _features(6, N_B, 6.0, 6.75)][
        :n_frames]
    want = _want(jframes, uvs, spec, True)
    got = _got(jframes, uvs, spec, True)
    for g, w in zip(got, want):
        assert_trees_equal(state_to_numpy(g), w)
        assert not g.mask[:N_A].any() and int(g.count[:N_A].sum()) == 0
        assert bool((g.indices[:N_A] == -1).all())
        assert not g.points_cam[:N_A].any()


def test_single_scale_entry_points_agree():
    """`gather_neighbors` and `gather_neighbors_two_scales` are the
    one-frame forms of `gather_neighbors_frames`."""
    spec = WINDOWS["default"]
    frame = to_port(_frame(3))
    uv = torch.from_numpy(_features(5, N_A, 6.0, 6.75))
    both = tnb.gather_neighbors_frames([frame], [uv], TCAM, _scales(spec))
    small, large = tnb.gather_neighbors_two_scales(frame, TCAM, uv, *spec)
    one = tnb.gather_neighbors(frame, TCAM, uv, 3.0, 4.5, (11, 8))
    assert_trees_equal(state_to_numpy(small), state_to_numpy(both[0]))
    assert_trees_equal(state_to_numpy(large), state_to_numpy(both[1]))
    assert_trees_equal(state_to_numpy(one), state_to_numpy(both[0]))


def test_gather_cuda_refuses_cpu_tensors():
    frame = to_port(_frame(3))
    uv = torch.from_numpy(_features(5, N_A, 3.0, 4.5))
    with pytest.raises(ValueError, match="CUDA"):
        tnb.gather_stacks_cuda(tnb.frame_stacks([frame], False), [uv], TCAM,
                               [(3.0, 4.5, (11, 8))], False)


@pytest.mark.parametrize("bad", ["no frames", "three scales", "window"])
def test_gather_rejects_malformed_calls(bad):
    frame = to_port(_frame(3))
    uv = torch.from_numpy(_features(5, N_A, 3.0, 4.5))
    scale = (3.0, 4.5, (11, 8))
    with pytest.raises(ValueError):
        if bad == "no frames":
            tnb.gather_neighbors_frames([], [], TCAM, [scale])
        elif bad == "three scales":
            tnb.gather_stacks_cuda(tnb.frame_stacks([frame], False), [uv],
                                   TCAM, [scale] * 3, False)
        else:
            tnb.gather_neighbors_frames([frame], [uv], TCAM,
                                        [(3.0, 4.5, (H + 1, 8))])


def test_pair_equals_two_single_frames():
    """`estimate_depths_pair` (one gather over both frames) gives each
    frame the codes, depths and counters of `estimate_depths_from_frame`
    on that frame alone."""
    cfg = T.DepthEstimatorConfig(**SMALL)
    l2c = T.SE3(torch.from_numpy(R_LC), torch.from_numpy(T_LC))
    args = []
    for seed, n in ((3, 256), (4, 100)):
        rng = np.random.default_rng(seed)
        cloud, valid = pad_cloud(make_synthetic_scan(rng, P - 300), P - 300,
                                 P)
        cloud, valid = torch.from_numpy(cloud), torch.from_numpy(valid)
        gp = T.fit_ground_plane_ransac(
            cloud, valid, torch.Generator().manual_seed(seed),
            num_hypotheses=cfg.ransac_num_hypotheses,
            subsample=cfg.ransac_subsample_points)
        frame = T.rasterize_cloud(cfg, TCAM, l2c, cloud, valid, gp)
        uv = torch.from_numpy(_features(seed, n, 6.0, 6.75))
        args.append((frame, uv, torch.from_numpy(rng.random(n) < 0.9), gp))
    pair = T.estimate_depths_pair(cfg, TCAM, l2c, *args[0], *args[1])
    for est, (frame, uv, valid, gp) in zip(pair, args):
        alone = T.estimate_depths_from_frame(cfg, TCAM, l2c, frame, uv,
                                             valid, gp)
        assert torch.equal(est.codes, alone.codes)
        assert torch.equal(est.depths, alone.depths)
        assert torch.equal(est.counters, alone.counters)
        assert int((est.codes == 1).sum()) > 0
