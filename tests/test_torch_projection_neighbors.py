"""Rasterization and neighbor gather: the port against the JAX functions.

Bars: `grid`, `planes`, `winner_flat` (and `visible`) bit-exact on all
four rasterization paths when both sides get JAX's `points_cam` / `uv`
(so that matmul reassociation in the transform cannot move a point
across a pixel or depth-key boundary); the neighbor mask, z, flags,
indices and decoded points bit-exact against the same plane stack.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import CAMERA, R_LC, T_LC, assert_trees_equal, to_port
from mono_lidar_depth_tpu.core import geometry as jgeo
from mono_lidar_depth_tpu.core import neighbors as jnb
from mono_lidar_depth_tpu.core import projection as jproj
from mono_lidar_depth_tpu.io.kitti import make_synthetic_scan, pad_cloud
from mono_lidar_depth_tpu_torch.convert import state_to_numpy
from mono_lidar_depth_tpu_torch.core import geometry as tgeo
from mono_lidar_depth_tpu_torch.core import neighbors as tnb
from mono_lidar_depth_tpu_torch.core import projection as tproj

H, W = 128, 384
JCAM = jgeo.PinholeCamera(**CAMERA)
TCAM = tgeo.PinholeCamera(**CAMERA)
JT = jgeo.SE3(jnp.asarray(R_LC), jnp.asarray(T_LC))


def _cloud(P, seed=3):
    rng = np.random.default_rng(seed)
    n = P - 300  # padded tail
    cloud, valid = pad_cloud(make_synthetic_scan(rng, n), n, P)
    flags = rng.random(P) < 0.4
    return cloud, valid, flags


@partial(jax.jit, static_argnames=("rule", "fast", "with_flags"))
def _jax_frame(cloud, valid, flags, rule, fast, with_flags):
    return jproj.build_frame_cloud(
        cloud, valid, JT, JCAM, H, W, collision_rule=rule,
        point_flags=flags if with_flags else None, fast=fast)


@pytest.mark.parametrize("rule,fast,P,with_flags", [
    ("nearest", False, 8192, True),    # packed single-key path
    ("nearest", False, 8192, False),
    ("first", False, 8192, True),      # reference lowest-index rule
    ("nearest", False, (1 << 17) + 64, True),  # two-pass path (huge P)
    ("nearest", True, 8192, True),     # fast rasterization
])
def test_rasterization_bitexact(rule, fast, P, with_flags):
    cloud, valid, flags = _cloud(P)
    jf = jax.tree.map(np.asarray, _jax_frame(
        jnp.asarray(cloud), jnp.asarray(valid), jnp.asarray(flags),
        rule, fast, with_flags))
    tf = tproj.rasterize_projected(
        torch.from_numpy(cloud), torch.tensor(jf.points_cam),
        torch.tensor(jf.uv), torch.from_numpy(valid), TCAM, H, W,
        collision_rule=rule,
        point_flags=torch.from_numpy(flags) if with_flags else None,
        fast=fast)
    assert_trees_equal(state_to_numpy(tf), jf)
    assert (jf.grid >= 0).sum() > 500  # the scene fills the grid


def test_build_frame_cloud_end_to_end():
    """The port's own transform: points within f32 tolerance, and the
    grid equal except where reassociation moves a boundary point."""
    cloud, valid, flags = _cloud(8192)
    jf = jax.tree.map(np.asarray, _jax_frame(
        jnp.asarray(cloud), jnp.asarray(valid), jnp.asarray(flags),
        "nearest", False, True))
    tf = state_to_numpy(tproj.build_frame_cloud(
        torch.from_numpy(cloud), torch.from_numpy(valid),
        tgeo.SE3(torch.from_numpy(R_LC), torch.from_numpy(T_LC)), TCAM, H, W,
        point_flags=torch.from_numpy(flags)))
    np.testing.assert_allclose(tf.points_cam, jf.points_cam, atol=1e-5)
    assert np.mean(tf.grid == jf.grid) > 0.999


@partial(jax.jit, static_argnames=("window", "with_indices", "hx", "hy"))
def _jax_gather(frame, uv, window, with_indices, hx, hy):
    return jnb.gather_neighbors(frame, JCAM, uv, hx, hy, window,
                                with_indices=with_indices)


@pytest.mark.parametrize("window,scale", [((11, 8), 1.0), ((15, 14), 1.5)])
@pytest.mark.parametrize("with_indices", [False, True])
def test_neighbors_bitexact(window, scale, with_indices):
    cloud, valid, flags = _cloud(8192)
    jframe = _jax_frame(jnp.asarray(cloud), jnp.asarray(valid),
                        jnp.asarray(flags), "nearest", False, True)
    rng = np.random.default_rng(5)
    uv = rng.uniform([-3, -3], [W + 3, H + 3], (256, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [W - 1, H - 1], [W, H], [0.5, H - 0.5],
              [W - 0.2, 0.1], [3, 4], [W / 2, H / 2], [1e4, -1e4]]
    hx, hy = 3.0 * scale, 4.5 * scale
    want = jax.tree.map(np.asarray, _jax_gather(
        jframe, jnp.asarray(uv), window, with_indices, hx, hy))
    got = tnb.gather_neighbors(to_port(jframe), TCAM, torch.from_numpy(uv),
                               hx, hy, window, with_indices=with_indices)
    assert_trees_equal(state_to_numpy(got), want)
    assert want.count.sum() > 1000


@pytest.mark.parametrize("fast", [False, True])
def test_rasterize_point_channel_bitexact(fast):
    cloud, valid, flags = _cloud(8192)
    jframe = _jax_frame(jnp.asarray(cloud), jnp.asarray(valid),
                        jnp.asarray(flags), "nearest", fast, True)
    values = np.random.default_rng(9).normal(size=8192).astype(np.float32)
    want = np.asarray(jproj.rasterize_point_channel(jframe,
                                                    jnp.asarray(values)))
    got = tproj.rasterize_point_channel(to_port(jframe),
                                        torch.from_numpy(values))
    assert np.array_equal(got.numpy(), want)
    assert (want != 0).sum() > 500
