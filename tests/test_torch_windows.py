"""Window extraction: the port's plain version against the JAX
`slice_windows` (CPU: vmap(dynamic_slice)), bit-exact, over the shape
classes and edge starts of tests_tpu/test_tpu_parity.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from mono_lidar_depth_tpu.core.pallas_windows import slice_windows as jax_sw
from mono_lidar_depth_tpu_torch.core import windows


def _starts(rng, H, W, Ky, Kx):
    """Random interior starts, the lane-tile edges, the far corners and
    starts past the far edge (both sides clamp them to H-Ky / W-Kx).
    No negative starts: the callers never make one, and jax.lax
    wraps a negative index Python-style where the port clamps it to 0."""
    n_rand = 192
    sy = list(rng.integers(0, H - Ky + 1, n_rand))
    sx = list(rng.integers(0, W - Kx + 1, n_rand))
    for base in (0, 128, 256, (W - Kx) // 128 * 128):
        for off in (0, 1, 127):
            if 0 <= base + off <= W - Kx:
                sx.append(base + off)
                sy.append(int(rng.integers(0, H - Ky + 1)))
    sy += [0, H - Ky, H - Ky, 0, H - Ky + 1, H]
    sx += [0, W - Kx, 0, W - Kx, W, W + 7]
    return np.asarray(sy, np.int32), np.asarray(sx, np.int32)


@pytest.mark.parametrize("C,H,W,Ky,Kx", [
    (2, 128, 384, 9, 11),     # synthetic-eval-sized grid
    (2, 376, 1241, 9, 11),    # KITTI-sized grid (W % 128 != 0)
    (2, 64, 256, 7, 7),       # W % 128 == 0
    (3, 96, 512, 15, 21),     # 3 attribute planes, wide window
    (1, 40, 100, 12, 12),     # one plane (the KLT caller's shape class)
    (2, 128, 384, 11, 8),     # the default primary window
    (2, 128, 384, 15, 14),    # the default road window
])
def test_slice_windows_reference_bitexact(C, H, W, Ky, Kx):
    rng = np.random.default_rng(0)
    stack = rng.normal(size=(C, H, W)).astype(np.float32)
    sy, sx = _starts(rng, H, W, Ky, Kx)
    want = np.asarray(jax_sw(jnp.asarray(stack), jnp.asarray(sy),
                             jnp.asarray(sx), Ky, Kx))
    windows.launches = 0
    got = windows.slice_windows(torch.from_numpy(stack),
                                torch.from_numpy(sy), torch.from_numpy(sx),
                                Ky, Kx)
    assert got.shape == (len(sy), C, Ky, Kx)
    assert np.array_equal(got.numpy(), want)
    # A CPU tensor takes the plain version: the kernel never launched.
    assert windows.launches == 0


def test_slice_windows_cuda_refuses_cpu_tensors():
    stack = torch.zeros((2, 16, 16))
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        windows.slice_windows_cuda(stack, s, s, 4, 4)
    assert windows.launches == 0
