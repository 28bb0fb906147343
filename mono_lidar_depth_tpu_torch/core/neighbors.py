"""Rectangular-window neighbor gather around feature points (counterpart
of core/neighbors.py).

Every feature reads a static [Ky, Kx] window of the frame's plane stack
(one `slice_windows` call per scale: the CUDA kernel on the card), and
a per-cell mask replays the reference's exact dynamic rectangle.  The
neighbors' camera-frame coordinates are decoded from the planes with
the same f32 operations in the same order as the JAX package, so the
decoded points are bit-identical on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry import PinholeCamera
from .projection import POINT_NOT_DEFINED, FrameCloud
from .windows import slice_windows


class NeighborSet(NamedTuple):
    indices: Optional[torch.Tensor]  # [N, K] int32 raw indices (-1 off)
    mask: torch.Tensor  # [N, K] bool
    points_cam: torch.Tensor  # [N, K, 3] (0 where ~mask)
    count: torch.Tensor  # [N] int32
    z: torch.Tensor  # [N, K] depth (0 where ~mask)
    flags: Optional[torch.Tensor] = None  # [N, K] bool ground-inlier flag


def gather_neighbors(
    frame: FrameCloud,
    camera: PinholeCamera,
    features_uv: torch.Tensor,
    half_size_x: float,
    half_size_y: float,
    window: tuple[int, int],
    with_indices: bool = True,
) -> NeighborSet:
    """Slice grid windows for all features [N, 2] at once."""
    H, W = frame.grid.shape
    if with_indices:
        stack = torch.cat([frame.planes,
                           frame.grid.to(torch.float32)[None]], dim=0)
    else:
        stack = frame.planes.contiguous()
    return _gather_from_stack(stack, camera, features_uv, half_size_x,
                              half_size_y, window, with_indices, H, W)


def _gather_from_stack(
    stack: torch.Tensor,
    camera: PinholeCamera,
    features_uv: torch.Tensor,
    half_size_x: float,
    half_size_y: float,
    window: tuple[int, int],
    with_indices: bool,
    H: int,
    W: int,
) -> NeighborSet:
    """Window slice + decode against a prebuilt plane stack."""
    Ky, Kx = window
    if Ky > H or Kx > W:
        raise ValueError(f"window {window} exceeds grid {H}x{W}")
    dev = stack.device
    u = features_uv[..., 0]
    v = features_uv[..., 1]

    left = torch.clamp(u - half_size_x, min=0.0)
    right = torch.clamp(u + half_size_x, max=float(W - 1))
    top = torch.clamp(v - half_size_y, min=0.0)
    bottom = torch.clamp(v + half_size_y, max=float(H - 1))

    # Truncation toward zero as in XLA; the extra clamps to [-1, W] /
    # [-1, H] keep the cast defined and change no mask (an empty span
    # stays empty).
    x0 = torch.clamp(left, max=float(W)).to(torch.int32)
    x1 = torch.clamp(right, min=-1.0).to(torch.int32)
    y0 = torch.clamp(top, max=float(H)).to(torch.int32)
    y1 = torch.clamp(bottom, min=-1.0).to(torch.int32)

    sy = torch.clamp(y0, max=H - Ky)
    sx = torch.clamp(x0, max=W - Kx)

    win = slice_windows(stack, sy, sx, Ky, Kx)  # [N, C, Ky, Kx]

    dy = torch.arange(Ky, dtype=torch.int32, device=dev)
    dx = torch.arange(Kx, dtype=torch.int32, device=dev)
    cy = sy[:, None] + dy  # [N, Ky]
    cx = sx[:, None] + dx  # [N, Kx]
    in_y = (cy >= y0[:, None]) & (cy <= y1[:, None])
    in_x = (cx >= x0[:, None]) & (cx <= x1[:, None])
    cell_ok = in_y[:, :, None] & in_x[:, None, :]  # [N, Ky, Kx]

    N = features_uv.shape[0]
    K = Ky * Kx
    winf = win.reshape(N, -1, K)
    z_enc = winf[:, 0]
    if with_indices:
        idx = winf[:, 2].to(torch.int32)
        mask = cell_ok.reshape(N, K) & (idx != POINT_NOT_DEFINED)
    else:
        idx = None
        # Winners always have z > 0, so z_enc == 0 <=> empty cell.
        mask = cell_ok.reshape(N, K) & (z_enc != 0.0)

    flags = mask & (z_enc < 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    zs = torch.where(mask, torch.abs(z_enc), zero)

    packed = winf[:, 1]
    qu = torch.floor(packed * (1.0 / 4096.0))
    qv = packed - qu * 4096.0
    cell_col = cx[:, None, :].expand(N, Ky, Kx).reshape(N, K).to(
        torch.float32)
    cell_row = cy[:, :, None].expand(N, Ky, Kx).reshape(N, K).to(
        torch.float32)
    uu = cell_col + (qu + 0.5) * (1.0 / 4096.0)
    vv = cell_row + (qv + 0.5) * (1.0 / 4096.0)
    inv_f = 1.0 / camera.focal_length
    xs = (uu - camera.cx) * inv_f * zs
    ys = (vv - camera.cy) * inv_f * zs
    pts = torch.where(mask[..., None], torch.stack([xs, ys, zs], dim=-1),
                      zero)

    return NeighborSet(
        indices=(torch.where(mask, idx, POINT_NOT_DEFINED)
                 if with_indices else None),
        mask=mask,
        points_cam=pts,
        count=mask.sum(-1).to(torch.int32),
        z=zs,
        flags=flags,
    )


def gather_neighbors_two_scales(
    frame: FrameCloud,
    camera: PinholeCamera,
    features_uv: torch.Tensor,
    half_x: float,
    half_y: float,
    scale_x: float,
    scale_y: float,
    window_small: tuple[int, int],
    window_large: tuple[int, int],
    with_indices: bool = True,
) -> tuple[NeighborSet, NeighborSet]:
    """Both search scales (primary + road retry): two window passes."""
    small = gather_neighbors(frame, camera, features_uv, half_x, half_y,
                             window_small, with_indices=with_indices)
    big = gather_neighbors(frame, camera, features_uv, half_x * scale_x,
                           half_y * scale_y, window_large,
                           with_indices=with_indices)
    return small, big
