"""Cloud transform, projection and pixel-grid rasterization (counterpart
of core/projection.py).

The grid and the winner-attribute planes follow the JAX package
exactly (see its module docstring for the encodings):

  * the grid is one scatter-min over int32 keys, here
    `scatter_reduce_(reduce="amin")` — an int32 atomicMin per point on
    the card, so the result is order-independent and exact;
  * the planes are `index_add_` scatters keyed by `winner_flat`.  Every
    real cell has exactly one winner, so 0 + value is exact even with
    float atomics; the trash cell `ncells` gathers the losers and is
    sliced off.

Float-to-int conversions clamp the float first: XLA defines the result
for out-of-range floats, a C cast (and so PyTorch) does not.  The
clamped values only ever belong to points that are not visible and go
to the trash cell, but they must not poison an index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import SE3, PinholeCamera

POINT_NOT_DEFINED = -1

# Packed nearest-wins key: quantized depth above a 17-bit raw index
# (core/projection.py documents the layout and the sentinel margin).
_IDX_BITS = 17
_ZQ_MAX = (1 << (31 - _IDX_BITS)) - 2  # 16382
_ZQ_RANGE = 160.0
# Fast-path key: zq(13) | flag(1) | idx(17).
_FAST_ZQ_MAX = (1 << 13) - 2  # 8190
_FAST_STEP = _ZQ_RANGE / (_FAST_ZQ_MAX + 1)
_BIG = 2**31 - 1


class FrameCloud(NamedTuple):
    """Per-frame point-cloud state (field layout of the JAX FrameCloud)."""

    points_lidar: torch.Tensor  # [P, 3]
    points_cam: torch.Tensor  # [P, 3]
    uv: torch.Tensor  # [P, 2]
    valid: torch.Tensor  # [P] bool
    visible: torch.Tensor  # [P] bool
    grid: torch.Tensor  # [H, W] int32 raw point index or -1
    planes: torch.Tensor  # [2, H, W] f32 z_enc + packed subpixel uv
    winner_flat: torch.Tensor  # [P] int32 flat cell won, else H*W


def _to_i32(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Truncate toward zero after clamping into [lo, hi], which must
    contain every value the caller's integer clip keeps distinct."""
    return torch.clamp(x, lo, hi).to(torch.int32)


def rasterize_point_channel(frame: FrameCloud, values: torch.Tensor
                            ) -> torch.Tensor:
    """Per-point values onto the grid [H, W] (winner's value, 0 empty)."""
    H, W = frame.grid.shape
    ncells = H * W
    img = torch.zeros(ncells + 1, dtype=torch.float32,
                      device=values.device)
    img.index_add_(0, frame.winner_flat.long(), values.to(torch.float32))
    return img[:ncells].reshape(H, W)


def build_frame_cloud(
    points_lidar: torch.Tensor,
    valid: torch.Tensor,
    lidar_to_cam: SE3,
    camera: PinholeCamera,
    grid_height: int,
    grid_width: int,
    collision_rule: str = "nearest",
    point_flags: torch.Tensor | None = None,
    fast: bool = False,
) -> FrameCloud:
    """Transform, project and rasterize one lidar cloud [P, 3]."""
    points_cam = lidar_to_cam.apply(points_lidar)
    z = points_cam[..., 2]
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    u = camera.focal_length * points_cam[..., 0] / safe_z + camera.cx
    v = camera.focal_length * points_cam[..., 1] / safe_z + camera.cy
    uv = torch.stack([u, v], dim=-1)
    return rasterize_projected(points_lidar, points_cam, uv, valid, camera,
                               grid_height, grid_width, collision_rule,
                               point_flags, fast)


def rasterize_projected(
    points_lidar: torch.Tensor,
    points_cam: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    camera: PinholeCamera,
    grid_height: int,
    grid_width: int,
    collision_rule: str = "nearest",
    point_flags: torch.Tensor | None = None,
    fast: bool = False,
) -> FrameCloud:
    """The rasterization half of `build_frame_cloud`, given the camera-
    frame points and their pixel coordinates."""
    dev = points_cam.device
    z = points_cam[..., 2]
    u, v = uv[..., 0], uv[..., 1]
    strict_in = ((u > 0.0) & (u < float(camera.width))
                 & (v > 0.0) & (v < float(camera.height)) & (z != 0))
    visible = strict_in & valid & (z > 0.0)

    P = points_lidar.shape[0]
    x_pix = torch.clamp(_to_i32(u, -1.0, float(grid_width)), 0,
                        grid_width - 1)
    y_pix = torch.clamp(_to_i32(v, -1.0, float(grid_height)), 0,
                        grid_height - 1)
    ncells = grid_height * grid_width
    flat = torch.where(visible, y_pix.long() * grid_width + x_pix.long(),
                       ncells)
    idx = torch.arange(P, dtype=torch.int32, device=dev)
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)

    def scatter_min(keys: torch.Tensor) -> torch.Tensor:
        out = torch.full((ncells + 1,), _BIG, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, flat, torch.where(visible, keys, big),
                                   reduce="amin", include_self=True)

    if fast:
        if collision_rule != "nearest":
            raise ValueError("fast rasterization implements 'nearest' only")
        if P > (1 << _IDX_BITS):
            raise ValueError(
                f"fast rasterization supports up to {1 << _IDX_BITS} points")
        zq = torch.clamp(_to_i32(z * (1.0 / _FAST_STEP), -1.0,
                                 _FAST_ZQ_MAX + 1.0), 0, _FAST_ZQ_MAX)
        key = (zq << (_IDX_BITS + 1)) | idx
        if point_flags is not None:
            key = key | (point_flags.to(torch.int32) << _IDX_BITS)
        raw_all = scatter_min(key)
        raw = raw_all[:ncells]
        occupied = raw != _BIG
        grid = torch.where(occupied, raw & ((1 << _IDX_BITS) - 1),
                           POINT_NOT_DEFINED).reshape(grid_height, grid_width)
        z_dec = ((raw >> (_IDX_BITS + 1)).to(torch.float32) + 0.5) * _FAST_STEP
        f_dec = ((raw >> _IDX_BITS) & 1).bool()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        z_enc_plane = torch.where(occupied, torch.where(f_dec, -z_dec, z_dec),
                                  zero)
        # Winner subpixel position: the cell center (qu = qv = 2048).
        center = torch.full((), 2048.0 * 4096.0 + 2048.0,
                            dtype=torch.float32, device=dev)
        uv_plane = torch.where(occupied, center, zero)
        planes = torch.stack([z_enc_plane, uv_plane]).reshape(
            2, grid_height, grid_width)
        won = visible & (raw_all[flat] == key)
        winner_flat = torch.where(won, flat, ncells).to(torch.int32)
        return FrameCloud(points_lidar, points_cam, uv, valid, visible, grid,
                          planes, winner_flat)

    if collision_rule == "first":
        # Lowest raw index per pixel == first point in scan order.
        grid_flat = scatter_min(idx)
        grid_flat = torch.where(grid_flat == _BIG, POINT_NOT_DEFINED,
                                grid_flat)
    elif P <= (1 << _IDX_BITS):
        # Nearest-wins in one scatter-min over (quantized z, raw index).
        zq = torch.clamp(_to_i32(z * (float(_ZQ_MAX) / _ZQ_RANGE), -1.0,
                                 _ZQ_MAX + 1.0), 0, _ZQ_MAX)
        grid_flat = scatter_min((zq << _IDX_BITS) | idx)
        grid_flat = torch.where(grid_flat == _BIG, POINT_NOT_DEFINED,
                                grid_flat & ((1 << _IDX_BITS) - 1))
    else:
        # Huge clouds: depth scatter-min, then the lowest index among
        # the depth winners.
        inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        zkey = torch.where(visible, z.to(torch.float32), inf)
        grid_z = torch.full((ncells + 1,), float("inf"), dtype=torch.float32,
                            device=dev)
        grid_z.scatter_reduce_(0, flat, zkey, reduce="amin",
                               include_self=True)
        is_winner = visible & (zkey == grid_z[flat])
        grid_flat = torch.full((ncells + 1,), _BIG, dtype=torch.int32,
                               device=dev)
        grid_flat.scatter_reduce_(0, flat, torch.where(is_winner, idx, big),
                                  reduce="amin", include_self=True)
        grid_flat = torch.where(grid_flat == _BIG, POINT_NOT_DEFINED,
                                grid_flat)

    grid = grid_flat[:ncells].reshape(grid_height, grid_width)
    # A point won its cell iff its raw index is stored there.
    won = visible & (grid_flat[flat] == idx)
    winner_flat = torch.where(won, flat, ncells)

    def plane(vals: torch.Tensor) -> torch.Tensor:
        img = torch.zeros(ncells + 1, dtype=torch.float32, device=dev)
        img.index_add_(0, winner_flat, vals.to(torch.float32))
        return img[:ncells]

    z_enc = z if point_flags is None else torch.where(point_flags, -z, z)
    qu = torch.clamp((u - x_pix) * 4096.0, 0.0, 4095.0).to(torch.int32)
    qv = torch.clamp((v - y_pix) * 4096.0, 0.0, 4095.0).to(torch.int32)
    packed_uv = (qu * 4096 + qv).to(torch.float32)
    planes = torch.stack([plane(z_enc), plane(packed_uv)]).reshape(
        2, grid_height, grid_width)
    return FrameCloud(points_lidar, points_cam, uv, valid, visible, grid,
                      planes, winner_flat.to(torch.int32))
