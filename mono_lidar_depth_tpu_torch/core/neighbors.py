"""Rectangular-window neighbor gather around feature points (counterpart
of core/neighbors.py).

Every feature reads a static [Ky, Kx] window of the frame's plane stack,
and a per-cell mask replays the reference's exact dynamic rectangle.  The
neighbors' camera-frame coordinates are decoded from the planes with the
same f32 operations in the same order as the JAX package, so the decoded
points are bit-identical on the CPU.

`gather_neighbors_frames` is the one entry point: every search scale of
one or two frames at once, the frames' features joined in one lane order.
It has three forms:

  * `gather_stacks_reference`: plain PyTorch — per frame and scale the
    window crop by indexing and the elementwise decode
    (`_gather_from_stack`), then the concatenation of the frames.  The CPU
    runs it, and the kernel is held against it;
  * `gather_stacks_cuda`: the hand-written Hopper kernel
    (csrc/gather_neighbors.cu): crop, cell mask and decode of all scales
    and frames in one launch, no raw window ever written.  It is what the
    window-extraction TPU kernel (core/pallas_windows.py, reached through
    `_gather_from_stack`) becomes for this caller;
  * `gather_neighbors_frames` dispatches: CPU tensors take the reference;
    CUDA tensors launch the kernel or raise.  There is no fallback.

`launches` counts the kernel's launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import kernels
from .geometry import PinholeCamera
from .projection import POINT_NOT_DEFINED, FrameCloud
from .windows import slice_windows_reference

launches = 0  # gather_stacks_cuda kernel launches since the last reset
MAX_FRAMES = 2  # what one launch of csrc/gather_neighbors.cu takes
MAX_SCALES = 2  # kMaxScales there

# One search scale: (half_size_x, half_size_y, (Ky, Kx)).
Scale = tuple[float, float, tuple[int, int]]


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
    return gather_neighbors_frames(
        [frame], [features_uv], camera,
        [(half_size_x, half_size_y, window)], with_indices)[0]


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
    """Both search scales (primary + road retry) of one frame."""
    small, big = gather_neighbors_frames(
        [frame], [features_uv], camera,
        [(half_x, half_y, window_small),
         (half_x * scale_x, half_y * scale_y, window_large)], with_indices)
    return small, big


def gather_neighbors_frames(
    frames: Sequence[FrameCloud],
    uvs: Sequence[torch.Tensor],
    camera: PinholeCamera,
    scales: Sequence[Scale],
    with_indices: bool = True,
) -> list[NeighborSet]:
    """The NeighborSet of every scale over the features of all frames.

    `uvs[f]` [N_f, 2] are searched in `frames[f]`; each returned set (one
    per scale, in order) holds the sum(N_f) lanes in the frames' order.
    On the frames' device: the CUDA kernel for CUDA tensors (one launch
    for everything), the plain reference for CPU tensors."""
    if not frames or len(frames) != len(uvs):
        raise ValueError(f"{len(frames)} frames for {len(uvs)} feature sets")
    stacks = frame_stacks(frames, with_indices)
    device = stacks[0].device
    if device.type == "cuda":
        return gather_stacks_cuda(stacks, [uv.contiguous() for uv in uvs],
                                  camera, scales, with_indices)
    if device.type == "cpu":
        return gather_stacks_reference(stacks, uvs, camera, scales,
                                       with_indices)
    raise ValueError(f"no neighbor gather for device {device}")


def frame_stacks(frames: Sequence[FrameCloud], with_indices: bool
                 ) -> list[torch.Tensor]:
    """The contiguous f32 plane stack [C, H, W] of each frame: z with the
    ground flag in its sign, the packed subpixel offsets and, with
    indices, the raw point index as a third plane."""
    if with_indices:
        return [torch.cat([f.planes, f.grid.to(torch.float32)[None]], dim=0)
                for f in frames]
    return [f.planes.contiguous() for f in frames]


def gather_stacks_reference(
    stacks: Sequence[torch.Tensor],
    uvs: Sequence[torch.Tensor],
    camera: PinholeCamera,
    scales: Sequence[Scale],
    with_indices: bool,
) -> list[NeighborSet]:
    """`gather_neighbors_frames` on prebuilt plane stacks [C, H, W] in
    plain PyTorch: one crop and decode per frame and scale, then the
    frames' fields concatenated."""
    out = []
    for half_x, half_y, window in scales:
        sets = [_gather_from_stack(stack, camera, uv, half_x, half_y, window,
                                   with_indices, *stack.shape[1:])
                for stack, uv in zip(stacks, uvs)]
        out.append(sets[0] if len(sets) == 1 else NeighborSet(
            *(None if xs[0] is None else torch.cat(xs, dim=0)
              for xs in zip(*sets))))
    return out


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Truncation toward zero with NaN -> 0, as XLA converts and as the
    CUDA conversion does (a bare `.to(torch.int32)` of a NaN is INT_MIN
    on the CPU and 0 on the card)."""
    return torch.nan_to_num(x, nan=0.0).to(torch.int32)


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
    x0 = _to_i32(torch.clamp(left, max=float(W)))
    x1 = _to_i32(torch.clamp(right, min=-1.0))
    y0 = _to_i32(torch.clamp(top, max=float(H)))
    y1 = _to_i32(torch.clamp(bottom, min=-1.0))

    sy = torch.clamp(y0, max=H - Ky)
    sx = torch.clamp(x0, max=W - Kx)

    win = slice_windows_reference(stack, sy, sx, Ky, Kx)  # [N, C, Ky, Kx]

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


def gather_stacks_cuda(
    stacks: Sequence[torch.Tensor],
    uvs: Sequence[torch.Tensor],
    camera: PinholeCamera,
    scales: Sequence[Scale],
    with_indices: bool,
) -> list[NeighborSet]:
    """`gather_neighbors_frames` on prebuilt plane stacks by the fused
    CUDA kernel, one launch.

    Takes 1 or 2 contiguous f32 stacks [C, H, W] of one shape (C >= 2,
    C >= 3 with indices), as many contiguous f32 [N_f, 2] feature sets,
    all on one CUDA device, and 1 or 2 scales whose windows fit the
    grid; raises on anything else."""
    global launches
    if not 1 <= len(stacks) <= MAX_FRAMES or len(uvs) != len(stacks):
        raise ValueError(f"gather_stacks_cuda takes 1 or {MAX_FRAMES} frames "
                         f"with a feature set each, got {len(stacks)} and "
                         f"{len(uvs)}")
    if not 1 <= len(scales) <= MAX_SCALES:
        raise ValueError(f"gather_stacks_cuda takes 1 or {MAX_SCALES} scales, "
                         f"got {len(scales)}")
    dev = stacks[0].device
    if dev.type != "cuda":
        raise ValueError(f"gather_stacks_cuda needs CUDA tensors, got {dev}")
    shape = tuple(stacks[0].shape)
    if len(shape) != 3 or shape[0] < (3 if with_indices else 2):
        raise ValueError(f"a stack must be [C, H, W] with C >= "
                         f"{3 if with_indices else 2}, got {shape}")
    C, H, W = shape
    for f, (stack, uv) in enumerate(zip(stacks, uvs)):
        if tuple(stack.shape) != shape:
            raise ValueError(f"stack {f} is {tuple(stack.shape)}, stack 0 "
                             f"{shape}")
        if uv.dim() != 2 or uv.shape[1] != 2:
            raise ValueError(f"features {f} must be [N, 2], got "
                             f"{tuple(uv.shape)}")
        for name, t in ((f"stack {f}", stack), (f"features {f}", uv)):
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{name} must be f32 on {dev}, got "
                                 f"{t.dtype} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    for _, _, (Ky, Kx) in scales:
        if not (0 < Ky <= H and 0 < Kx <= W):
            raise ValueError(f"window {(Ky, Kx)} exceeds grid {H}x{W}")

    n_a = uvs[0].shape[0]
    n_b = uvs[1].shape[0] if len(uvs) == 2 else 0
    N = n_a + n_b
    out, records = [], (kernels.GatherScale * len(scales))()
    for rec, (half_x, half_y, (Ky, Kx)) in zip(records, scales):
        K = Ky * Kx
        nb = NeighborSet(
            indices=(torch.empty((N, K), dtype=torch.int32, device=dev)
                     if with_indices else None),
            mask=torch.empty((N, K), dtype=torch.bool, device=dev),
            points_cam=torch.empty((N, K, 3), dtype=torch.float32,
                                   device=dev),
            count=torch.empty((N,), dtype=torch.int32, device=dev),
            z=torch.empty((N, K), dtype=torch.float32, device=dev),
            flags=torch.empty((N, K), dtype=torch.bool, device=dev))
        out.append(nb)
        # A c_float field rounds a Python float to f32 (nearest even), as
        # PyTorch rounds a Python scalar that meets an f32 tensor.
        rec.half_x, rec.half_y, rec.ky, rec.kx = half_x, half_y, Ky, Kx
        rec.mask, rec.z, rec.flags = (nb.mask.data_ptr(), nb.z.data_ptr(),
                                      nb.flags.data_ptr())
        rec.points, rec.count = nb.points_cam.data_ptr(), nb.count.data_ptr()
        rec.indices = nb.indices.data_ptr() if with_indices else None
    if N == 0:  # nothing to launch
        return out
    lib = kernels.library("gather_neighbors")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mld_gather_neighbors(
            stacks[0].data_ptr(), stacks[-1].data_ptr(), uvs[0].data_ptr(),
            uvs[-1].data_ptr(), n_a, n_b, C, H, W, int(with_indices),
            camera.cx, camera.cy, 1.0 / camera.focal_length,
            records, len(scales), stream)
        kernels.check(lib, code, "gather_neighbors kernel launch")
        launches += 1
    return out
