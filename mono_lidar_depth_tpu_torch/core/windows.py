"""Per-feature rectangular window extraction (counterpart of
core/pallas_windows.py).

    out[n, c, y, x] = stack[c, sy[n] + y, sx[n] + x]

with the starts clamped to [0, H-Ky] x [0, W-Kx], as `lax.dynamic_slice`
clamps a start past the far edge (the callers never pass a negative
start; jax.lax would wrap one Python-style).  Three functions:

  * `slice_windows_reference`: plain PyTorch advanced indexing — the
    version the CPU runs and the one the kernel is held against;
  * `slice_windows_cuda`: the hand-written Hopper kernel
    (csrc/windows.cu), which replaces the Pallas kernel
    `pallas_windows.py::_window_kernel`;
  * `slice_windows`: the dispatcher.  A CPU tensor takes the reference;
    a CUDA tensor launches the kernel or raises.  There is no fallback.

`launches` counts the kernel's launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import torch

from .. import kernels

launches = 0  # slice_windows_cuda kernel launches since the last reset


def slice_windows_reference(stack: torch.Tensor, sy: torch.Tensor,
                            sx: torch.Tensor, Ky: int, Kx: int
                            ) -> torch.Tensor:
    """[N, C, Ky, Kx] windows of `stack` [C, H, W] by indexing."""
    C, H, W = stack.shape
    dev = stack.device
    sy = torch.clamp(sy.long(), 0, H - Ky)
    sx = torch.clamp(sx.long(), 0, W - Kx)
    rows = sy[:, None] + torch.arange(Ky, device=dev)  # [N, Ky]
    cols = sx[:, None] + torch.arange(Kx, device=dev)  # [N, Kx]
    out = stack[:, rows[:, :, None], cols[:, None, :]]  # [C, N, Ky, Kx]
    return out.permute(1, 0, 2, 3).contiguous()


def slice_windows_cuda(stack: torch.Tensor, sy: torch.Tensor,
                       sx: torch.Tensor, Ky: int, Kx: int) -> torch.Tensor:
    """[N, C, Ky, Kx] windows of `stack` [C, H, W] by the CUDA kernel.

    Takes a contiguous f32 stack and contiguous int32 starts [N] on one
    CUDA device; raises on anything else."""
    global launches
    if stack.device.type != "cuda":
        raise ValueError(f"slice_windows_cuda needs a CUDA stack, got "
                         f"{stack.device}")
    if stack.dtype != torch.float32 or stack.dim() != 3:
        raise ValueError(f"stack must be f32 [C, H, W], got {stack.dtype} "
                         f"{tuple(stack.shape)}")
    for name, s in (("sy", sy), ("sx", sx)):
        if s.device != stack.device or s.dtype != torch.int32 or s.dim() != 1:
            raise ValueError(f"{name} must be int32 [N] on {stack.device}, "
                             f"got {s.dtype} {tuple(s.shape)} on {s.device}")
        if not s.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not stack.is_contiguous():
        raise ValueError("stack must be contiguous")
    C, H, W = stack.shape
    N = sy.shape[0]
    if sx.shape[0] != N:
        raise ValueError(f"sy has {N} starts, sx {sx.shape[0]}")
    if not (0 < Ky <= H and 0 < Kx <= W):
        raise ValueError(f"window {Ky}x{Kx} does not fit grid {H}x{W}")
    out = torch.empty((N, C, Ky, Kx), dtype=torch.float32,
                      device=stack.device)
    lib = kernels.library("windows")
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream(stack.device).cuda_stream
        code = lib.mld_slice_windows(
            stack.data_ptr(), sy.data_ptr(), sx.data_ptr(), out.data_ptr(),
            C, H, W, N, Ky, Kx, stream)
        kernels.check(lib, code, "slice_windows kernel launch")
        launches += 1
    return out


def slice_windows(stack: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                  Ky: int, Kx: int) -> torch.Tensor:
    """Window extraction on the stack's device: the CUDA kernel for a
    CUDA tensor, the plain reference for a CPU tensor."""
    if stack.device.type == "cuda":
        return slice_windows_cuda(stack, sy, sx, Ky, Kx)
    if stack.device.type == "cpu":
        return slice_windows_reference(stack, sy, sx, Ky, Kx)
    raise ValueError(f"no window extraction for device {stack.device}")
