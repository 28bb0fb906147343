"""Pyramidal Lucas-Kanade feature tracking, fully batched (counterpart
of tracker/klt.py).

All N features iterate together at each pyramid level: the LK normal
equations are closed-form 2x2 solves and the iteration count is fixed.
No per-feature control flow and no read-back to the host.

Patch sampling is not a gather.  A bilinear patch at center c with an
integer offset grid shares ONE fractional offset f = c - floor(c) across
all its taps, so the patch is

    window  = img[floor(cy)+ky, floor(cx)+kx]   (integer window)
    patch   = lerp_2d(window, f)                (4-tap blend)

Border semantics: centers are clamped into the image (plus `slack`) and
the window is cut from an edge-replicated pad, which reproduces the
per-tap clamping of a gather-based sampler for all in-image centers.

The two LK passes of `track_features` (`_track_passes`: forward over
every pyramid level, coarse to fine, then backward from the forward
result) have three forms:

  * `_track_passes_reference`: plain PyTorch — `_pyramidal` twice over
    `_lk_level_reference` (edge pad, window indexing, `_lerp2`,
    `torch.sum`, a Python loop over the iterations).  The CPU runs it,
    and the kernel is held against it.
  * `_track_passes_cuda`: the hand-written Hopper kernel
    (csrc/lk_track.cu): windows, blends, normal equations and all
    iterations of every level of both passes in one launch, on the
    unpadded images.  It is what the window-extraction TPU kernel
    (core/pallas_windows.py, reached through `_windows`) becomes for this
    caller.
  * `_track_passes` dispatches: a CPU tensor takes the reference; a CUDA
    tensor launches the kernel or raises.  There is no fallback.

`_lk_level` is one level in plain PyTorch (the JAX package's `_lk_level`)
and takes CPU tensors only: on the card a level runs inside the one
launch of `_track_passes`.

The acceptance gate at the end of `track_features` (`_track_gate`) has
the same three forms:

  * `_track_gate_reference`: plain PyTorch — forward-backward error,
    in-image test, two `_bilinear_patches` (edge pad, window indexing,
    `_lerp2`), `_zncc`, the conjunction of the flags.  The CPU runs
    it, and the kernel is held against it.
  * `_track_gate_cuda`: the hand-written Hopper kernel
    (csrc/zncc_gate.cu): all of that for every lane in one launch on the
    unpadded images; it writes `ok` and `ncc` and nothing else.  It is
    what the window-extraction TPU kernel becomes for the ZNCC caller.
  * `_track_gate` dispatches as `_track_passes` does.

`launches` counts the LK kernel's launches, `gate_launches` the gate
kernel's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..core.windows import slice_windows_reference

launches = 0  # _track_passes_cuda kernel launches since the last reset
gate_launches = 0  # _track_gate_cuda kernel launches since the last reset
MAX_PATCH = 15  # kMaxPatch of csrc/lk_track.cu and csrc/zncc_gate.cu
MAX_LEVELS = 8  # kMaxLevels of csrc/lk_track.cu


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Gaussian-ish pyramid via 2x2 average pooling, finest first.  Each
    block's sum is written out in the order the CPU's `mean` adds it, so
    that a card, whose reduction adds otherwise, rounds every level to
    the CPU's bits: one ulp of a level moves the tracked positions by
    1e-4 to 1e-3 px."""
    img = img.to(torch.float32)
    pyr = [img]
    for _ in range(levels - 1):
        h, w = pyr[-1].shape
        q = pyr[-1][: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
        pyr.append(((q[:, 0, :, 0] + q[:, 0, :, 1])
                    + (q[:, 1, :, 0] + q[:, 1, :, 1])) * 0.25)
    return pyr


def _clamp_bounds(H: int, W: int, slack: int) -> tuple[float, float, float]:
    """(lo, hi_x, hi_y) of `_split_frac`'s clamp, rounded to float32 as
    the clamp itself rounds them."""
    return (-float(slack), float(np.float32(W - 1.001 + slack)),
            float(np.float32(H - 1.001 + slack)))


def _split_frac(uv: torch.Tensor, H: int, W: int, slack: int = 0):
    """Clamped integer corner + fractional remainder per feature.

    `slack` widens the clamp window by that many pixels beyond the
    image on each side (pair it with an equally wider edge-pad).  This
    matters DURING LK iterations: an iterate transiently stepping a
    few pixels past the border must keep sampling a patch that MOVES
    with it (in-image taps still varying, out-of-image taps saturated
    at the border row/column — per-tap-clamp semantics).  A zero-slack
    center clamp instead freezes the whole patch at the border, so the
    frozen residual re-applies the same update every iteration and the
    track runs away."""
    lo, hi_x, hi_y = _clamp_bounds(H, W, slack)
    x = torch.clamp(uv[:, 0], lo, hi_x)
    y = torch.clamp(uv[:, 1], lo, hi_y)
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    return ix, iy, x - ix, y - iy


def _edge_pad(img: torch.Tensor, m: int) -> torch.Tensor:
    """[H + 2m, W + 2m] edge-replicated pad (jnp.pad mode="edge")."""
    return F.pad(img[None, None], (m, m, m, m), mode="replicate")[0, 0]


def _windows(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
             K: int) -> torch.Tensor:
    """[N, K, K] integer-start windows of a single-plane image, by plain
    indexing: only the plain versions of the level and the gate crop."""
    return slice_windows_reference(img[None], sy, sx, K, K)[:, 0]


def _lerp2(win: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
           ) -> torch.Tensor:
    """Bilinear blend of a [N, K, K] integer window at per-feature
    fractional offset → [N, K-1, K-1] samples."""
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    top = (1 - fx) * win[:, :-1, :-1] + fx * win[:, :-1, 1:]
    bot = (1 - fx) * win[:, 1:, :-1] + fx * win[:, 1:, 1:]
    return (1 - fy) * top + fy * bot


def _bilinear_patches(img: torch.Tensor, centers: torch.Tensor,
                      patch: int) -> torch.Tensor:
    """[N, patch*patch] bilinear patches at integer-grid offsets
    around `centers` (window extraction + 4-tap blend, no gathers)."""
    H, W = img.shape
    r = (patch - 1) // 2
    slack = r + 1  # excursions past this saturate fully, like per-tap clamp
    m = r + 1 + slack
    ix, iy, fx, fy = _split_frac(centers, H, W, slack)
    pad = _edge_pad(img, m)
    win = _windows(pad, iy - r + m, ix - r + m, patch + 1)
    return _lerp2(win, fx, fy).reshape(centers.shape[0], -1)


def _lk_level_reference(prev_img, next_img, uv_prev, uv_guess, patch, iters,
                        min_det):
    """One pyramid level of iterative LK for all features at once, in
    plain PyTorch.

    Template AND its central-difference gradients come from a single
    (patch+3)^2 integer window per feature: the bilinear blend of the
    window gives samples on the (patch+2)^2 grid floor(c)+k+f, whose
    interior is the template and whose ±1 shifts are the gradient
    stencils."""
    N = uv_prev.shape[0]
    H, W = prev_img.shape
    r = (patch - 1) // 2
    slack = r + 1  # see _split_frac — per-tap-clamp border semantics
    m = r + 2 + slack

    ix, iy, fx, fy = _split_frac(uv_prev, H, W, slack)
    prev_pad = _edge_pad(prev_img, m)
    win = _windows(prev_pad, iy - r - 1 + m, ix - r - 1 + m, patch + 3)
    B = _lerp2(win, fx, fy)  # [N, patch+2, patch+2]
    template = B[:, 1:-1, 1:-1].reshape(N, -1)
    gx = ((B[:, 1:-1, 2:] - B[:, 1:-1, :-2]) * 0.5).reshape(N, -1)
    gy = ((B[:, 2:, 1:-1] - B[:, :-2, 1:-1]) * 0.5).reshape(N, -1)
    gxx = torch.sum(gx * gx, dim=1)
    gxy = torch.sum(gx * gy, dim=1)
    gyy = torch.sum(gy * gy, dim=1)
    det = gxx * gyy - gxy * gxy
    ok = det > min_det
    inv_det = torch.where(
        ok, 1.0 / torch.where(det == 0, torch.ones_like(det), det),
        torch.zeros_like(det))

    next_pad = _edge_pad(next_img, m)
    uv = uv_guess
    for _ in range(iters):
        jx, jy, hx, hy = _split_frac(uv, H, W, slack)
        wn = _windows(next_pad, jy - r + m, jx - r + m, patch + 1)
        cur = _lerp2(wn, hx, hy).reshape(N, -1)
        err = cur - template  # [N, K]
        bx = torch.sum(err * gx, dim=1)
        by = torch.sum(err * gy, dim=1)
        du = -(gyy * bx - gxy * by) * inv_det
        dv = -(-gxy * bx + gxx * by) * inv_det
        uv = uv + torch.stack([du, dv], dim=1)
    return uv, ok


def _lk_level(prev_img, next_img, uv_prev, uv_guess, patch, iters, min_det):
    """One pyramid level in plain PyTorch, for CPU tensors.  On the card
    the levels run only inside the single launch of `_track_passes`, so a
    tensor elsewhere is refused."""
    if prev_img.device.type != "cpu":
        raise ValueError(f"_lk_level takes CPU tensors, got "
                         f"{prev_img.device}; on the card the levels run "
                         f"in _track_passes")
    return _lk_level_reference(prev_img, next_img, uv_prev, uv_guess, patch,
                               iters, min_det)


def _track_passes_reference(prev_pyr, next_pyr, uv, guess, patch, iters,
                            min_det):
    """Both LK passes of `track_features` in plain PyTorch: (uv_f, ok_f,
    uv_b, ok_b).  The forward pass starts at `guess` (at `uv` when it is
    None), the backward pass tracks uv_f back from `next_pyr` to
    `prev_pyr` starting at `uv`."""
    uv_f, ok_f = _pyramidal(prev_pyr, next_pyr, uv, patch, iters, min_det,
                            guess=guess)
    uv_b, ok_b = _pyramidal(next_pyr, prev_pyr, uv_f, patch, iters, min_det,
                            guess=uv)
    return uv_f, ok_f, uv_b, ok_b


def _track_passes_cuda(prev_pyr, next_pyr, uv, guess, patch, iters,
                       min_det):
    """Both LK passes by the fused CUDA kernel, one launch: (uv_f [N, 2],
    ok_f [N], uv_b [N, 2], ok_b [N]).

    Takes two pyramids of 1 to MAX_LEVELS contiguous f32 [H, W] images,
    equal in shape level by level, and contiguous f32 [N, 2] `uv` and
    `guess`, all on one CUDA device, and an odd `patch` of at most
    MAX_PATCH; raises on anything else."""
    global launches
    dev = uv.device
    if dev.type != "cuda":
        raise ValueError(f"_track_passes_cuda needs CUDA tensors, got {dev}")
    if patch % 2 != 1 or not 1 <= patch <= MAX_PATCH:
        raise ValueError(f"patch must be odd and at most {MAX_PATCH}, "
                         f"got {patch}")
    if iters < 0:
        raise ValueError(f"iters must not be negative, got {iters}")
    L = len(prev_pyr)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"pyramids of 1 to {MAX_LEVELS} levels, got {L}")
    if len(next_pyr) != L:
        raise ValueError(f"the pyramids must have the same levels, got {L} "
                         f"and {len(next_pyr)}")
    N = uv.shape[0]
    f32 = torch.float32
    named = [("uv", uv, (N, 2)), ("guess", guess, (N, 2))]
    for lvl, (a, b) in enumerate(zip(prev_pyr, next_pyr)):
        if a.dim() != 2 or min(a.shape) < 1 or b.shape != a.shape:
            raise ValueError(f"level {lvl}: images must be [H, W] of one "
                             f"shape, got {tuple(a.shape)}, "
                             f"{tuple(b.shape)}")
        named += [(f"prev_pyr[{lvl}]", a, a.shape),
                  (f"next_pyr[{lvl}]", b, a.shape)]
    for name, t, shape in named:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.device != dev or t.dtype != f32:
            raise ValueError(f"{name} must be {f32} on {dev}, got {t.dtype} "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    r = (patch - 1) // 2
    levels = (kernels.LkLevel * L)()
    for lvl, (a, b) in enumerate(zip(prev_pyr, next_pyr)):
        H, W = a.shape
        levels[lvl] = kernels.LkLevel(a.data_ptr(), b.data_ptr(), H, W,
                                      *_clamp_bounds(H, W, r + 1))
    uv_f = torch.empty((N, 2), dtype=f32, device=dev)
    uv_b = torch.empty((N, 2), dtype=f32, device=dev)
    ok_f = torch.empty((N,), dtype=torch.bool, device=dev)
    ok_b = torch.empty((N,), dtype=torch.bool, device=dev)
    lib = kernels.library("lk_track")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mld_lk_track(
            levels, L, uv.data_ptr(), guess.data_ptr(), uv_f.data_ptr(),
            ok_f.data_ptr(), uv_b.data_ptr(), ok_b.data_ptr(), N, patch,
            iters, min_det, stream)
        kernels.check(lib, code, "lk_track kernel launch")
        launches += 1
    return uv_f, ok_f, uv_b, ok_b


def _track_passes(prev_pyr, next_pyr, uv, guess, patch, iters, min_det):
    """Both LK passes on the pyramids' device: the fused CUDA kernel for
    CUDA tensors, the plain reference for CPU tensors."""
    dev = prev_pyr[0].device
    if dev.type == "cuda":
        return _track_passes_cuda(
            [x.contiguous() for x in prev_pyr],
            [x.contiguous() for x in next_pyr], uv.contiguous(),
            (uv if guess is None else guess).contiguous(), patch, iters,
            min_det)
    if dev.type == "cpu":
        return _track_passes_reference(prev_pyr, next_pyr, uv, guess, patch,
                                       iters, min_det)
    raise ValueError(f"no LK passes for device {dev}")


def track_features(
    prev_pyr: list[torch.Tensor],
    next_pyr: list[torch.Tensor],
    uv: torch.Tensor,
    valid: torch.Tensor,
    patch: int = 9,
    iters: int = 8,
    min_det: float = 1e-4,
    min_ncc: float = 0.6,
    fb_threshold: float = 1.0,
    uv_guess: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track features from prev to next frame.

    Coarse-to-fine pyramidal LK + two rejection tests:
      * forward-backward consistency (track back from the found
        position; must return within fb_threshold px), and
      * appearance: zero-normalized cross-correlation between the
        template and the tracked patch must exceed min_ncc — the FB
        check alone cannot reject a tracker that never moved (stuck in
        a local optimum, trivially FB-consistent).

    `uv_guess` optionally warm-starts the search (e.g. motion-model
    prediction) — essential for large inter-frame flows (fast turns)
    that exceed the pyramid's convergence basin from a zero-flow start.

    Returns (uv_next [N, 2], ok [N]).
    """
    if patch % 2 != 1:
        # _bilinear_patches / _lk_level center windows at
        # r = (patch-1)//2, which silently shifts the grid for even
        # patch sizes — the symmetric-window assumption is structural.
        raise ValueError(f"patch size must be odd, got {patch}")
    # forward pass, then the backward pass: its expected landing point is
    # the forward start
    uv_f, ok_f, uv_b, ok_b = _track_passes(prev_pyr, next_pyr, uv, uv_guess,
                                           patch, iters, min_det)
    ok, _ = _track_gate(prev_pyr[0], next_pyr[0], uv, uv_f, uv_b, valid,
                        ok_f, ok_b, patch, min_ncc, fb_threshold)
    return uv_f, ok


def _track_gate_reference(prev_img, next_img, uv, uv_f, uv_b, valid, ok_f,
                          ok_b, patch, min_ncc, fb_threshold):
    """The acceptance gate of `track_features` in plain PyTorch:
    (ok [N] bool, ncc [N] f32).  A lane passes if it was valid, both LK
    passes were well conditioned, the backward pass returned within
    `fb_threshold` px of the start, the tracked position lies inside the
    image and the template and the tracked patch correlate above
    `min_ncc`.  A NaN position fails every comparison it enters and gives
    a NaN `ncc`."""
    d = uv_b - uv
    fb_err = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    H, W = next_img.shape
    in_img = ((uv_f[:, 0] > 1) & (uv_f[:, 0] < W - 2)
              & (uv_f[:, 1] > 1) & (uv_f[:, 1] < H - 2))
    t = _bilinear_patches(prev_img, uv, patch)
    c = _bilinear_patches(next_img, uv_f, patch)
    ncc = _zncc(t, c)
    ok = (valid & ok_f & ok_b & (fb_err < fb_threshold) & in_img
          & (ncc > min_ncc))
    return ok, ncc


def _track_gate_cuda(prev_img, next_img, uv, uv_f, uv_b, valid, ok_f, ok_b,
                     patch, min_ncc, fb_threshold):
    """The acceptance gate by the fused CUDA kernel: (ok [N], ncc [N]).

    Takes contiguous f32 [H, W] images of one shape, contiguous f32
    [N, 2] positions and contiguous bool [N] flags on one CUDA device, an
    odd `patch` of at most MAX_PATCH; raises on anything else."""
    global gate_launches
    dev = prev_img.device
    if dev.type != "cuda":
        raise ValueError(f"_track_gate_cuda needs CUDA tensors, got {dev}")
    if patch % 2 != 1 or not 1 <= patch <= MAX_PATCH:
        raise ValueError(f"patch must be odd and at most {MAX_PATCH}, "
                         f"got {patch}")
    if prev_img.dim() != 2 or next_img.shape != prev_img.shape:
        raise ValueError(f"images must be [H, W] of one shape, got "
                         f"{tuple(prev_img.shape)}, {tuple(next_img.shape)}")
    N = uv.shape[0]
    f32, flag = torch.float32, torch.bool
    for name, t, dtype, shape in (
            ("prev_img", prev_img, f32, prev_img.shape),
            ("next_img", next_img, f32, prev_img.shape),
            ("uv", uv, f32, (N, 2)), ("uv_f", uv_f, f32, (N, 2)),
            ("uv_b", uv_b, f32, (N, 2)), ("valid", valid, flag, (N,)),
            ("ok_f", ok_f, flag, (N,)), ("ok_b", ok_b, flag, (N,))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    H, W = prev_img.shape
    lo, hi_x, hi_y = _clamp_bounds(H, W, (patch - 1) // 2 + 1)
    ok = torch.empty((N,), dtype=torch.bool, device=dev)
    ncc = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = kernels.library("zncc_gate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mld_zncc_gate(
            prev_img.data_ptr(), next_img.data_ptr(), uv.data_ptr(),
            uv_f.data_ptr(), uv_b.data_ptr(), valid.data_ptr(),
            ok_f.data_ptr(), ok_b.data_ptr(), ok.data_ptr(), ncc.data_ptr(),
            H, W, N, patch, min_ncc, fb_threshold, lo, hi_x, hi_y,
            float(W - 2), float(H - 2), stream)
        kernels.check(lib, code, "zncc_gate kernel launch")
        gate_launches += 1
    return ok, ncc


def _track_gate(prev_img, next_img, uv, uv_f, uv_b, valid, ok_f, ok_b, patch,
                min_ncc, fb_threshold):
    """The acceptance gate on the images' device: the fused CUDA kernel
    for CUDA tensors, the plain reference for CPU tensors."""
    if prev_img.device.type == "cuda":
        return _track_gate_cuda(
            prev_img, next_img, uv.contiguous(), uv_f.contiguous(),
            uv_b.contiguous(), valid.contiguous(), ok_f.contiguous(),
            ok_b.contiguous(), patch, min_ncc, fb_threshold)
    if prev_img.device.type == "cpu":
        return _track_gate_reference(prev_img, next_img, uv, uv_f, uv_b,
                                     valid, ok_f, ok_b, patch, min_ncc,
                                     fb_threshold)
    raise ValueError(f"no track gate for device {prev_img.device}")


def _zncc(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8
          ) -> torch.Tensor:
    """Zero-normalized cross-correlation of patch rows [N, K] → [N]."""
    am = a - torch.mean(a, dim=1, keepdim=True)
    bm = b - torch.mean(b, dim=1, keepdim=True)
    num = torch.sum(am * bm, dim=1)
    den = torch.sqrt(torch.sum(am * am, dim=1) * torch.sum(bm * bm, dim=1))
    return num / torch.clamp(den, min=eps)


def _pyramidal(src_pyr, dst_pyr, uv, patch, iters, min_det, guess=None):
    levels = len(src_pyr)
    scale = 2.0 ** (levels - 1)
    guess = (uv if guess is None else guess) / scale
    ok_all = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        guess, ok = _lk_level_reference(src_pyr[lvl], dst_pyr[lvl], uv / s,
                                        guess, patch, iters, min_det)
        ok_all = ok_all & ok
        if lvl > 0:
            guess = guess * 2.0
    return guess, ok_all
