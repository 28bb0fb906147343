"""The work of the tracker's two hand kernels, counted from the
arguments of the functions that launch them, for their shares of the
roofline (`roofline.Work`: bytes over the H100's memory rate, float32
operations over its peak, the larger).  The counts are `chip_smoke.py`'s
(`lk_bound_ms`, `gate_bound_ms`) as they stood when the tracker's
metrics were defined: at 2,048 lanes, 4 levels of a 1226x370 pyramid
and patch 9, `lk_track` moves 4.89 MB and does 179.7 MFLOP, and
`zncc_gate` reads 3.63 MB of images, 27 B per lane, writes 5 B per lane
and does 6.6 MFLOP.
"""

from __future__ import annotations

from .roofline import Work


def lk_track_work(prev_pyr, next_pyr, uv, guess, patch, iters, min_det
                  ) -> Work:
    """`tracker/klt._track_passes` as called: both LK passes over every
    level.  Both pyramids read once; per lane uv and the guess read
    (2 x 8 B), both passes' positions and flags written (2 x 9 B).  Per
    pass, level and lane: the blend of the (patch + 2)^2 template
    samples (9 operations each), gradients and their products (10 per
    tap); per iteration and tap: blend 9, residual 1, two products 4."""
    N = uv.shape[0]
    taps = patch * patch
    nbytes = (sum(2 * a.shape[0] * a.shape[1] * 4 for a in prev_pyr)
              + N * (2 * 8 + 2 * 9))
    flops = 2 * len(prev_pyr) * N * ((patch + 2) ** 2 * 9 + taps * 10
                                     + iters * taps * 14)
    return Work(nbytes, flops)


def zncc_gate_work(prev_img, next_img, uv, uv_f, uv_b, valid, ok_f, ok_b,
                   patch, min_ncc, fb_threshold) -> Work:
    """`tracker/klt._track_gate` as called: both images read once; per
    lane three positions and three flags read (27 B), `ok` and `ncc`
    written (5 B); per tap of the two patches about 20 operations
    (blend 9, mean 1, centring 1, three products 6, the sums)."""
    H, W = prev_img.shape
    N = uv.shape[0]
    nbytes = 2 * H * W * 4 + N * (3 * 8 + 3) + N * 5
    return Work(nbytes, N * 2 * patch * patch * 20)
