#!/usr/bin/env python3
"""How the fused LK passes' time scales with features and iterations, on
one CUDA GPU.

    python3 lk_scaling.py

Calls `lk_track` through the port's own wrapper on chip_smoke.py's
rendered frame pair (a 4-level pyramid from 370x1226, lanes from
chip_smoke.lk_lanes, patch 9) at SCALING's feature and iteration counts;
device time from torch.profiler (chip_smoke.device_ms).  132 features are
one warp on each SM of an H100, so their time is the chain of dependent
rounds alone; 0 iterations leave the template stages and the launch.
"""

from __future__ import annotations

import sys

import numpy as np

import bench_torch
import chip_smoke as cs

# (features, iterations) at which the kernel is timed.
SCALING = [(n, it) for n in (132, 528, 1056, 2048) for it in (0, 8)] + [
    (2048, 1), (2048, 2), (2048, 4)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lk_scaling.py needs a CUDA GPU", file=sys.stderr)
        return 1
    from mono_lidar_depth_tpu_torch import kernels
    from mono_lidar_depth_tpu_torch.eval.kitti_eval import _dev_img
    from mono_lidar_depth_tpu_torch.io.synthetic_dataset import (
        SyntheticSpec, render_sequence)
    from mono_lidar_depth_tpu_torch.tracker import klt

    kernels.build()
    card = bench_torch.card_line(torch.device("cuda"))
    dev = torch.device("cuda")
    seq = render_sequence(SyntheticSpec(frames=2), seed=cs.SEED)
    pyr0, pyr1 = (klt.build_pyramid(
        _dev_img(torch.from_numpy(seq.image(k)).to(dev)), cs.LEVELS)
        for k in (0, 1))
    lanes = cs.lk_lanes(np.random.default_rng(2), pyr0, 2048, cs.PATCH)
    for n, it in SCALING:
        few = [x[:n].contiguous() for x in lanes]
        ms = cs.device_ms(lambda: klt._track_passes_cuda(
            pyr0, pyr1, *few, cs.PATCH, it, cs.MIN_DET), "lk_track_kernel")
        cs.log(f"lk_track, {n} features, {it} iterations: {ms:.5f} ms "
               f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
