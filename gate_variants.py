#!/usr/bin/env python3
"""What the fused ZNCC gate's launch is made of, on one CUDA GPU.

    python3 gate_variants.py

Builds csrc/zncc_gate.cu five times beside the shipped library: with 2,
4, 8 and 16 warps (features) per block (-DMLD_GATE_WARPS), and with an
empty body (-DMLD_GATE_EMPTY: the shipped grid of blocks that return at
once, which is what a launch costs before it does any work).  Each is
called through the port's own wrapper at the main path's shape
(chip_smoke.py's rendered frame pair at 370x1226, 2,048 lanes, patch 9,
positions from a real forward and backward LK pass), the variants in
turns, forward then backward, twice; device time from torch.profiler
(chip_smoke.device_ms).  Every variant but the empty one must give the
shipped library's `ok` and `ncc` to the bit.  The shipped kernel on 4
lanes alone (one block) is timed beside them.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np

import bench_torch
import chip_smoke as cs

VARIANTS = {"w2": ["-DMLD_GATE_WARPS=2"], "w4": ["-DMLD_GATE_WARPS=4"],
            "w8": ["-DMLD_GATE_WARPS=8"], "w16": ["-DMLD_GATE_WARPS=16"],
            "empty": ["-DMLD_GATE_EMPTY"]}
ROUNDS = 2


def build_variants(kernels) -> dict:
    """One nvcc per variant, all started together."""
    out_dir = kernels.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = kernels._CSRC / "zncc_gate.cu"
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *defs, "-o",
         str(out_dir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in VARIANTS.items()}
    logs = {name: (p.communicate()[0], p.returncode)
            for name, p in procs.items()}
    for name, (text, rc) in logs.items():
        cs.check(rc == 0, f"nvcc failed on variant {name}:\n{text}")
    return {name: kernels.load("zncc_gate", out_dir / f"{name}.so")
            for name in VARIANTS}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gate_variants.py needs a CUDA GPU", file=sys.stderr)
        return 1
    from mono_lidar_depth_tpu_torch import kernels
    from mono_lidar_depth_tpu_torch.eval.kitti_eval import _dev_img
    from mono_lidar_depth_tpu_torch.io.synthetic_dataset import (
        SyntheticSpec, render_sequence)
    from mono_lidar_depth_tpu_torch.tracker import klt

    card = bench_torch.card_line(torch.device("cuda"))
    dev = torch.device("cuda")
    seq = render_sequence(SyntheticSpec(frames=2), seed=cs.SEED)
    pyr0, pyr1 = (klt.build_pyramid(
        _dev_img(torch.from_numpy(seq.image(k)).to(dev)), cs.LEVELS)
        for k in (0, 1))
    N = 2048
    lanes = cs.tracked_gate_lanes(np.random.default_rng(4), pyr0, pyr1, N,
                                  cs.PATCH)
    few = [x[:4].contiguous() for x in lanes]

    def gate(inputs=lanes):
        return klt._track_gate_cuda(pyr0[0], pyr1[0], *inputs, cs.PATCH,
                                    cs.MIN_NCC, cs.FB_THRESHOLD)

    shipped = kernels.library("zncc_gate")
    want_ok, want_ncc = gate()
    libs = build_variants(kernels)
    H, W = pyr0[0].shape
    by_bytes, _ = cs.gate_bound_ms(H, W, N, cs.PATCH)
    cs.log(f"zncc_gate variants at {H}x{W}, N={N}, patch {cs.PATCH}; bytes "
           f"bound {by_bytes:.5f} ms [{card}]")
    order = list(VARIANTS)
    try:
        for rnd in range(ROUNDS):
            for name in order + order[::-1]:
                kernels._libs["zncc_gate"] = libs[name]
                ok, ncc = gate()
                same = (name == "empty" or (
                    torch.equal(ok, want_ok)
                    and torch.equal(ncc.view(torch.int32),
                                    want_ncc.view(torch.int32))))
                cs.check(same, f"variant {name} differs from the shipped "
                               f"kernel")
                ms = cs.device_ms(gate, "zncc_gate_kernel")
                cs.log(f"round {rnd} {name} {ms:.5f} ms")
            kernels._libs["zncc_gate"] = shipped
            ms = cs.device_ms(lambda: gate(few), "zncc_gate_kernel")
            cs.log(f"round {rnd} shipped on 4 lanes alone {ms:.5f} ms")
    finally:
        kernels._libs["zncc_gate"] = shipped
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
