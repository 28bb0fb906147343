#!/usr/bin/env python3
"""Depth-association success rate against lidar density, for the
PyTorch/CUDA port (counterpart of scripts/exp_success_rate.py).

The reference's committed log shows 82.7% success on lidar-covered
features (64-beam Velodyne on KITTI); the synthetic loop has 20 rows.
This sweeps the lidar's row count on the same scene, trajectory and
configuration and reports the success shares per density: if they climb
with density, the gap is the instrument's geometry, not the algorithm.

    python3 scripts/exp_success_rate_torch.py                 # cuda:0
    python3 scripts/exp_success_rate_torch.py --no-far-veto --rows 20 64
    python3 scripts/exp_success_rate_torch.py --device cpu --frames 8 \\
        --rows 20

Prints one JSON line per density, then {"sweep": [...]}, as the reference
does.  Where it departs from the reference:
  * The sequence is rendered in memory with `render_sequence`, not
    written as PNGs and read back (the images are the same bytes; Pillow
    is not needed).  `--max-range` wraps the rendered sequence's `scans`
    as the reference wraps `KittiSequence.scans`.
  * `--device` (default cuda:0) takes the place of `--platform`; without
    a card the script exits 1 unless given `--device cpu`.
  * On stderr, one more JSON line {"port": ...}: the card (nvidia-smi's
    name and power limit), the torch version, each density's seconds and
    the kernel launches of the whole sweep.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402  (the repo root is on the path now)
from mono_lidar_depth_tpu_torch import DepthEstimatorConfig  # noqa: E402
from mono_lidar_depth_tpu_torch.core.result_types import (  # noqa: E402
    DepthResultType)
from mono_lidar_depth_tpu_torch.eval import eval_depth_sequence  # noqa: E402
from mono_lidar_depth_tpu_torch.io.synthetic_dataset import (  # noqa: E402
    SyntheticSpec, render_sequence)
from mono_lidar_depth_tpu_torch.obs.launches import (  # noqa: E402
    kernel_launches, launches_since)

W, H = 384, 128
DEPTH_KW = dict(max_tracks=512, max_length=8, verbose=False)


def sweep_spec(frames: int, rows: int, road_texture: float = 1.0
               ) -> SyntheticSpec:
    """The reference's scene at `rows` lidar rows (500 columns each)."""
    return SyntheticSpec(frames=frames, image_width=W, image_height=H,
                         focal=240.0, lidar_rows=rows, lidar_cols=500,
                         step=0.55, loop=True, road_texture=road_texture)


def sweep_config(rows: int, far_veto: bool = True) -> DepthEstimatorConfig:
    """The reference's configuration: room for every point of a scan."""
    return DepthEstimatorConfig(
        max_points=max(16384, 1 << (rows * 500 - 1).bit_length()),
        max_features=384, image_width=W, image_height=H,
        radiusSearch_count_min=1, road_any_far_veto=far_veto,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)


def cap_range(seq, max_range: float) -> None:
    """Drop every return farther than `max_range` metres from the lidar:
    the reference's wrapper of the sequence's `scans`."""
    inner_scans = seq.scans

    def capped_scans(max_points, _inner=inner_scans):
        for xyzi, count in _inner(max_points):
            r = np.linalg.norm(xyzi[:count, :3], axis=1)
            keep = xyzi[:count][r <= max_range]
            out = np.zeros_like(xyzi)
            out[:len(keep)] = keep
            yield out, len(keep)

    seq.scans = capped_scans


def top_outcomes(counters) -> dict:
    """The six most frequent outcomes with their shares, by name."""
    total = max(1, int(sum(counters)))
    order = sorted(range(len(counters)), key=lambda i: -counters[i])
    return {DepthResultType(i).name: round(counters[i] / total, 4)
            for i in order[:6] if counters[i]}


def sweep_row(frames: int, rows: int, road_texture: float, far_veto: bool,
              max_range: Optional[float], device) -> dict:
    """One density: render, evaluate, the reference's row."""
    seq = render_sequence(sweep_spec(frames, rows, road_texture))
    if max_range is not None:
        cap_range(seq, max_range)
    out = eval_depth_sequence(seq, sweep_config(rows, far_veto),
                              device=device, **DEPTH_KW)
    return {"lidar_rows": rows,
            "max_range": max_range,
            "road_texture": road_texture,
            "far_veto": far_veto,
            "success_all": round(out["success_rate_all"], 4),
            "success_covered": round(out["success_rate_lidar_covered"], 4),
            "total_points": int(out["total_points"]),
            "top_outcomes": top_outcomes(out["counters"])}


def run(frames: int = 60, rows: Sequence[int] = (10, 20, 40, 64),
        road_texture: float = 1.0, far_veto: bool = True,
        max_range: Optional[float] = None, device="cuda:0") -> dict:
    """The sweep on `device`; prints the reference's JSON lines and
    returns {"sweep": rows, "port": ...}."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_success_rate_torch: no CUDA device; pass "
                           "device='cpu' for a run on the CPU")
    before = kernel_launches()
    results, seconds = [], []
    for r in rows:
        t0 = time.perf_counter()
        row = sweep_row(frames, r, road_texture, far_veto, max_range, dev)
        seconds.append(time.perf_counter() - t0)
        results.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"sweep": results}), flush=True)
    return {"sweep": results, "port": {
        "card": bench_torch.card_line(dev), "torch": torch.__version__,
        "device": str(dev), "seconds": seconds,
        "launches": launches_since(before)}}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--rows", type=int, nargs="+", default=[10, 20, 40, 64])
    ap.add_argument("--road-texture", type=float, default=1.0,
                    help="road texture contrast (SyntheticSpec.road_texture)"
                         ": small values render a near-uniform road, which "
                         "the tracker avoids, as on real asphalt")
    ap.add_argument("--no-far-veto", action="store_true",
                    help="improved road mode: trim off-plane neighbors "
                         "instead of the reference's whole-pass any-far "
                         "veto (config.road_any_far_veto=False)")
    ap.add_argument("--max-range", type=float, default=None,
                    help="cap lidar returns at this range (m)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions on the CPU)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        print("exp_success_rate_torch: no CUDA device; pass --device cpu for "
              "a run on the CPU", file=sys.stderr)
        return 1
    out = run(args.frames, args.rows, args.road_texture,
              not args.no_far_veto, args.max_range, args.device)
    print(json.dumps({"port": out["port"]}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
