#!/usr/bin/env python3
"""Config 3's RANSAC draws as a card makes them, kept in a file, and
config 3 replayed on the CPU from that file.

    python3 scripts/card_draws_torch.py save card_draws.npz
    python3 scripts/card_draws_torch.py replay tests/fixtures/card_draws_config3.npz

`save` (on a card) draws every frame's RANSAC sample of the evaluation
record's config 3 (`make_parity_record_torch`: the 220-frame loop,
`record_config()`) as a run on the card draws it (`card_draws`: the
frame's generator on the card) and writes them with the card's name and
the torch version.  `replay` (on any CPU) runs config 3 once on the CPU
with those draws (`given_draws`, as the record's `replay_on_cpu` does)
and prints its ATE and RPE: the card's own number, when the card and
the CPU compute the same steps.  A card's generator cannot be run on a
CPU, so the file is what lets a CPU reproduce the card's run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import bench_torch  # noqa: E402
import make_parity_record_torch as P  # noqa: E402
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws  # noqa: E402

FRAMES = 220


def save(path: Path, device: str = "cuda") -> None:
    seq = P.render_sequence(P.record_spec(FRAMES))
    draws = P.card_draws(seq, P.record_config(), device)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, sub_idx=np.stack([d.sub_idx.numpy() for d in draws]).astype(
            np.uint16),
        picks=np.stack([d.picks.numpy() for d in draws]).astype(np.uint16),
        card=bench_torch.card_line(torch.device(device)),
        torch=torch.__version__)


def load(path: Path) -> list:
    """The file's draws, one RansacDraws of int64 CPU tensors per frame."""
    z = np.load(path)
    return [RansacDraws(torch.from_numpy(s.astype(np.int64)),
                        torch.from_numpy(p.astype(np.int64)))
            for s, p in zip(z["sub_idx"], z["picks"])]


def replay(path: Path) -> dict:
    seq = P.render_sequence(P.record_spec(FRAMES))
    with P.given_draws(load(path)):
        vo = P.eval_vo_sequence(seq, P.record_config(), P.OdometryConfig(),
                                device="cpu", **P.VO_KW)
    z = np.load(path)
    return dict(P.vo_metrics(vo), draws_from=str(z["card"]),
                draws_torch=str(z["torch"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("save", "replay"))
    ap.add_argument("path", type=Path)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.mode == "save":
        if not torch.cuda.is_available():
            print("card_draws: save needs a card", file=sys.stderr)
            return 1
        save(args.path)
        print(f"wrote {args.path} ({time.perf_counter() - t0:.1f} s)")
        return 0
    print(json.dumps(dict(replay(args.path),
                          seconds=round(time.perf_counter() - t0, 1))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
