#!/usr/bin/env python3
"""The control of a cell's check, and the program's readings beside it.

    python3 limo_bench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds S]

For each seed the cell is run as the benchmark runs it, its traffic file
unchanged (so the check samples the frames a run samples), with a
window of S seconds that holds them all: once by the port as the
configurations state it, float32 with TF32 off, and once by the control,
the port with its TF32 switch on (`torch.backends.cuda.matmul.allow_tf32`
and `torch.backends.cudnn.allow_tf32`, which the port turns off at
import), the step down in precision that would tempt a later change.
Both are judged by the same check against the plain reference.  Each
number compared is printed with its reading, one JSON line per seed and
side; the limits of the configuration files were set between the
largest reading of the port and the smallest of the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from limo_bench import run  # noqa: E402


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    import mono_lidar_depth_tpu_torch  # noqa: F401  (turns TF32 off)

    for seed in args.seeds:
        for side in ("port", "control"):
            set_tf32(side == "control")
            t0 = time.perf_counter()
            try:
                res = run.run_cell(args.workload, seed, args.seconds, False,
                                   t_start=t0)
            finally:
                set_tf32(False)
            print(json.dumps({"seed": seed, "side": side,
                              "correct": res["correct"],
                              "frames": res["attempted"],
                              "seconds": time.perf_counter() - t0,
                              "check_s": res["check_s"],
                              "readings": {k: c["value"] for k, c in
                                           res["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
