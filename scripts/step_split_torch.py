#!/usr/bin/env python3
"""Where config 3's single steps part between the card and the CPU, stage
by stage and op by op.

    python3 scripts/step_split_torch.py --out split_out   # cuda:0

It runs the evaluation record's config 3 (`make_parity_record_torch`:
the 220-frame loop, `record_config()`, `VO_KW`) on the card one frame
per chunk, keeping the carry after every frame, and steps every frame
once on the CPU from the card's carry with the card's RANSAC draws, as
the record's `replay_steps_on_cpu` does.  Every frame whose step parts
(the pose beyond the record's POSE_BAR, the motion-track or inlier
counts, or any lane's code) is stepped again on both devices with the
depth association's stages traced (`chip_smoke._CascadeTrace` over
STAGES, their arguments and results copied to the host).  For each stage call, in call order, it reports
whether the two devices' inputs and outputs are equal to the bit; a
stage whose inputs are equal and whose outputs differ is replayed op by
op on both devices from the CPU's inputs (`chip_smoke._op_chain`), on
the first row that differs.  The first such stage and its first parting
op name where the frame parts.

It prints one line per frame and writes `step_split.json` to `--out`.
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
import chip_smoke  # noqa: E402
import make_parity_record_torch as P  # noqa: E402
from mono_lidar_depth_tpu_torch.convert import (  # noqa: E402
    state_from_numpy, state_to_numpy)

# (module under mono_lidar_depth_tpu_torch, name) of each traced stage,
# in the order a step calls them
STAGES = (("eval.kitti_eval", "track_frame"),
          ("tracks.pipeline", "fit_ground_plane_ransac"),
          ("core.ransac", "_ls_plane"),
          ("tracks.pipeline", "rasterize_cloud"),
          ("core.depth_estimator", "plane_to_camera"),
          ("core.depth_estimator", "_gather_two_scales"),
          ("core.depth_estimator", "filter_points_min_dist_blob"),
          ("core.depth_estimator", "max_spanning_triangle"),
          ("core.depth_estimator", "plane_from_points"),
          ("core.depth_estimator", "ray_plane_intersection"),
          ("core.depth_estimator", "mestimator_plane"),
          ("core.planefit", "_scatter3"),
          ("core.depth_estimator", "_apply_depth_gates"),
          ("core.depth_estimator", "_road_pass"),
          ("vo.pipeline", "process_frame"),
          ("vo.pipeline", "estimate_pose_gn"),
          ("vo.pipeline", "run_ba"))


def _arrays(tree):
    """The numpy leaves of a host tree, in order."""
    if isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _arrays(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _arrays(v)]
    return []


def _gap(a, b):
    """(equal to the bit, largest ulp distance of float leaves, the first
    row of the first leaf that differs or None)."""
    equal, ulps, row = True, 0, None
    for x, y in zip(_arrays(a), _arrays(b)):
        if x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            equal = False
            if x.dtype.kind == "f" and x.shape == y.shape:
                ulps = max(ulps, chip_smoke._ulps(x, y))
            if row is None and x.ndim and x.shape == y.shape:
                apart = (x != y) & ~((x != x) & (y != y))
                rows = np.flatnonzero(apart.reshape(len(x), -1).any(1))
                row = int(rows[0]) if rows.size else None
    return equal, ulps, row


def _traced_step(seq, cfg, f, carry, device):
    with P.eager_frames(), chip_smoke._CascadeTrace(STAGES) as t:
        P.one_step(seq, cfg, f, state_from_numpy(state_to_numpy(carry),
                                                 device), device)
    return t


def split_frame(seq, cfg, f, carry, dev) -> dict:
    """Frame f stepped on the card and on the CPU from `carry`, traced:
    each stage call's input and output gaps, and the op chain of every
    call whose inputs are equal and outputs differ."""
    g = _traced_step(seq, cfg, f, carry, dev)
    c = _traced_step(seq, cfg, f, carry, "cpu")
    rows, first = [], None
    for (name, ga, go), (_, ca, co) in zip(g.order, c.order):
        in_eq, in_u, _ = _gap(ga, ca)
        out_eq, out_u, row = _gap(go, co)
        entry = {"stage": name, "inputs_equal": in_eq, "inputs_ulp": in_u,
                 "outputs_equal": out_eq, "outputs_ulp": out_u}
        if in_eq and not out_eq:
            try:
                chain = chip_smoke._op_chain(
                    c.real(name), ca[0], ca[1],
                    (torch.device(dev), torch.device("cpu")), row)
            except AssertionError as e:  # an op writes its input in place
                entry.update(row=row, chain=f"not replayed: {e}")
            else:
                parted = [(w, op, u) for w, op, u in chain if u]
                entry.update(row=row, ops=len(chain),
                             parting_ops=parted[:12],
                             chain=chip_smoke._chain_text(chain))
            if first is None:
                first = {"stage": name, "row": row,
                         "op": (entry.get("parting_ops") or [None])[0]}
        rows.append(entry)
    return {"stages": rows, "first": first,
            "calls": [len(g.order), len(c.order)]}


def run(frames: int, dev: str, only=None) -> dict:
    seq = P.render_sequence(P.record_spec(frames))
    cfg = P.record_config()
    draws = P.card_draws(seq, cfg, dev)
    t0 = time.perf_counter()
    with P.steps_recorded() as rec:
        card = P.eval_vo_sequence(seq, cfg, P.OdometryConfig(), device=dev,
                                  **P.VO_KW)
    gaps = {}
    with P.given_draws(draws):
        for k, f in enumerate(card["frame_ids"]):
            with P.outcomes_recorded() as outcomes:
                step = P.one_step(seq, cfg, f, rec["carries"][f - 1], "cpu")
            gaps[f] = P.step_gap(step, outcomes[0][1], card["poses"][k],
                                 card["diag"][k], rec["outcomes"][k][1],
                                 rec["carries"][f])
        s = P.summarize_steps(gaps)
        apart = sorted(set(s["pose_frames"]) | set(s["count_frames"])
                       | set(s["code_frames"])) if only is None else only
        print(f"step_split: {len(gaps)} frames stepped card vs CPU in "
              f"{time.perf_counter() - t0:.1f} s: beyond the bar "
              f"{s['pose_frames']}, counts apart {s['count_frames']}, codes "
              f"apart {s['code_frames']} (agree {s['codes_agree']:.5f})",
              flush=True)
        out = {}
        for f in apart:
            r = split_frame(seq, cfg, f, rec["carries"][f - 1], dev)
            r.update(dR=gaps[f]["dR"], dt_m=gaps[f]["dt_m"],
                     counts_equal=gaps[f]["counts_equal"],
                     lanes=gaps[f]["lanes"])
            out[f] = r
            first = r["first"]
            print(f"frame {f}: |dR| {r['dR']:.2e} |dt| {r['dt_m']:.2e} m, "
                  f"counts {'equal' if r['counts_equal'] else 'differ'}, "
                  f"{len(r['lanes'])} lanes apart {r['lanes'][:6]}; first "
                  f"stage to part from equal inputs: "
                  f"{first and first['stage']} (row {first and first['row']}"
                  f", first op {first and first['op']})", flush=True)
            for e in r["stages"]:
                if not (e["inputs_equal"] and e["outputs_equal"]):
                    print(f"    {e['stage']}: inputs "
                          f"{'equal' if e['inputs_equal'] else 'apart'} "
                          f"({e['inputs_ulp']} ulp), outputs "
                          f"{'equal' if e['outputs_equal'] else 'apart'} "
                          f"({e['outputs_ulp']} ulp)"
                          + (f"; {e['chain']}" if "chain" in e else ""),
                          flush=True)
    return {"summary": s, "frames": out,
            "card": bench_torch.card_line(torch.device(dev)),
            "torch": torch.__version__}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", type=int, nargs="*", default=None,
                    help="split these frames instead of every frame apart")
    ap.add_argument("--out", default="split_out")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("step_split: no CUDA device", file=sys.stderr)
        return 1
    rec = run(args.frames, args.device, args.only)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "step_split.json").write_text(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
