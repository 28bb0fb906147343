#!/usr/bin/env python3
"""The host cost of the port's own spans (`obs/timing.span`), on the
benchmark's tracklet-depth cell (`limo_bench`, its configuration and
traffic as they are), on one CUDA card.

    python3 scripts/span_cost_torch.py [--frames 400] [--seed N]

Three readings, no profiler running unless said:

1. The cell's frames, every other frame with each span of
   `tracks/pipeline`, `tracks/frame_graph` and `core/depth_estimator` a
   null context (on a card the frames replay CUDA graphs, which enter
   only `assoc.frame` and `assoc.replay`): the host
   ms of each `process_frame` call and of each whole frame (upload,
   `process_frame`, read-back) on either side (median, mean), and the
   mean of the paired differences (a frame with spans less the null
   frame after it) with its standard error.  The frames are read back as
   the cell does, so the host never runs ahead of the card.
2. The eight spans alone, nested as `process_frame` nests them, with no
   work inside, against the same nest of null contexts: us per frame.
3. Under torch.profiler (CPU and CUDA activities): reading 2 again, and
   the cell's frames without and with spans in turns (after a stretch
   that starts the profiler up), with the device activities, the user
   annotations and the spans' ranges each stretch's trace holds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CONFIG, TRAFFIC = "kitti_hdl64_tracklet_depth", "online"
NEST_FRAMES = 20000


def null_span(name, frame=False):
    return contextlib.nullcontext()


@contextlib.contextmanager
def spans_off():
    """Every span of the association's call sites a null context."""
    from mono_lidar_depth_tpu_torch.core import depth_estimator
    from mono_lidar_depth_tpu_torch.tracks import frame_graph, pipeline

    mods = (pipeline, depth_estimator, frame_graph)
    saved = [m.span for m in mods]
    for m in mods:
        m.span = null_span
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.span = s


def side(name: str):
    """The spans as they are (`spans`) or every one a null context."""
    return spans_off() if name == "null" else contextlib.nullcontext()


def nest(span) -> None:
    """The eight spans as `process_frame` nests them, with no work."""
    with span("assoc.frame", frame=True):
        with span("assoc.ground_plane"):
            pass
        with span("assoc.match_tracks"):
            pass
        with span("assoc.rasterize"):
            pass
        with span("assoc.depth_pair"):
            with span("depth.segment"):
                pass
            with span("depth.road"):
                pass
        with span("assoc.update_tracks"):
            pass


def nest_us(n: int) -> dict:
    """us per frame of the spans' nest and of the null nest, in turns."""
    from mono_lidar_depth_tpu_torch.obs.timing import span

    out = {"spans": [], "null": []}
    for _ in range(4):
        for name, s in (("spans", span), ("null", null_span)):
            t0 = time.perf_counter()
            for _ in range(n):
                nest(s)
            out[name].append(1e6 * (time.perf_counter() - t0) / n)
    return {name: min(v) for name, v in out.items()}


def run(device="cuda", frames=400, seed=2 ** 31 + 1717, cfg=None,
        traffic=None, profiled_frames=20, nest_frames=NEST_FRAMES) -> dict:
    """The three readings (module docstring) as one dict."""
    import mono_lidar_depth_tpu_torch as T
    from limo_bench.pipelines import tracklet_depth
    from mono_lidar_depth_tpu_torch.obs import timing
    from torch.profiler import ProfilerActivity, profile

    bench = ROOT / "limo_bench"
    cfg = cfg or json.loads((bench / "configs" / f"{CONFIG}.json").read_text())
    traffic = traffic or json.loads(
        (bench / "traffic" / f"{TRAFFIC}.json").read_text())
    device = torch.device(device)
    process_frame = T.process_frame
    host_s: list = []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = process_frame(*args, **kw)
        host_s.append(time.perf_counter() - t0)
        return out

    T.process_frame = timed
    try:
        cell = tracklet_depth.Cell(T, cfg, traffic, seed, device, 0.0)
        timing._frames.clear()
        ms = {(what, name): [] for what in ("process_frame", "frame")
              for name in ("spans", "null")}
        for _ in range(frames):
            for name in ("spans", "null"):
                t0 = time.perf_counter()
                with side(name):
                    cell.frame()
                ms["frame", name].append(1e3 * (time.perf_counter() - t0))
                ms["process_frame", name].append(1e3 * host_s[-1])
        out = {"device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "torch": torch.__version__, "frames_each": frames}
        for (what, name), v in ms.items():
            out[f"{what}_{name}_ms"] = {
                "median": statistics.median(v), "mean": statistics.fmean(v)}
        for what in ("process_frame", "frame"):
            diffs = [a - b for a, b in zip(ms[what, "spans"],
                                           ms[what, "null"])]
            out[f"{what}_paired_diff_us"] = {
                "mean": 1e3 * statistics.fmean(diffs),
                "stderr": 1e3 * statistics.stdev(diffs) / len(diffs) ** 0.5}
        out["ring_assoc_frame"] = timing.frame_spans()["assoc.frame"]
        out["nest_us"] = nest_us(nest_frames)

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            out["nest_us_profiled"] = nest_us(nest_frames // 10)
        # a first profiled stretch starts the profiler up; then the two
        # sides in turns, each twice
        profiled = {"spans": [], "null": []}
        for name in ("warm", "null", "spans", "spans", "null"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            del host_s[:]
            with side(name), profile(activities=acts) as prof:
                for _ in range(profiled_frames):
                    cell.frame()
            if name == "warm":
                continue
            evs = prof.events()
            profiled[name].append({
                "process_frame_ms_median": 1e3 * statistics.median(host_s),
                "device_activities_per_frame": sum(
                    e.device_type == torch.autograd.DeviceType.CUDA
                    for e in evs) / profiled_frames,
                "user_annotations": sum(bool(e.is_user_annotation)
                                        for e in evs),
                "span_ranges_per_frame": sum(
                    e.name.startswith(("assoc.", "depth.")) for e in evs)
                / profiled_frames})
        out["profiled"] = profiled
        cell.release()
    finally:
        T.process_frame = process_frame
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=400,
                    help="frames on each side of reading 1")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1717)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    print(json.dumps(run("cuda", args.frames, args.seed), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
