#!/usr/bin/env python3
"""The benchmark of mono_lidar_depth_tpu_torch: one cell, one run.

    python3 limo_bench/run.py --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>
    python3 limo_bench/run.py --list

The harness is driven by its files, found by name: a configuration is
`configs/<config>.json` (sizes, sources, the limits of its check, and the
`pipeline` that runs it), a traffic mix is `traffic/<traffic>.json`, a
pipeline is `pipelines/<pipeline>.py` and a per-layer metric is
`metrics/<metric with dots as underscores>.py`.  A new one is a new file;
`--list` prints what was found (every run prints it on its first line of
standard error).

A run: set-up (render the configuration's lap on the card from the seed,
keep it in pinned host memory, build the port's kernels on a checkout's
first run, start the stream and warm it up), then the window of
`--seconds` in which frames are handed over as the traffic says, then,
with `--trace 1`, profiled frames, and last the check against the plain
reference.  The last line of standard output is the result's JSON.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Import the harness as the package `limo_bench` from the checkout's root,
# and not its files as top-level modules from their own directory.
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "mono_lidar_depth_tpu")
PORT = "mono_lidar_depth_tpu_torch"


def discover(bench: Path = BENCH) -> dict:
    """Every configuration, traffic mix, pipeline and per-layer metric
    found under `bench`, by name."""
    def stems(sub, suffix):
        return sorted(p.stem for p in (bench / sub).glob(f"*{suffix}")
                      if not p.stem.startswith("_"))

    return {"configs": stems("configs", ".json"),
            "traffic": stems("traffic", ".json"),
            "pipelines": stems("pipelines", ".py"),
            "metrics": stems("metrics", ".py")}


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def metric_modules(names=None) -> dict:
    """NAME -> module of every per-layer metric file (or of `names`)."""
    out = {}
    for stem in discover()["metrics"]:
        mod = importlib.import_module(f"limo_bench.metrics.{stem}")
        out[mod.NAME] = mod
    if names is None:
        return out
    missing = sorted(set(names) - set(out))
    if missing:
        raise SystemExit(f"limo_bench: no metric file for {missing}")
    return {n: out[n] for n in names}


def cell_metrics(workload: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric names of a cell, from
    BENCHMARK.json; without that file, every metric found."""
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        return (["frame_ms_p95", "frames_per_s", "setup_s"],
                sorted(metric_modules()))

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    bench = load_json(path)
    return ([m["name"] for m in bench["end_to_end"] if mine(m)],
            [m["name"] for m in bench["per_layer"] if mine(m)])


class Readings:
    """What the per-layer metrics read: the host spans of the window and
    the device trace of the profiled frames."""

    def __init__(self, tracer, trace):
        self.tracer, self.trace = tracer, trace

    def host_ms(self, label):
        return self.tracer.host_ms(label)

    def device_ms(self, label):
        spans = self.trace.span_s(self.tracer.marks, label)
        if not spans:
            return None
        return 1e3 * sum(spans) / self.trace.frames

    def roofline_pct(self, label):
        spans = self.trace.span_s(self.tracer.marks, label)
        work = self.tracer.work.get(label)
        if not spans or not work or sum(spans) <= 0:
            return None
        return 100.0 * sum(w.least_s() for w in work) / sum(spans)

    def idle_pct(self):
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)

    def activities_per_frame(self):
        return self.trace.activities_per_frame()


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, program=None, cfg: dict | None = None,
             traffic: dict | None = None, t_start: float | None = None
             ) -> dict:
    """One run of a cell; returns the result's fields.  `program` is the
    port unless a caller puts something in its place (the fault tests);
    `cfg` and `traffic` override the files."""
    import torch

    start = T_START if t_start is None else t_start
    config_name, traffic_name = workload.split(".", 1)
    cfg = cfg or load_json(BENCH / "configs" / f"{config_name}.json")
    traffic = traffic or load_json(BENCH / "traffic" / f"{traffic_name}.json")
    if traffic["arrival"] != "closed_loop":
        raise SystemExit(f"limo_bench: unknown arrival {traffic['arrival']!r}")
    device = torch.device(device or "cuda")
    if program is None:
        program = importlib.import_module(PORT)
    pipeline = importlib.import_module(
        f"limo_bench.pipelines.{cfg['pipeline']}")
    e2e, per_layer = cell_metrics(workload)
    tracer = None
    if trace:
        from limo_bench import spans as tr

        tracer = tr.Tracer()
        patched = set()
        for mod in metric_modules(per_layer).values():
            for module, attr, label, work in mod.SPANS:
                if (module, attr) not in patched:
                    patched.add((module, attr))
                    tracer.patch(importlib.import_module(module), attr,
                                 label, work)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_cell = time.perf_counter()
    cell = pipeline.Cell(program, cfg, traffic, seed, device, seconds)
    if cuda:
        torch.cuda.synchronize(device)
    setup_parts = {"before_cell_s": t_cell - start,
                   **getattr(cell, "setup_parts", {})}
    # closed loop: the next frame once the last is back
    lat = []
    t0 = time.perf_counter()
    setup_s = t0 - start
    t1 = t0
    while t1 - t0 < seconds:
        handed = time.perf_counter()
        cell.frame()
        t1 = time.perf_counter()
        lat.append(t1 - handed)
        if tracer:
            tracer.end_frame()
    window_s = t1 - t0
    out = {"attempted": len(lat), "setup_parts": setup_parts}
    metrics = {}
    if not trace:
        lat_ms = [1e3 * x for x in lat]
        values = {"frame_ms_p95": (percentile(lat_ms, 95), "ms"),
                  "frames_per_s": (len(lat) / window_s, "frames/s"),
                  "setup_s": (setup_s, "s")}
        metrics = {k: {"value": values[k][0], "unit": values[k][1]}
                   for k in e2e}
        out["frame_ms_median"] = statistics.median(lat_ms)
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(device) if cuda
                         else "cpu"),
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if cuda else 0)}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from limo_bench import spans as tr

        # The profiler is first started here, after the window: once
        # started it slows every launch of the process.
        marker = tr.marker_name()
        # Guard markers ahead of the frames absorb a marker that the
        # profiler may drop as it starts; a trace that still lost one is
        # taken again on fresh frames.
        for _ in range(3):
            tracer.marks.clear()
            tracer.work.clear()
            tracer.profiling = True
            n = 0
            torch.cuda.synchronize(device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(tr.GUARDS):
                    tr.marker()
                torch.cuda.synchronize(device)
                p0 = time.perf_counter()
                while n < 3 or (time.perf_counter() - p0
                                < traffic["trace_seconds"]):
                    cell.frame()
                    n += 1
                torch.cuda.synchronize(device)
                p1 = time.perf_counter()
            tracer.profiling = False
            out["attempted"] += n
            dt = tr.DeviceTrace(prof, marker, p1 - p0, n, len(tracer.marks))
            if dt.aligned:
                break
            print("limo_bench: the trace lost a marker; tracing again",
                  file=sys.stderr)
        else:
            raise RuntimeError("three traces lost markers")
        tracer.restore()
        r = Readings(tracer, dt)
        for name, mod in metric_modules(per_layer).items():
            v = mod.read(r)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
        dev_info["busy_s"] = dt.busy_s()
        dev_info["window_s"] = dt.window_s
        out["breakdown"] = {"device_ops": dt.top_ops(),
                            "idle_gaps": dt.idle_gaps()}
    out["failed"] = cell.failed()
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cell.check()
    out["check_s"] = time.perf_counter() - t_check
    limits = cfg["limits"]
    checked = numbers.pop("frames_checked")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    checks["frames_checked"] = {"value": checked, "limit": 1}  # at least
    out["correct"] = (out["failed"] == 0 and checked >= 1
                      and all(v <= limits[k] for k, v in numbers.items()))
    out["metrics"] = metrics
    out["device"] = dev_info
    out["checks"] = checks
    out["window_s"] = window_s
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true",
                    help="print the configurations, traffic mixes, "
                         "pipelines and metrics found, and exit")
    args = ap.parse_args(argv)
    found = discover()
    print(f"limo_bench: found {json.dumps(found)}", file=sys.stderr)
    if args.list:
        print(json.dumps(found))
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    config_name, _, traffic_name = args.workload.partition(".")
    if config_name not in found["configs"] or (
            traffic_name not in found["traffic"]):
        print(f"limo_bench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = 1
    bench_path = ROOT / "BENCHMARK.json"
    if bench_path.exists():
        for w in load_json(bench_path)["workloads"]:
            if w["name"] == args.workload:
                chips = w["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"limo_bench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"limo_bench: loaded {bad}: the run path may not import JAX "
              f"or the JAX package", file=sys.stderr)
        return 4
    checks = res.pop("checks")
    print("limo_bench: set-up " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["setup_parts"].items()),
        file=sys.stderr)
    print(f"limo_bench: {res['attempted']} frames, window "
          f"{res['window_s']:.3f} s, check {res['check_s']:.3f} s, "
          f"median frame {res.get('frame_ms_median', float('nan')):.3f} ms",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result = {k: res[k] for k in ("correct", "attempted", "failed",
                                  "metrics", "device")}
    if "breakdown" in res:
        result["breakdown"] = res["breakdown"]
    result["checks"] = checks
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
