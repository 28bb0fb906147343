"""The odometry solvers' CUDA graphs (vo/graphed.py) against their eager
bodies on a card, at the benchmark cell's size
(`limo_bench/configs/kitti_hdl64_limo.json`: KITTI's HDL-64 scans, road
labels, a 1226x370 image, 2,048 tracker lanes, 4,096 track slots, a
5-frame window).  Skipped where there is no CUDA device.  Run on the
chip, from the repo root, with

    python3 -m pytest -q -s -p no:cacheprovider -o addopts= --noconftest \
        tests/test_torch_vo_graphed_card.py

(this file imports no JAX; `-s` shows the readings each test prints).

Bars: over one 220-frame lap of the cell's stream from the primed state,
the tracker run once and its frames stepped twice, the step with the
graphed solvers equals the step with the eager bodies to the bit in the
pose, the diagnostics and every state tensor (the window among them), and
retries on the same frames, the retry replaying the first GN's graph; a
call under an outer stream capture runs the eager body into that graph;
TF32 switched on captures anew, equal to the eager bodies under it; under
the profiler, with the harness's markers around the calls
(`limo_bench/spans.Tracer`), a replayed GN's and BA's kernels all fall
between their markers; a replayed call holds the host under 2 ms while
the card works ahead of it, as in the step.
"""

import statistics
import time
import types

import pytest
import torch

CONFIG = "kitti_hdl64_limo"
SEED = 2 ** 31 + 2020
BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def apart(got, want):
    """Indices of the tensor leaves that differ in a bit."""
    from mono_lidar_depth_tpu_torch.tracks.frame_graph import leaves

    a, b = leaves(got), leaves(want)
    assert len(a) == len(b) >= 6
    out = []
    for k, (x, y) in enumerate(zip(a, b)):
        bits = BITS[x.element_size()]
        if (x.dtype, x.shape) != (y.dtype, y.shape) or not torch.equal(
                x.view(bits), y.view(bits)):
            out.append(k)
    return out


def solvers(eager: bool):
    """(estimate_pose_gn, run_ba): the public, graphed functions or their
    eager bodies."""
    from mono_lidar_depth_tpu_torch.vo import ba, pose

    if eager:
        return pose._estimate_pose_gn_eager, ba._run_ba_eager
    return pose.estimate_pose_gn, ba.run_ba


class Stream:
    """The cell's lap, images and primed odometry state (`limo_bench`'s
    own set-up), and its frames as the benchmark hands them over."""

    def __init__(self, device):
        import mono_lidar_depth_tpu_torch as T
        from limo_bench import run
        from limo_bench.pipelines import limo_odometry

        cfg = run.load_json(run.BENCH / "configs" / f"{CONFIG}.json")
        traffic = dict(run.load_json(run.BENCH / "traffic" / "online.json"),
                       warmup_frames=0)
        self.T = T
        self.cell = limo_odometry.Cell(T, cfg, traffic, SEED, device, 1.0)
        self.lap = self.cell.images.shape[0]
        self.calls = {}  # the last arguments each solver was called with

    def frames(self, frames):
        """(f, FrameInput) along `frames`, the tracker run once."""
        c, T, tr = self.cell, self.T, self.cell.tr
        ts = c.ts
        for f in frames:
            cloud, valid, sem = c._upload_scan(f)
            ts, out = T.track_frame(ts, c._upload_image(f),
                                    cell_size=tr["cell_size"],
                                    patch=tr["patch"], iters=tr["iters"])
            yield f, T.FrameInput(
                cloud=cloud, cloud_valid=valid, ids=out.ids,
                ids_valid=out.valid, uv_new=out.uv_new, uv_prev=out.uv_prev,
                stamp=c.stamps[f], rng=c._draws(f), semantic=sem)

    def step(self, state, inp, eager: bool):
        """`odometry_step` with the pipeline's solvers graphed or eager:
        (its outputs, its calls of `estimate_pose_gn`)."""
        from mono_lidar_depth_tpu_torch.vo import pipeline as vp

        gn, ba_fn = solvers(eager)
        calls = []

        def seen_gn(*a, **k):
            calls.append(1)
            self.calls["gn"] = (a, k)
            return gn(*a, **k)

        def seen_ba(*a, **k):
            self.calls["ba"] = (a, k)
            return ba_fn(*a, **k)

        saved = vp.estimate_pose_gn, vp.run_ba
        vp.estimate_pose_gn, vp.run_ba = seen_gn, seen_ba
        try:
            c = self.cell
            out = self.T.odometry_step(c.dcfg, c.ocfg, c.cam, c.l2c, state,
                                       inp)
        finally:
            vp.estimate_pose_gn, vp.run_ba = saved
        return out, len(calls)


@pytest.fixture(scope="module")
def stream():
    _need_card()
    s = Stream(torch.device("cuda"))
    state = s.cell.os
    for _, inp in s.frames(range(1, 4)):  # both solvers called
        state = s.step(state, inp, eager=False)[0][0]
    return s


@pytest.mark.card
def test_lap_graphed_equals_eager(stream):
    from mono_lidar_depth_tpu_torch.obs import timing
    from mono_lidar_depth_tpu_torch.vo import ba, pose

    timing._frames.clear()
    graphs = (len(pose._GRAPHS.graphs), len(ba._GRAPHS.graphs))
    sg = se = stream.cell.os
    parted, retries = [], 0
    for f, inp in stream.frames(range(1, stream.lap + 1)):
        got, n_got = stream.step(sg, inp, eager=False)
        want, n_want = stream.step(se, inp, eager=True)
        diff = apart(got, want)
        if diff or n_got != n_want:
            parted.append((f, diff, n_got, n_want))
        retries += n_got == 2
        sg, se = got[0], want[0]
    spans = timing.frame_spans()
    print(f"\nlap: {stream.lap} frames, {retries} with a retry; graphed "
          f"apart from eager at {parted} (frame, leaves apart, GN calls "
          f"graphed, eager); replayed frames: GN "
          f"{spans['vo.pose_gn.replay']['frames']}, BA "
          f"{spans['vo.ba.replay']['frames']}")
    assert not parted
    assert retries > 0
    # the fixture's frames captured both: the lap replays every solve
    # (the BA runs from the lap's second frame on, as from a primed state)
    assert (len(pose._GRAPHS.graphs), len(ba._GRAPHS.graphs)) == graphs
    assert spans["vo.pose_gn.replay"]["frames"] == stream.lap
    assert spans["vo.ba.replay"]["frames"] == stream.lap - 1


@pytest.mark.card
def test_eager_under_an_outer_capture(stream):
    from mono_lidar_depth_tpu_torch.vo import ba, pose

    for name, graphed, eager, cache in (
            ("gn", pose.estimate_pose_gn, pose._estimate_pose_gn_eager,
             pose._GRAPHS.graphs),
            ("ba", ba.run_ba, ba._run_ba_eager, ba._GRAPHS.graphs)):
        a, k = stream.calls[name]
        want = eager(*a, **k)
        before = len(cache)
        outer = torch.cuda.CUDAGraph()
        with torch.cuda.graph(outer):
            got = graphed(*a, **k)
        assert len(cache) == before
        outer.replay()
        torch.cuda.synchronize()
        assert apart(got, want) == [], name


@pytest.mark.card
def test_tf32_switched_on_captures_anew(stream):
    """A caller that switches TF32 on (the benchmark's control does) gets
    graphs captured under it, equal to the eager bodies under it."""
    from mono_lidar_depth_tpu_torch import precision
    from mono_lidar_depth_tpu_torch.vo import ba, pose

    caches = (pose._GRAPHS.graphs, ba._GRAPHS.graphs)
    before = [len(c) for c in caches]
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        for _ in range(3):  # the warm-up and capture, then two replays
            for name, graphed, eager in zip(("gn", "ba"), solvers(False),
                                            solvers(True)):
                a, k = stream.calls[name]
                assert apart(graphed(*a, **k), eager(*a, **k)) == [], name
    finally:
        precision.enforce_fp32()
    assert [len(c) for c in caches] == [n + 1 for n in before]


@pytest.mark.card
def test_replayed_kernels_fall_between_the_markers(stream):
    """The harness's wrappers (`Tracer.patch`) around a GN and a BA call,
    eager and replayed: the device activities between each pair of
    markers, their device ms, and the activities outside every pair."""
    from torch.profiler import ProfilerActivity, profile

    from limo_bench import spans

    marker = spans.marker_name()
    seen = {}
    for side in ("eager", "replay"):
        holder = types.SimpleNamespace(
            **dict(zip(("gn", "ba"), solvers(side == "eager"))))
        tracer = spans.Tracer()
        tracer.patch(holder, "gn", "pose_gn")
        tracer.patch(holder, "ba", "ba")
        tracer.profiling = True
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(spans.GUARDS):
                spans.marker()
            torch.cuda.synchronize()
            for name in ("gn", "ba"):
                a, k = stream.calls[name]
                getattr(holder, name)(*a, **k)
            torch.cuda.synchronize()
        dt = spans.DeviceTrace(prof, marker, 1.0, 1, len(tracer.marks))
        assert dt.aligned
        # marks: GN begin, GN end, BA begin, BA end (start, end, name)
        pairs = {"gn": (dt.marks[0][1], dt.marks[1][0]),
                 "ba": (dt.marks[2][1], dt.marks[3][0])}
        starts = [s for s, _, _ in dt.ops]
        seen[side] = {
            name: (sum(lo <= s < hi for s in starts),
                   1e3 * dt.span_s(tracer.marks, label)[0])
            for (name, (lo, hi)), label in zip(pairs.items(),
                                               ("pose_gn", "ba"))}
        seen[side + "_outside"] = sum(
            not any(lo <= s < hi for lo, hi in pairs.values())
            for s in starts)
        seen[side + "_graph_launch"] = any(
            e.name == "cudaGraphLaunch" for e in prof.events())
    print(f"\nbetween the markers (activities, device ms): {seen}")
    assert seen["replay_graph_launch"]
    assert seen["replay_outside"] == 0
    for name in ("gn", "ba"):
        assert seen["replay"][name][0] >= seen["eager"][name][0] > 100
        assert seen["replay"][name][1] > 0


@pytest.mark.card
def test_host_ms_of_a_replay(stream):
    """Host ms of one replayed call against the eager body's, the device
    left to run (no synchronize inside the timed call): with the card
    busy for ~10 ms ahead of the call, as the association keeps it in the
    step, and with the queue empty.  The bar is on the first, the call as
    the step makes it."""
    readings = {}
    for name, graphed, eager in zip(("gn", "ba"), solvers(False),
                                    solvers(True)):
        a, k = stream.calls[name]
        for side, fn, n in (("replay", graphed, 30), ("eager", eager, 5)):
            for queue in ("busy", "empty"):
                host = []
                for _ in range(n):
                    torch.cuda.synchronize()
                    if queue == "busy":
                        torch.cuda._sleep(20_000_000)  # ~10 ms at ~2 GHz
                    t0 = time.perf_counter()
                    fn(*a, **k)
                    host.append(1e3 * (time.perf_counter() - t0))
                readings[(name, side, queue)] = (
                    statistics.median(host), min(host), max(host))
    print(f"\nhost ms (median, min, max): {readings}")
    for name in ("gn", "ba"):
        assert readings[(name, "replay", "busy")][0] < 2.0
        assert (readings[(name, "replay", "empty")][0]
                < 0.1 * readings[(name, "eager", "empty")][0])
