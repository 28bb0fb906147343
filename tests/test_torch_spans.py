"""The program's own spans (`obs/timing.span`, `frame_spans`) on
`process_frame` in semantic mode, on the CPU.

Bars: over 5 frames each of the eight spans is entered once per frame
and recorded in that frame's record; the stages and the depth cascade's
parts nest inside `assoc.frame` and sum to no more than their parent;
under a torch profiler nothing is recorded and each span is a host event
named after it, not a user annotation; a span with no root open records
nothing; the ring keeps the last `RING_FRAMES` frames; depths, codes and
state equal, to the bit, a run with every span a null context; the cost
script (`scripts/span_cost_torch.py`) runs its readings at a small size.
"""

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch.core import depth_estimator
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as tsyn
from mono_lidar_depth_tpu_torch.io.kitti import pad_cloud
from mono_lidar_depth_tpu_torch.obs import timing
from mono_lidar_depth_tpu_torch.tracks import pipeline

SPEC = dict(frames=6, image_width=384, image_height=128, focal=240.0,
            lidar_rows=20, lidar_cols=500, step=0.7)
SMALL = dict(max_points=16384, max_features=256, image_width=384,
             image_height=128, ransac_num_hypotheses=128,
             ransac_subsample_points=1024, radiusSearch_count_min=1)
STAGES = ("assoc.ground_plane", "assoc.match_tracks", "assoc.rasterize",
          "assoc.depth_pair", "assoc.update_tracks")
DEPTH = ("depth.segment", "depth.road")
SPANS = ("assoc.frame",) + STAGES + DEPTH
FRAMES = 5


@pytest.fixture(scope="module")
def scene():
    """Config, camera, transform, the primed state and 5 frames."""
    seq = tsyn.render_sequence(tsyn.SyntheticSpec(**SPEC), seed=4)
    cfg = T.DepthEstimatorConfig(**SMALL)
    rng = np.random.default_rng(9)
    M = cfg.max_features
    uv = np.clip(rng.uniform([4, 40], [380, 124], (M, 2))[None]
                 + np.cumsum(rng.normal(0, 1.0, (len(seq), M, 2)), 0),
                 [1, 1], [382, 126]).astype(np.float32)
    draws = RansacDraws(torch.zeros(1024, dtype=torch.int64),
                        torch.zeros((128, 3), dtype=torch.int64))
    frames = []
    for k, (xyzi, count) in enumerate(seq.scans(cfg.max_points)):
        cloud, valid = pad_cloud(xyzi, count, cfg.max_points)
        frames.append(T.FrameInput(
            cloud=torch.from_numpy(cloud), cloud_valid=torch.from_numpy(valid),
            ids=torch.arange(M, dtype=torch.int32),
            ids_valid=torch.from_numpy(rng.random(M) < 0.9),
            uv_new=torch.from_numpy(uv[k]),
            uv_prev=torch.from_numpy(uv[max(k - 1, 0)]),
            stamp=torch.tensor(seq.times[k], dtype=torch.float32),
            rng=draws,
            semantic=torch.from_numpy(seq.semantic(k).astype(np.int32))))
    cam, l2c = seq.camera, seq.lidar_to_cam("cpu")
    state = T.TrackletDepthState.create(cfg, M, 8, "cpu")
    state = T.prime_state(cfg, cam, l2c, state, frames[0].cloud,
                          frames[0].cloud_valid, draws,
                          semantic=frames[0].semantic)
    return cfg, cam, l2c, state, frames[1:1 + FRAMES]


@pytest.fixture(autouse=True)
def empty_ring():
    timing._frames.clear()
    yield
    timing._frames.clear()


def run_frames(scene):
    cfg, cam, l2c, state, frames = scene
    out = []
    for f in frames:
        state, depths, codes = T.process_frame(cfg, cam, l2c, state, f)
        out.append((depths, codes))
    return state, out


def leaves(tree):
    """The tensors of a nest of NamedTuples, tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves(item)]
    return []


def test_each_span_once_per_frame(scene, monkeypatch):
    entered = []

    class counted(timing.span):
        __slots__ = ()

        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(pipeline, "span", counted)
    monkeypatch.setattr(depth_estimator, "span", counted)
    run_frames(scene)
    assert sorted(entered) == sorted(SPANS * FRAMES)
    ring = list(timing._frames.ring)
    assert len(ring) == FRAMES and timing._frames.open is None
    for record in ring:
        assert set(record) == set(SPANS)
        assert all(v > 0 for v in record.values())
    read = timing.frame_spans()
    assert set(read) == set(SPANS)
    for name, r in read.items():
        assert r["frames"] == FRAMES
        ms = sorted(1e3 * rec[name] for rec in ring)
        assert r["median_ms"] == ms[FRAMES // 2]
        assert r["mean_ms"] == pytest.approx(sum(ms) / FRAMES)
        assert ms[-2] <= r["p95_ms"] <= ms[-1]


def test_spans_nest_inside_the_frame(scene):
    run_frames(scene)
    for record in timing._frames.ring:
        assert sum(record[s] for s in STAGES) <= record["assoc.frame"]
        assert sum(record[s] for s in DEPTH) <= record["assoc.depth_pair"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_frames(scene)
    ranges = {s: [] for s in SPANS}
    for e in prof.events():
        if e.name in ranges:
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    roots = ranges["assoc.frame"]

    def inside(child, parents):
        return any(a <= child[0] and child[1] <= b for a, b in parents)

    for s in STAGES:
        assert all(inside(r, roots) for r in ranges[s]), s
    for s in DEPTH:
        assert all(inside(r, ranges["assoc.depth_pair"]) for r in ranges[s])


def test_nothing_recorded_under_the_profiler(scene):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_frames(scene)
    assert len(timing._frames.ring) == 0 and timing._frames.open is None
    assert timing.frame_spans() == {}
    events = [e for e in prof.events() if e.name in SPANS]
    assert sorted(e.name for e in events) == sorted(SPANS * FRAMES)
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation, e.name


def test_no_root_no_record_and_the_ring_is_bounded():
    with timing.span("depth.segment"):
        with timing.span("depth.road"):
            pass
    assert timing._frames.open is None and len(timing._frames.ring) == 0
    for _ in range(timing.RING_FRAMES + 100):
        with timing.span("assoc.frame", frame=True):
            with timing.span("assoc.rasterize"):
                pass
    assert len(timing._frames.ring) == timing.RING_FRAMES == 1024
    read = timing.frame_spans()
    assert read["assoc.rasterize"]["frames"] == 1024
    # a nested root is a plain span of the frame that is open
    with timing.span("vo.frame", frame=True):
        with timing.span("assoc.frame", frame=True):
            pass
        assert timing._frames.open is not None
    assert set(timing._frames.ring[-1]) == {"vo.frame", "assoc.frame"}
    # a frame that raises is not kept
    with pytest.raises(ValueError):
        with timing.span("assoc.frame", frame=True):
            raise ValueError
    assert timing._frames.open is None
    assert set(timing._frames.ring[-1]) == {"vo.frame", "assoc.frame"}


def test_frame_spans_statistics():
    for ms in (1.0, 2.0, 3.0, 4.0, 10.0):
        timing._frames.ring.append({"a": ms / 1e3})
    timing._frames.ring.append({"b": 0.5e-3})
    read = timing.frame_spans()
    assert read["a"]["frames"] == 5 and read["b"]["frames"] == 1
    assert read["a"]["median_ms"] == pytest.approx(3.0)
    assert read["a"]["mean_ms"] == pytest.approx(4.0)
    assert read["a"]["p95_ms"] == pytest.approx(4.0 + 0.8 * 6.0)
    assert read["b"]["p95_ms"] == pytest.approx(0.5)


def test_spans_change_no_output(scene, monkeypatch):
    state, out = run_frames(scene)
    monkeypatch.setattr(pipeline, "span",
                        lambda name, frame=False: contextlib.nullcontext())
    monkeypatch.setattr(depth_estimator, "span",
                        lambda name, frame=False: contextlib.nullcontext())
    timing._frames.clear()
    null_state, null_out = run_frames(scene)
    assert len(timing._frames.ring) == 0
    got, want = leaves((state, out)), leaves((null_state, null_out))
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    codes = torch.stack([c for _, c in out])
    assert (codes == 1).sum() > 100  # the cascade found depths


def test_span_cost_script_on_the_cpu():
    """The cost script's three readings on the benchmark cell's pipeline
    at a small size: both sides run, the spans' side records its frames,
    and under the profiler only the spans' side holds their ranges."""
    from limo_bench.tests.tiny import tiny_config, tiny_traffic

    path = Path(__file__).resolve().parents[1] / "scripts/span_cost_torch.py"
    spec = importlib.util.spec_from_file_location("span_cost_torch", path)
    cost = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cost)
    out = cost.run("cpu", frames=3, cfg=tiny_config(
        "kitti_hdl64_tracklet_depth"), traffic=tiny_traffic(),
        profiled_frames=2, nest_frames=200)
    assert out["device"] == "cpu" and out["frames_each"] == 3
    assert out["ring_assoc_frame"]["frames"] == 3
    assert out["process_frame_null_ms"]["median"] > 0
    assert (out["frame_spans_ms"]["median"]
            >= out["process_frame_spans_ms"]["median"])
    assert set(out["frame_paired_diff_us"]) == {"mean", "stderr"}
    assert out["nest_us"]["spans"] > 0 and out["nest_us"]["null"] > 0
    for side, spans in (("spans", 8.0), ("null", 0.0)):
        assert len(out["profiled"][side]) == 2
        for stretch in out["profiled"][side]:
            assert stretch["span_ranges_per_frame"] == spans
            assert stretch["user_annotations"] == 0
