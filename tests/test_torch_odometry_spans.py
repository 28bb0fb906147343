"""The program's own spans in the tracker and the odometry step
(`obs/timing.span`) on the CPU: `track_frame` (root `tracker.frame`, with
`tracker.pyramid`, `tracker.klt`, `tracker.detect`) and `odometry_step`
(root `odo.step`, with `process_frame`'s `assoc.frame` nested in it, then
`vo.pose_gn`, `vo.branch_sync`, `vo.pose_retry` on a retry only, and
`vo.ba`).

Bars: each span is entered once per frame and recorded in its frame's
record, the stages no longer than their root; `assoc.frame` nests under
`odo.step` on the host clock and under the profiler; `vo.pose_retry`
appears in the frames that retried and in no other; the tracker's and
the step's outputs equal, to the bit, a run with every span a null
context.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch.core import depth_estimator
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as tsyn
from mono_lidar_depth_tpu_torch.io.kitti import pad_cloud
from mono_lidar_depth_tpu_torch.obs import timing
from mono_lidar_depth_tpu_torch.tracker import frontend
from mono_lidar_depth_tpu_torch.tracks import pipeline
from mono_lidar_depth_tpu_torch.vo import pipeline as vp

SPEC = dict(frames=5, image_width=384, image_height=128, focal=240.0,
            lidar_rows=20, lidar_cols=500, step=0.7)
SMALL = dict(max_points=16384, max_features=128, image_width=384,
             image_height=128, ransac_num_hypotheses=128,
             ransac_subsample_points=1024, radiusSearch_count_min=1)
TRACKER = ("tracker.frame", "tracker.pyramid", "tracker.klt",
           "tracker.detect")
STEP = ("odo.step", "vo.pose_gn", "vo.branch_sync", "vo.ba")
RETRY = "vo.pose_retry"
FRAMES = SPEC["frames"] - 1


@pytest.fixture(scope="module")
def scene():
    """Config, camera, transform, grey images, clouds and labels."""
    seq = tsyn.render_sequence(tsyn.SyntheticSpec(**SPEC), seed=4)
    cfg = T.DepthEstimatorConfig(**SMALL)
    data = []
    for k, (xyzi, count) in enumerate(seq.scans(cfg.max_points)):
        cloud, valid = pad_cloud(xyzi, count, cfg.max_points)
        data.append((torch.from_numpy(seq.image(k)).to(torch.float32) / 255,
                     torch.from_numpy(cloud), torch.from_numpy(valid),
                     torch.from_numpy(seq.semantic(k).astype(np.int32)),
                     torch.tensor(seq.times[k], dtype=torch.float32)))
    return cfg, seq.camera, seq.lidar_to_cam("cpu"), data


@pytest.fixture(autouse=True)
def empty_ring():
    timing._frames.clear()
    yield
    timing._frames.clear()


def run_stream(scene, retry_at=()):
    """Tracker and odometry step over the frames; at the frames in
    `retry_at` the last motion is put 600 m behind, so that every landmark
    is behind the warm start and the step retries from identity.
    Returns every output."""
    cfg, cam, l2c, data = scene
    ocfg = T.OdometryConfig()
    draws = (torch.zeros(1024, dtype=torch.int64),
             torch.zeros((128, 3), dtype=torch.int64))
    img0, cloud0, valid0, sem0, _ = data[0]
    ts = T.init_tracker(img0, cfg.max_features, levels=3)
    state = T.OdometryState.create(cfg, ocfg, 2 * cfg.max_features, 8,
                                   "cpu")
    state = state._replace(tracklets=T.prime_state(
        cfg, cam, l2c, state.tracklets, cloud0, valid0, draws,
        semantic=sem0))
    outs = []
    for k, (img, cloud, valid, sem, stamp) in enumerate(data[1:], 1):
        ts, out = T.track_frame(ts, img)
        if k in retry_at:
            state = state._replace(rel_t=state.rel_t + torch.tensor(
                [0.0, 0.0, -600.0]))
        frame = T.FrameInput(cloud=cloud, cloud_valid=valid, ids=out.ids,
                             ids_valid=out.valid, uv_new=out.uv_new,
                             uv_prev=out.uv_prev, stamp=stamp, rng=draws,
                             semantic=sem)
        state, R_cw, t_cw, diag = T.odometry_step(cfg, ocfg, cam, l2c, state,
                                                  frame)
        outs.append((ts, out, state, R_cw, t_cw, diag))
    return outs


def leaves(tree):
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

    monkeypatch.setattr(vp, "span", counted)
    monkeypatch.setattr(frontend, "span", counted)
    outs = run_stream(scene)
    assert all(int(diag[0]) >= 12 for *_, diag in outs)  # motion tracks
    assert RETRY not in entered
    assert sorted(entered) == sorted((TRACKER + STEP) * FRAMES)
    ring = list(timing._frames.ring)
    # two roots a frame: the tracker's record, then the step's
    assert len(ring) == 2 * FRAMES and timing._frames.open is None
    for tracker, step in zip(ring[0::2], ring[1::2]):
        assert set(tracker) == set(TRACKER)
        assert set(step) >= set(STEP) | {"assoc.frame"}
        assert sum(tracker[s] for s in TRACKER[1:]) <= tracker[TRACKER[0]]
        assert (sum(step[s] for s in STEP[1:]) + step["assoc.frame"]
                <= step["odo.step"])
    read = timing.frame_spans()
    for name in TRACKER + STEP + ("assoc.frame",):
        assert read[name]["frames"] == FRAMES


def test_assoc_frame_nests_under_the_step(scene):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_stream(scene)
    assert len(timing._frames.ring) == 0
    ranges = {}
    for e in prof.events():
        if e.name in TRACKER + STEP + ("assoc.frame",):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
            assert not e.is_user_annotation, e.name
    assert all(len(ranges[n]) == FRAMES for n in ranges)
    assert len(ranges) == len(TRACKER + STEP) + 1

    def inside(child, parents):
        return any(a <= child[0] and child[1] <= b for a, b in parents)

    for name in STEP[1:] + ("assoc.frame",):
        assert all(inside(r, ranges["odo.step"]) for r in ranges[name])
    for name in TRACKER[1:]:
        assert all(inside(r, ranges["tracker.frame"]) for r in ranges[name])


def test_retry_span_only_on_a_retry(scene, monkeypatch):
    """The frames whose record holds `vo.pose_retry` are those in which
    the step called `estimate_pose_gn` twice."""
    calls = []
    gn = vp.estimate_pose_gn
    monkeypatch.setattr(vp, "estimate_pose_gn",
                        lambda *a, **k: calls.append(len(timing._frames.ring))
                        or gn(*a, **k))
    run_stream(scene, retry_at=(3,))
    ring = list(timing._frames.ring)
    retried = [calls.count(i) == 2 for i in range(1, len(ring), 2)]
    assert retried[:3] == [False, False, True]
    assert [RETRY in record for record in ring[1::2]] == retried
    assert timing.frame_spans()[RETRY]["frames"] == sum(retried)
    assert ring[5][RETRY] <= ring[5]["odo.step"]


@pytest.mark.parametrize("retry_at", [(), (3,)], ids=["plain", "retry"])
def test_spans_change_no_output(scene, monkeypatch, retry_at):
    got = leaves(run_stream(scene, retry_at))
    for module in (vp, frontend, pipeline, depth_estimator):
        monkeypatch.setattr(
            module, "span",
            lambda name, frame=False: contextlib.nullcontext())
    timing._frames.clear()
    want = leaves(run_stream(scene, retry_at))
    assert len(timing._frames.ring) == 0
    assert len(got) == len(want) > 50
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
