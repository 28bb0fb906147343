"""The odometry solvers' graphed path (`graphs.Graphed`) on the CPU.

A plain callable stands in for the CUDA graph
(`test_torch_graphs.capture_plain`), which drives everything but the
card's graph API: the warm-up, the copies in, the clones out, the cache.

Bars: the pose GN from a warm start, from identity, from no initial pose
and with fewer than 6 stage-2 inliers, and `run_ba` with and without its
costs, equal the eager bodies to the bit over calls that replay; the GN's
signature changes with a Huber width, and the BA's with a Huber width
and `compute_cost`; CPU tensors, and tensors on two devices, run the
eager body; an `odometry_step` stream with a forced retry equals the
eager stream to the bit, its retry replaying the first GN's graph and
still a second call of `vo.pipeline.estimate_pose_gn`.  The mechanism's
own bars, over all its users, are in `test_torch_graphs.py`.
"""

import pytest
import torch

import test_torch_odometry_spans as odo
from mono_lidar_depth_tpu_torch.obs import timing
from mono_lidar_depth_tpu_torch.vo import ba, pose
from mono_lidar_depth_tpu_torch.vo import pipeline as vp
from test_torch_graphs import (BA_KW, CAM, GN_KW, assert_bits_equal,
                               ba_problem, gn_problem, plain)
from test_torch_odometry_spans import scene  # noqa: F401  (fixture)

def gn_graphs():
    return plain(pose._estimate_pose_gn_eager, "vo.pose_gn.replay")


def ba_graphs():
    return plain(ba._run_ba_eager, "vo.ba.replay")


@pytest.fixture(autouse=True)
def empty_ring():
    timing._frames.clear()
    yield
    timing._frames.clear()


@pytest.mark.parametrize("start", ["warm", "identity", "none", "few"])
def test_gn_equals_eager_to_the_bit(start):
    g = gn_graphs()
    for seed in range(4):
        args = (CAM, *gn_problem(seed, start=start), *GN_KW)
        got = g(*args)
        assert_bits_equal(got, pose._estimate_pose_gn_eager(*args), 6)
        if start == "few":  # the stage-2 refit is skipped
            assert int(got.num_inliers) <= 5
        else:
            assert int(got.num_inliers) > 200
    assert len(g.graphs) == 1
    assert timing.frame_spans() == {}  # no frame record open: none kept


@pytest.mark.parametrize("compute_cost", [True, False])
def test_ba_equals_eager_to_the_bit(compute_cost):
    g = ba_graphs()
    for seed in range(3):
        args = (CAM, ba_problem(seed), *BA_KW, compute_cost)
        got = g(*args)
        assert_bits_equal(got, ba._run_ba_eager(*args), 6)
        if compute_cost:
            assert float(got.final_cost) < 0.5 * float(got.initial_cost)
    assert len(g.graphs) == 1


def test_signature_holds_the_solvers_values():
    """A Huber width of either solver, and the BA's `compute_cost`, each
    key a graph of their own."""
    X, uv, valid, R0, t0 = gn_problem(0)
    gn, bag = gn_graphs(), ba_graphs()
    pb = ba_problem(0)
    keys = [gn.signature((CAM, X, uv, valid, R0, t0, *GN_KW)),
            gn.signature((CAM, X, uv, valid, R0, t0, GN_KW[0], 2.5,
                          *GN_KW[2:])),
            bag.signature((CAM, pb, *BA_KW, False)),
            bag.signature((CAM, pb, *BA_KW, True)),
            bag.signature((CAM, pb, BA_KW[0], 2.5, *BA_KW[2:], False))]
    assert None not in keys and len(set(keys)) == len(keys)


def test_eager_where_no_graph_applies():
    X, uv, valid, R0, t0 = gn_problem(0)
    args = (CAM, X, uv, valid, R0, t0, *GN_KW)
    # CPU tensors: the process's own caches are for CUDA tensors
    assert pose._GRAPHS.signature(args) is None
    assert ba._GRAPHS.signature((CAM, ba_problem(0), *BA_KW, True)) is None
    before = (len(pose._GRAPHS.graphs), len(ba._GRAPHS.graphs))
    with timing.span("odo.step", frame=True):
        got = pose.estimate_pose_gn(*args)
        res = ba.run_ba(CAM, ba_problem(0), *BA_KW, True)
    assert (len(pose._GRAPHS.graphs), len(ba._GRAPHS.graphs)) == before
    assert set(timing._frames.ring[-1]) == {"odo.step"}
    assert_bits_equal(got, pose._estimate_pose_gn_eager(*args), 6)
    assert_bits_equal(res, ba._run_ba_eager(CAM, ba_problem(0), *BA_KW,
                                            True), 6)
    # tensors on two devices
    g = gn_graphs()
    assert g.signature((CAM, X.to("meta"), uv, valid, R0, t0,
                        *GN_KW)) is None


def test_odometry_stream_equals_eager_to_the_bit(scene, monkeypatch):  # noqa: F811
    """Tracker and step over the scene's frames with a retry forced at
    the third, graphed and eager: every output equal to the bit.  The
    first step captures the GN (no BA runs at the first frame), the
    second the BA; the retry replays the first GN's graph, and is still
    a second call of the pipeline's `estimate_pose_gn`."""
    want = odo.leaves(odo.run_stream(scene, retry_at=(3,)))
    timing._frames.clear()
    gn, bag = gn_graphs(), ba_graphs()
    monkeypatch.setattr(pose, "_GRAPHS", gn)
    monkeypatch.setattr(ba, "_GRAPHS", bag)
    calls = []
    seen = vp.estimate_pose_gn
    monkeypatch.setattr(vp, "estimate_pose_gn",
                        lambda *a, **k: calls.append(len(timing._frames.ring))
                        or seen(*a, **k))
    got = odo.leaves(odo.run_stream(scene, retry_at=(3,)))
    assert len(got) == len(want) > 50
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(gn.graphs) == len(bag.graphs) == 1
    steps = list(timing._frames.ring)[1::2]
    retried = ["vo.pose_retry" in r for r in steps]
    assert retried[:3] == [False, False, True]
    assert [calls.count(i) for i in range(1, 2 * len(steps), 2)] == [
        1 + r for r in retried]
    assert ["vo.pose_gn.replay" in r for r in steps] == [False, True, True,
                                                         True]
    assert ["vo.ba.replay" in r for r in steps] == [False, False, True,
                                                    True]
    assert all(r["vo.pose_gn.replay"] <= r["vo.pose_gn"] + r.get(
        "vo.pose_retry", 0.0) for r in steps[1:])
