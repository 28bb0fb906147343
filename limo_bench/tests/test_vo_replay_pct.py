"""The readers of the odometry solvers' engagement of their CUDA graphs
(`metrics/vo_pose_gn_replay_pct.py`, `metrics/vo_ba_replay_pct.py`) on
hand-made frame records: the share of the ring's `odo.step` frames that
entered the solver's `.replay` span; nothing against a port without the
span or without `frame_spans`."""

import pytest

from limo_bench import program_spans, run
from mono_lidar_depth_tpu_torch.obs import timing

CELL = "kitti_hdl64_limo.online"
METRICS = {"vo.pose_gn.replay_pct": "vo.pose_gn.replay",
           "vo.ba.replay_pct": "vo.ba.replay"}


@pytest.fixture
def ring():
    timing._frames.clear()
    yield timing._frames.ring
    timing._frames.clear()


def read(name):
    return run.metric_modules([name])[name].read(None)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_the_entry_and_the_file(name):
    mod = run.metric_modules([name])[name]
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE, mod.SPANS) == (
        "%", "odometry", "frames_per_s", "program_span", [])
    _, per_layer = run.cell_metrics(CELL)
    assert name in per_layer
    _, node = run.cell_metrics("kitti_hdl64_tracklet_depth.online")
    assert name not in node


@pytest.mark.parametrize("name", sorted(METRICS))
@pytest.mark.parametrize("replayed,frames,want", [
    (4, 4, 100.0), (3, 4, 75.0), (509, 512, 100.0 * 509 / 512)])
def test_share_of_the_frames_that_replayed(ring, name, replayed, frames,
                                           want):
    for k in range(frames):
        # the tracker's record between the steps' records
        ring.append({"tracker.frame": 3e-3, "tracker.klt": 1e-3})
        record = {"odo.step": 20e-3, "assoc.frame": 1e-3,
                  "assoc.replay": 0.9e-3, "vo.pose_gn": 2e-3,
                  "vo.branch_sync": 5e-3, "vo.ba": 3e-3}
        if k >= frames - replayed:
            record[METRICS[name]] = 1e-3
        if k % 3 == 0:  # a retry replays again inside `vo.pose_retry`
            record["vo.pose_retry"] = 1.5e-3
        ring.append(record)
    assert read(name) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_no_span_reads_nothing(ring, name):
    """The parent's port: eager solves only, no `.replay` span."""
    for _ in range(3):
        ring.append({"odo.step": 90e-3, "vo.pose_gn": 40e-3,
                     "vo.ba": 30e-3})
    assert read(name) is None
    ring.clear()
    assert read(name) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_a_port_without_frame_spans_reads_nothing(ring, monkeypatch, name):
    ring.append({"odo.step": 1e-3, METRICS[name]: 1e-3})
    monkeypatch.setattr(program_spans, "PORT_TIMING", "limo_bench.spans")
    assert read(name) is None
