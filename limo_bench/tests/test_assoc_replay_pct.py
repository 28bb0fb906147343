"""The reader of the port's engagement of its CUDA graphs
(`metrics/assoc_replay_pct.py`) on hand-made frame records: the share of
the ring's frames that entered `assoc.replay`; nothing against a port
without the span or without `frame_spans`."""

import pytest

from limo_bench import program_spans, run
from mono_lidar_depth_tpu_torch.obs import timing

NAME = "assoc.replay_pct"
CELL = "kitti_hdl64_tracklet_depth.online"


@pytest.fixture
def ring():
    timing._frames.clear()
    yield timing._frames.ring
    timing._frames.clear()


def read():
    return run.metric_modules([NAME])[NAME].read(None)


def test_the_entry_and_the_file():
    mod = run.metric_modules([NAME])[NAME]
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE, mod.SPANS) == (
        "%", "association", "frames_per_s", "program_span", [])
    _, per_layer = run.cell_metrics(CELL)
    assert NAME in per_layer


@pytest.mark.parametrize("replayed,frames,want", [
    (4, 4, 100.0), (3, 4, 75.0), (1, 1024, 100.0 / 1024)])
def test_share_of_the_frames_that_replayed(ring, replayed, frames, want):
    for k in range(frames):
        record = {"assoc.frame": 1e-3}
        if k >= frames - replayed:
            record["assoc.replay"] = 0.9e-3
        else:  # an eager frame enters the stages
            record.update({"assoc.ground_plane": 0.2e-3,
                           "assoc.depth_pair": 0.5e-3})
        ring.append(record)
    assert read() == pytest.approx(want)


def test_no_span_reads_nothing(ring):
    """The parent's port: eager frames only, no `assoc.replay`."""
    for _ in range(3):
        ring.append({"assoc.frame": 2e-3, "assoc.depth_pair": 1e-3})
    assert read() is None
    ring.clear()
    assert read() is None


def test_a_port_without_frame_spans_reads_nothing(ring, monkeypatch):
    ring.append({"assoc.frame": 1e-3, "assoc.replay": 1e-3})
    monkeypatch.setattr(program_spans, "PORT_TIMING", "limo_bench.spans")
    assert read() is None
