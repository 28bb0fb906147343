"""The readers of the port's own spans (`limo_bench/program_spans.py`) on
a hand-made device trace: per-span device ms from launch calls paired
with activities in stream order, the idle split, the syncs; nothing
where the pairing fails or the port has no spans."""

import types

import pytest
import torch

from limo_bench import program_spans, run, spans
from mono_lidar_depth_tpu_torch.obs import timing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MARKER = "sleep"
NEW = [f"{s}.{k}" for k in ("host_ms", "device_ms")
       for s in program_spans.SPANS] + [
    "assoc.frame.host_syncs", "assoc.frame.idle_ms", "drivers.idle_ms"]

# One profiled frame, in microseconds: host events (start, end, name) and
# the activity each launch call enqueues (None: none).
HOST = [
    (0, 0.5, "cudaLaunchKernel"), (1, 1.5, "cudaLaunchKernel"),
    (2, 2.5, "cudaLaunchKernel"),  # the harness's guard markers
    (3, 10, "cudaDeviceSynchronize"),
    (11, 11.5, "cudaMemcpyAsync"),  # upload
    (15, 15.5, "cudaLaunchKernel"),  # the harness's marker before the frame
    (18, 60, "assoc.frame"),
    (19, 25, "assoc.ground_plane"), (20, 20.5, "cudaLaunchKernel"),
    (26, 28, "assoc.match_tracks"), (27, 27.5, "cudaLaunchKernel"),
    (29, 33, "assoc.rasterize"), (30, 30.5, "cudaLaunchKernel"),
    (31, 31.5, "cudaMemsetAsync"),
    (34, 55, "assoc.depth_pair"),
    (35, 45, "depth.segment"), (36, 36.5, "cuLaunchKernel"),
    (41, 44, "cudaStreamSynchronize"),
    (46, 50, "depth.road"), (47, 47.5, "cudaLaunchKernel"),
    (56, 59, "assoc.update_tracks"), (57, 57.5, "cudaLaunchKernel"),
    (61, 61.5, "cudaLaunchKernel"),  # the harness's marker after it
    (64, 64.4, "cudaMemcpyAsync"), (64.5, 68, "cudaStreamSynchronize"),
    (70, 75, "cudaDeviceSynchronize"),
]
DEVICE = [
    (5, 6, MARKER), (7, 8, MARKER),  # two guards (the profiler lost one)
    (12, 14, "Memcpy HtoD (Pinned -> Device)"),
    (16, 17, MARKER),
    (21, 24, "ground_kernel"), (30, 31, "match_kernel"),
    (32, 36, "raster_kernel"), (37, 38, "Memset (Device)"),
    (40, 46, "segment_kernel"), (48, 52, "road_kernel"),
    (58, 59, "update_kernel"),
    (62, 63, MARKER),
    (65, 67, "Memcpy DtoH (Device -> Pinned)"),
]
WINDOW_US = 65.0  # from the first synchronize's end to the last one's


class Prof:
    def __init__(self, host, device):
        self.evs = [types.SimpleNamespace(
            name=n, device_type=d, time_range=types.SimpleNamespace(
                start=s, end=e))
            for evs, d in ((host, CPU), (device, CUDA)) for s, e, n in evs]

    def events(self):
        return self.evs


def readings(host=HOST, device=DEVICE):
    tracer = spans.Tracer()
    tracer.marks[:] = [("assoc", 0), ("assoc", 1)]
    trace = spans.DeviceTrace(Prof(host, device), MARKER, WINDOW_US * 1e-6,
                              1, len(tracer.marks))
    assert trace.aligned
    return run.Readings(tracer, trace)


def read_all(r):
    return {name: mod.read(r)
            for name, mod in run.metric_modules(NEW).items()}


def test_every_new_metric_has_its_entry():
    mods = run.metric_modules(NEW)
    _, listed = run.cell_metrics("kitti_hdl64_tracklet_depth.online")
    assert set(NEW) <= set(listed) and len(NEW) == 19
    for mod in mods.values():
        assert mod.SPANS == []


def test_device_ms_idle_split_and_syncs():
    r = readings()
    got = read_all(r)
    want_us = {"assoc.frame": 20, "assoc.ground_plane": 3,
               "assoc.match_tracks": 1, "assoc.rasterize": 5,
               "assoc.depth_pair": 10, "depth.segment": 6, "depth.road": 4,
               "assoc.update_tracks": 1}
    for name, us in want_us.items():
        assert got[f"{name}.device_ms"] == pytest.approx(us * 1e-3), name
    stages = ("assoc.ground_plane", "assoc.match_tracks", "assoc.rasterize",
              "assoc.depth_pair", "assoc.update_tracks")
    assert sum(got[f"{s}.device_ms"] for s in stages) == pytest.approx(
        got["assoc.frame.device_ms"])
    assert got["assoc.frame.host_syncs"] == 1  # the read-back's is outside
    assert got["assoc.frame.idle_ms"] == pytest.approx(22e-3)
    assert got["drivers.idle_ms"] == pytest.approx(19e-3)
    idle_ms = r.idle_pct() / 100 * r.trace.window_s * 1e3 / r.trace.frames
    assert got["assoc.frame.idle_ms"] + got["drivers.idle_ms"] == (
        pytest.approx(idle_ms))


def test_a_launch_without_its_activity_reads_nothing(capsys):
    device = [d for d in DEVICE if d[2] != "update_kernel"]
    got = read_all(readings(device=device))
    for name in NEW:
        if name.endswith(("device_ms", "idle_ms")):
            assert got[name] is None, name
    assert got["assoc.frame.host_syncs"] == 1
    err = capsys.readouterr().err
    assert "11 launch calls and 10 device activities" in err


def test_an_activity_of_another_kind_reads_nothing(capsys):
    """The fill's launch call paired with a kernel: a shift by one."""
    device = [(s, e, "fill_kernel" if n.startswith("Memset") else n)
              for s, e, n in DEVICE]
    got = read_all(readings(device=device))
    assert got["assoc.frame.device_ms"] is None
    assert got["assoc.frame.idle_ms"] is None
    assert "1 of 11 launch calls paired with an activity of another kind" in (
        capsys.readouterr().err)


def test_device_clock_behind_the_host_is_no_fault():
    """An activity stamped up to a few microseconds before its launch
    call (the device clock behind the host's) pairs all the same."""
    device = [(19.6, 24, n) if n == "ground_kernel" else (s, e, n)
              for s, e, n in DEVICE]
    got = read_all(readings(device=device))
    assert got["assoc.ground_plane.device_ms"] == pytest.approx(4.4e-3)
    assert got["assoc.frame.device_ms"] == pytest.approx(21.4e-3)


def test_a_port_without_spans_reads_nothing(monkeypatch, capsys):
    """The parent's port: no ranges in the trace, no `frame_spans`."""
    host = [h for h in HOST if h[2] not in program_spans.SPANS]
    monkeypatch.setattr(program_spans, "PORT_TIMING", "limo_bench.spans")
    got = read_all(readings(host=host))
    assert all(v is None for v in got.values()), got
    assert "no span of the program in the trace" in capsys.readouterr().err


def test_host_ms_reads_the_ports_ring():
    timing._frames.clear()
    try:
        for ms in (2.0, 3.0, 40.0):
            timing._frames.ring.append({"assoc.frame": ms / 1e3,
                                        "depth.road": ms / 4e3})
        got = read_all(readings())
        assert got["assoc.frame.host_ms"] == pytest.approx(3.0)
        assert got["depth.road.host_ms"] == pytest.approx(0.75)
        assert got["assoc.match_tracks.host_ms"] is None
    finally:
        timing._frames.clear()
