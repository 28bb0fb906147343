"""The odometry cell's harness on the CPU at a small size: its reference
stands apart from the port, discovery finds its files, the tracker
kernels' work counts, its metrics read nothing against a port without
the spans, and its check passes a sound run and fails three planted
faults."""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from limo_bench import roofline, run
from limo_bench.roofline_tracker import lk_track_work, zncc_gate_work
from limo_bench.tests.tiny import tiny_traffic
from limo_bench.tests.tiny_odometry import CELL, NAME, tiny_config
from mono_lidar_depth_tpu_torch.obs import timing

ROOT = Path(__file__).resolve().parents[2]
METRICS = ["odo.step.host_ms", "tracker.frame.host_ms", "vo.pose_gn.host_ms",
           "vo.ba.host_ms", "vo.branch_sync.host_ms", "vo.retry_pct",
           "tracker.device_ms", "vo.pose_gn.device_ms", "vo.ba.device_ms",
           "lk_track_roofline", "zncc_gate_roofline"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads, as a run takes (`run.py`), so that the tiny runs
    leave the other test workers their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run_tiny(program=None, seconds=6.0, seed=2 ** 31 + 77):
    import mono_lidar_depth_tpu_torch as T

    return run.run_cell(CELL, seed, seconds, False, device="cpu",
                        program=program or T, cfg=tiny_config(),
                        traffic=tiny_traffic(), t_start=time.perf_counter())


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import limo_bench.oracle_odometry, limo_bench.oracle, "
            "limo_bench.scene; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {*run.FORBIDDEN, run.PORT}, tops


def test_discovery_lists_the_new_files():
    out = subprocess.run([sys.executable, str(ROOT / "limo_bench/run.py"),
                          "--list"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert NAME in found["configs"]
    assert "limo_odometry" in found["pipelines"]
    assert {m.replace(".", "_") for m in METRICS} <= set(found["metrics"])
    e2e, per_layer = run.cell_metrics(CELL)
    assert e2e == ["frames_per_s", "setup_s"]
    assert per_layer == METRICS
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell == [{"name": CELL, "config": NAME, "traffic": "online",
                     "chips": 1, "why": cell[0]["why"]}]
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "frames_per_s"
    cfg = json.loads((ROOT / f"limo_bench/configs/{NAME}.json").read_text())
    assert cfg["reduced"] == [] and cfg["architecture"] is None
    assert set(cfg["limits"]) == set(
        run.importlib.import_module(
            "limo_bench.pipelines.limo_odometry").NUMBERS)


def test_tracker_work_counts_are_perf_mds():
    """At 2,048 lanes, 4 levels of a 1226x370 pyramid and patch 9:
    `lk_track` 179.7 MFLOP and 4.89 MB (bound by its operations,
    0.00268 ms), `zncc_gate` 3.63 MB of images, 27 B per lane in, 5 B
    out, 6.6 MFLOP (bound by its bytes, 0.00110 ms)."""
    shapes = [(370, 1226), (185, 613), (92, 306), (46, 153)]
    pyr = [torch.empty(s) for s in shapes]
    uv = torch.empty((2048, 2))
    lk = lk_track_work(pyr, pyr, uv, uv, 9, 8, 1e-4)
    assert lk.flops == pytest.approx(179.7e6, rel=1e-3)
    assert lk.nbytes == pytest.approx(4.89e6, rel=2e-3)
    assert lk.least_s() * 1e3 == pytest.approx(0.00268, rel=2e-3)
    gate = zncc_gate_work(pyr[0], pyr[0], uv, uv, uv, None, None, None, 9,
                          0.6, 1.0)
    images = 2 * 370 * 1226 * 4
    assert images == pytest.approx(3.63e6, rel=1e-3)
    assert gate.nbytes == images + 2048 * (27 + 5)
    assert gate.flops == pytest.approx(6.6e6, rel=1e-2)
    assert gate.least_s() * 1e3 == pytest.approx(0.00110, rel=1e-2)
    assert gate.flops / roofline.PEAK_FP32_S < gate.nbytes / \
        roofline.PEAK_BYTES_S


@pytest.fixture
def ring():
    timing._frames.clear()
    yield timing._frames.ring
    timing._frames.clear()


def read(name):
    return run.metric_modules([name])[name].read(None)


def test_host_metrics_read_the_ports_record(ring):
    for _ in range(3):
        ring.append({"tracker.frame": 2e-3, "tracker.klt": 1e-3})
        ring.append({"odo.step": 60e-3, "assoc.frame": 1e-3,
                     "vo.pose_gn": 30e-3, "vo.branch_sync": 0.1e-3,
                     "vo.ba": 20e-3})
    assert read("odo.step.host_ms") == pytest.approx(60.0)
    assert read("tracker.frame.host_ms") == pytest.approx(2.0)
    assert read("vo.pose_gn.host_ms") == pytest.approx(30.0)
    assert read("vo.ba.host_ms") == pytest.approx(20.0)
    assert read("vo.branch_sync.host_ms") == pytest.approx(0.1)
    assert read("vo.retry_pct") == 0.0
    ring.append({"odo.step": 90e-3, "vo.pose_retry": 30e-3})
    assert read("vo.retry_pct") == pytest.approx(25.0)


def test_a_port_without_the_spans_reads_nothing(ring):
    """The parent's port: `assoc.frame` is the root, nothing else."""
    for _ in range(3):
        ring.append({"assoc.frame": 1e-3, "assoc.replay": 1e-3})
    for name in METRICS[:6]:
        assert read(name) is None, name


# The faults a run can have, planted in the program under the check.
def _shifted(T, monkeypatch):
    """Tracked positions 0.5 px to the right."""
    def track_frame(state, img, **kw):
        s, out = T.track_frame(state, img, **kw)
        return s, out._replace(uv_new=out.uv_new + torch.tensor([0.5, 0.0]))
    return {"track_frame": track_frame}


def _ba_skipped(T, monkeypatch):
    """The window BA returns its problem unchanged."""
    from mono_lidar_depth_tpu_torch.vo import ba

    def run_ba(camera, problem, **kw):
        zero = torch.zeros((), device=problem.R.device)
        return ba.BAResult(problem, zero, zero)
    monkeypatch.setattr(T.vo.pipeline, "run_ba", run_ba)
    return {}


def _state_unchanged(T, monkeypatch):
    """The step returns the state it was given."""
    def odometry_step(cfg, ocfg, cam, l2c, state, frame):
        _, R_cw, t_cw, diag = T.odometry_step(cfg, ocfg, cam, l2c, state,
                                              frame)
        return state, R_cw, t_cw, diag
    return {"odometry_step": odometry_step}


def test_a_sound_run_is_correct():
    res = run_tiny()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


@pytest.mark.parametrize("fault", [_shifted, _ba_skipped, _state_unchanged])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    import mono_lidar_depth_tpu_torch as T

    broken = types.SimpleNamespace(**{k: getattr(T, k) for k in dir(T)
                                      if not k.startswith("__")})
    for name, fn in fault(T, monkeypatch).items():
        setattr(broken, name, fn)
    res = run_tiny(program=broken)
    # not correct by the check, not for want of a frame to check
    assert res["checks"]["frames_checked"]["value"] >= 1
    assert not res["correct"], res["checks"]
