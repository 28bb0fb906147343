"""The harness on the CPU at a small size: what the run path imports, how
new cells and metrics are found, the roofline counts, and the check
failing on a broken timed path."""

import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from limo_bench import roofline, run
from limo_bench.tests.tiny import tiny_config, tiny_traffic

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["kitti_hdl64_tracklet_depth.online"]


def run_tiny(workload, program=None, seconds=1.5, seed=2 ** 31 + 77):
    import mono_lidar_depth_tpu_torch as T

    return run.run_cell(workload, seed, seconds, False, device="cpu",
                        program=program or T,
                        cfg=tiny_config(workload.split(".")[0]),
                        traffic=tiny_traffic(), t_start=time.perf_counter())


RUN_PATH = """
import sys, time, json
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from limo_bench import run
from limo_bench.tests.tiny import tiny_config, tiny_traffic
for w in {cells!r}:
    res = run.run_cell(w, 5, 0.5, False, device="cpu",
                       cfg=tiny_config(w.split(".")[0]),
                       traffic=tiny_traffic(), t_start=time.perf_counter())
    assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_run_path_imports_no_jax():
    """Every module loaded by a whole run of every cell (set-up, window,
    check), compared by its top-level name."""
    code = RUN_PATH.format(root=str(ROOT), cells=CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mono_lidar_depth_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN), tops & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mono_lidar_depth_tpu_torch_x",
                        types.ModuleType("x"))
    assert "mono_lidar_depth_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert "jaxlib.fake" in run.forbidden_modules()


def test_new_files_are_found_without_editing(tmp_path):
    """A configuration, a traffic mix and a metric added as files to a
    copy of the harness are listed, and no file of the copy changed."""
    copy = tmp_path / "limo_bench"
    shutil.copytree(ROOT / "limo_bench", copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cfg = json.loads((copy / "configs" / "kitti_hdl64_tracklet_depth.json")
                     .read_text())
    cfg["name"] = "throwaway_cfg"
    (copy / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "throwaway_mix.json").write_text(json.dumps(
        {"name": "throwaway_mix", "arrival": "closed_loop",
         "warmup_frames": 2, "check_every": 4, "check_frames": 6,
         "trace_seconds": 1.0}))
    (copy / "metrics" / "throwaway_metric.py").write_text(
        'NAME = "throwaway.metric"\nUNIT = "ms"\nLAYER = "device"\n'
        'MOVES = "frames_per_s"\nSOURCE = "device_trace"\nSPANS = []\n\n\n'
        'def read(r):\n    return None\n')
    out = subprocess.run([sys.executable, str(copy / "run.py"), "--list"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert "throwaway_cfg" in found["configs"]
    assert "throwaway_mix" in found["traffic"]
    assert "throwaway_metric" in found["metrics"]
    assert found["pipelines"] == ["tracklet_depth"]
    assert "found" in out.stderr.splitlines()[0]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_every_metric_file_is_named_after_its_metric():
    mods = run.metric_modules()
    for name, mod in mods.items():
        assert Path(mod.__file__).stem == name.replace(".", "_")
        assert mod.MOVES in ("frame_ms_p95", "frames_per_s")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        mod = mods[m["name"]]
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (
            mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE)


def test_gather_counts_are_perf_mds():
    """The C = 2 step: 2 frames x 2 scales over 2,048 lanes each."""
    # the windows of the configuration's search rectangles, 6 x 9 px and
    # the road pass's 2 x 1.5 times that: 11 x 8 and 15 x 14 cells
    scales = [(3.0, 4.5, (11, 8)), (6.0, 6.75, (15, 14))]
    assert sum(ky * kx for _, _, (ky, kx) in scales) == 298
    shape = (2, 384, 1248)
    w = roofline.gather_work([shape, shape], 4096, scales, False)
    read = 2 * 2 * 384 * 1248 * 4 + 4096 * 8
    written = 18 * 298 * 4096 + 4096 * 4 * 2
    assert w.nbytes == read + written
    assert read == pytest.approx(7.67e6 + 32e3, rel=2e-3)
    assert written == pytest.approx(21.97e6 + 32e3, rel=1e-3)
    assert w.least_s() * 1e3 == pytest.approx(0.00887, rel=2e-3)
    assert w.flops / roofline.PEAK_FP32_S < w.nbytes / roofline.PEAK_BYTES_S


# The faults a run can have, planted in the program under the check.
def _state_unchanged(T):
    def process_frame(cfg, cam, l2c, state, frame):
        _, d, c = T.process_frame(cfg, cam, l2c, state, frame)
        return state, d, c
    return {"process_frame": process_frame}


def _half_left_out(T):
    def process_frame(cfg, cam, l2c, state, frame):
        keep = torch.arange(frame.ids_valid.shape[0]) < (
            frame.ids_valid.shape[0] // 2)
        return T.process_frame(cfg, cam, l2c, state,
                               frame._replace(ids_valid=frame.ids_valid
                                              & keep))
    return {"process_frame": process_frame}


def _answer_altered(T):
    """One depth 10% off where it is made: in what the node publishes
    and in its track table."""
    def process_frame(cfg, cam, l2c, state, frame):
        s, d, c = T.process_frame(cfg, cam, l2c, state, frame)
        d = d.clone()
        d[torch.nonzero(d > 0)[:1, 0]] *= 1.1
        depth = s.table.depth.clone()
        depth[torch.nonzero(depth[:, 0] > 0)[:1, 0], 0] *= 1.1
        return s._replace(table=s.table._replace(depth=depth)), d, c
    return {"process_frame": process_frame}


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    res = run_tiny(workload)
    assert res["correct"], res["checks"]
    assert res["checks"]["frames_checked"]["value"] >= 1


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    """A fault planted under the timed path: the run goes on, and the
    check finds it.  (One chip: no exchange between chips to leave out.)"""
    import mono_lidar_depth_tpu_torch as T

    broken = types.SimpleNamespace(**{k: getattr(T, k) for k in dir(T)
                                      if not k.startswith("__")})
    for name, fn in fault(T).items():
        setattr(broken, name, fn)
    res = run_tiny(workload, program=broken)
    assert not res["correct"], res["checks"]


def test_reference_imports_nothing_of_the_program():
    """The check's reference stands apart: importing it and the traffic
    it judges loads no module of the port."""
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import limo_bench.oracle, limo_bench.tracks, limo_bench.scene; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mono_lidar_depth_tpu_torch" not in out.stdout
