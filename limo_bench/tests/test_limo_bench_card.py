"""The control and the trace on a CUDA card: at the configuration's own
size, over a short window, the port comes out correct and the control
(the port with TF32 switched on) does not; at a small size, a traced run
reads every per-layer metric of its cell.  Run on the chip with

    python3 -m pytest -q -p no:cacheprovider limo_bench/tests -m card
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from limo_bench import control, run

CELLS = ["kitti_hdl64_tracklet_depth.online"]


def _run(workload, seed=2 ** 31 + 5):
    """The cell at its configuration's size, 6 frames checked."""
    traffic = run.load_json(run.BENCH / "traffic" / "online.json")
    traffic.update(check_every=4, check_frames=6)
    return run.run_cell(workload, seed, 2.0, False, device="cuda",
                        traffic=traffic, t_start=time.perf_counter())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_port_is_correct_and_control_is_not(workload):
    _need_card()
    import mono_lidar_depth_tpu_torch  # noqa: F401  (turns TF32 off)

    assert _run(workload)["correct"]
    control.set_tf32(True)
    try:
        res = _run(workload)
    finally:
        control.set_tf32(False)
    assert not res["correct"], res["checks"]


TRACED = """
import json, sys, time
sys.path.insert(0, {root!r})
from limo_bench import run
from limo_bench.tests.tiny import tiny_config, tiny_traffic
w = {workload!r}
res = run.run_cell(w, 2 ** 31 + 6, 2.0, True, cfg=tiny_config(w.split(".")[0]),
                   traffic=tiny_traffic(), t_start=time.perf_counter())
print(json.dumps(res))
"""


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_its_metrics(workload):
    """In a process of its own, as the benchmark runs."""
    _need_card()
    root = str(Path(__file__).resolve().parents[2])
    out = subprocess.run(
        [sys.executable, "-c", TRACED.format(root=root, workload=workload)],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    _, per_layer = run.cell_metrics(workload)
    assert set(res["metrics"]) == set(per_layer)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    roof = res["metrics"]["gather_neighbors_roofline"]["value"]
    assert 0 < roof <= 100
