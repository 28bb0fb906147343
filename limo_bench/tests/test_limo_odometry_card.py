"""The odometry cell on a CUDA card: a traced run at a small size reads
each of the cell's per-layer metrics, non-null, with the tracker kernels'
roofline shares at or below 100%; at the configuration's own size, over
a short window, the port comes out correct and the control (TF32 on)
does not.  Run on the chip with

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
from limo_bench.tests.tiny_odometry import CELL

TRACED = """
import json, sys, time
sys.path.insert(0, {root!r})
from limo_bench import run
from limo_bench.tests.tiny import tiny_traffic
from limo_bench.tests.tiny_odometry import tiny_config
res = run.run_cell({cell!r}, 2 ** 31 + 19, 2.0, True, cfg=tiny_config(),
                   traffic=tiny_traffic(), t_start=time.perf_counter())
print(json.dumps(res))
"""


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
def test_traced_run_reads_the_cells_metrics():
    """In a process of its own, as the benchmark runs."""
    _need_card()
    root = str(Path(__file__).resolve().parents[2])
    out = subprocess.run(
        [sys.executable, "-c", TRACED.format(root=root, cell=CELL)],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    _, per_layer = run.cell_metrics(CELL)
    assert set(res["metrics"]) == set(per_layer)
    for name in per_layer:
        assert res["metrics"][name]["value"] is not None, name
    for name in ("lk_track_roofline", "zncc_gate_roofline"):
        assert 0 < res["metrics"][name]["value"] <= 100, name
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


def _run(seed):
    """The cell at its configuration's size, its own sampling."""
    return run.run_cell(CELL, seed, 20.0, False, device="cuda",
                        t_start=time.perf_counter())


@pytest.mark.card
def test_port_is_correct_and_control_is_not():
    _need_card()
    import mono_lidar_depth_tpu_torch  # noqa: F401  (turns TF32 off)

    res = _run(2 ** 31 + 23)
    assert res["correct"], res["checks"]
    control.set_tf32(True)
    try:
        res = _run(2 ** 31 + 23)
    finally:
        control.set_tf32(False)
    assert not res["correct"], res["checks"]
