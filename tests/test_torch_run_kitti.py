"""The port's CLI (scripts/run_kitti_torch.py) on the CPU: the copy of
tests/test_kitti_fixture.py::test_run_kitti_cli_on_fixture over the real
two-frame fixture, `vo` with a checkpoint, `posegraph` on a generated
synthetic sequence, and `selftest` in-process."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

FIXTURE = Path(__file__).parent / "fixtures" / "kitti_mini"
REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "run_kitti_torch.py"


@pytest.fixture(scope="module")
def cli():
    spec = importlib.util.spec_from_file_location("run_kitti_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    assert lines, text[-2000:]
    return json.loads(lines[-1])


def test_run_kitti_torch_cli_on_fixture():
    """The real-data CLI path on the fixture, in a subprocess on the CPU,
    as `run_kitti_torch.py depth --root <real kitti>` runs."""
    r = subprocess.run(
        [sys.executable, str(SCRIPT), "depth", "--root", str(FIXTURE),
         "--seq", "04", "--device", "cpu"],
        capture_output=True, text=True, timeout=900, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    out = _last_json(r.stdout)
    assert out["frames"] == 1
    assert out["total_points"] > 0 and 0.0 <= out["success_rate_all"] <= 1.0


def test_vo_with_checkpoint(cli, capsys, tmp_path):
    from mono_lidar_depth_tpu_torch import (DepthEstimatorConfig,
                                            OdometryConfig, OdometryState,
                                            init_tracker, load_checkpoint)
    import torch

    ckpt = tmp_path / "vo.npz"
    cli.main(["vo", "--root", str(FIXTURE), "--seq", "04", "--device", "cpu",
              "--checkpoint", str(ckpt)])
    out = _last_json(capsys.readouterr().out)
    assert out["frames"] == 1 and out["next_frame"] == 2
    assert np.isfinite(out["ate_rmse"])
    cfg = DepthEstimatorConfig()
    fresh = (init_tracker(torch.zeros((370, 1226)), cfg.max_features,
                          levels=4),
             OdometryState.create(cfg, OdometryConfig(), 2048, 12, "cpu"))
    carry, meta = load_checkpoint(str(ckpt), fresh)
    assert meta == {"next_frame": 2}
    assert int(carry[1].frame_idx) == 1


def test_posegraph_on_generated_sequence(cli, capsys, tmp_path):
    """Sequence 99 generated on demand; 8 frames give no closure at the
    default 100-frame gap, so the backend runs on the odometry chain."""
    cli.main(["posegraph", "--root", str(tmp_path), "--seq", "99",
              "--frames", "8", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "loop closures: 0/0 verified" in text
    out = _last_json(text)
    assert out["frames"] == 7 and out["closures"] == 0
    assert np.isfinite(out["ate_vo"]) and np.isfinite(out["ate_posegraph"])
    assert abs(out["ate_posegraph"] - out["ate_vo"]) < 0.05


def test_selftest_in_process(cli, capsys):
    cli.main(["selftest", "--device", "cpu"])
    out = _last_json(capsys.readouterr().out)
    assert out["ok"] is True and out["selftest_ate"] < 0.2
