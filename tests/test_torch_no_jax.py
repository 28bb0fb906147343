"""The port stands alone: it imports neither jax nor the JAX package, and
the modules it copies from the JAX package match their originals."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mono_lidar_depth_tpu_torch as port
from mono_lidar_depth_tpu import config as jcfg
from mono_lidar_depth_tpu.core import result_types as jrt
from mono_lidar_depth_tpu.io import kitti as jkitti
from mono_lidar_depth_tpu_torch import config as tcfg
from mono_lidar_depth_tpu_torch.core import result_types as trt
from mono_lidar_depth_tpu_torch.io import kitti as tkitti

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "mono_lidar_depth_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mono_lidar_depth_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="mono_lidar_depth_tpu_torch."))


def test_port_imports_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {_port_modules()!r} + ['mono_lidar_depth_tpu_torch', "
        "'chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_import_statement(path):
    """Not even a lazy import inside a function."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["DepthEstimatorConfig", "TrackletConfig"])
def test_config_copy_matches(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert _fields(tc) == _fields(jc)
    assert jcfg._KEY_ALIASES == tcfg._KEY_ALIASES
    assert jcfg._ACCEPTED_UNUSED == tcfg._ACCEPTED_UNUSED
    if name == "DepthEstimatorConfig":
        raw = {"pixelarea_search_width": 8, "histogram_segmentation_bin_"
               "width": 0.5, "road_search_scale_x": 2.5,
               "do_use_nearestNeighborSearch": 1}
        a, b = jc.from_dict(raw), tc.from_dict(raw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.primary_window, a.road_window, a.histogram_bins) == (
            b.primary_window, b.road_window, b.histogram_bins)


def test_result_types_match():
    assert [(r.name, int(r)) for r in trt.DepthResultType] == [
        (r.name, int(r)) for r in jrt.DepthResultType]
    assert trt.NUM_RESULT_TYPES == jrt.NUM_RESULT_TYPES
    assert tuple(map(int, trt.SUCCESS_CODES)) == tuple(
        map(int, jrt.SUCCESS_CODES))


@pytest.mark.parametrize("seed,n", [(0, 1000), (5, 12345)])
def test_synthetic_scan_copy_matches(seed, n):
    a = jkitti.make_synthetic_scan(np.random.default_rng(seed), n)
    b = tkitti.make_synthetic_scan(np.random.default_rng(seed), n)
    assert a.tobytes() == b.tobytes()
    pa, va = jkitti.pad_cloud(a, n, n + 100)
    pb, vb = tkitti.pad_cloud(b, n, n + 100)
    assert pa.tobytes() == pb.tobytes() and np.array_equal(va, vb)
