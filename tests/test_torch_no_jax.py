"""The port stands alone: it imports neither jax nor the JAX package, and
the modules it copies from the JAX package match their originals.  Its
scripts import without PIL or yaml, which the machine with the card lacks,
and no public function defaults to the CPU."""

import ast
import ctypes
import dataclasses
import importlib
import inspect
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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
LAZY_ONLY = ("PIL", "yaml")  # may be imported inside a function only
SCRIPTS = ["chip_smoke.py", "profile_step.py", "gate_variants.py",
           "lk_scaling.py", "scripts/run_kitti_torch.py",
           "__graft_entry_torch__.py", "bench_torch.py",
           "scripts/endurance_run_torch.py", "scripts/exp_success_rate_torch.py",
           "scripts/bench_scaling_torch.py", "scripts/multihost_demo_torch.py",
           "scripts/make_parity_record_torch.py",
           "scripts/step_split_torch.py", "scripts/card_draws_torch.py",
           "scripts/span_cost_torch.py", "limo_bench/oracle_odometry.py"]
# the plain reference of the odometry stream: written apart from the port
ODOMETRY_REFERENCES = ["limo_bench/oracle_odometry.py"]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="mono_lidar_depth_tpu_torch."))


def test_port_imports_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {_port_modules()!r} + ['mono_lidar_depth_tpu_torch', "
        "'chip_smoke', 'profile_step', 'gate_variants', 'lk_scaling', "
        "'__graft_entry_torch__', 'bench_torch']:\n"
        "    importlib.import_module(m)\n"
        "import importlib.util as u\n"
        "for name in ('run_kitti_torch', 'endurance_run_torch', "
        "'exp_success_rate_torch', 'bench_scaling_torch', "
        "'multihost_demo_torch', 'make_parity_record_torch'):\n"
        "    spec = u.spec_from_file_location(name, f'scripts/{name}.py')\n"
        "    spec.loader.exec_module(u.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + LAZY_ONLY!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", ODOMETRY_REFERENCES)
def test_odometry_reference_stands_apart(path):
    """The odometry stream's reference loads neither JAX nor the JAX
    package nor the port it judges."""
    code = (
        "import importlib.util as u, sys\n"
        f"spec = u.spec_from_file_location('reference', {path!r})\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {*FORBIDDEN, "mono_lidar_depth_tpu_torch"}, tops


def _imported(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [(node.module or "").split(".")[0]]
    return []


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")] + SCRIPTS))
def test_no_jax_import_statement(path):
    """Not even a lazy import inside a function; PIL and yaml only there."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        for name in _imported(node):
            assert name not in FORBIDDEN, (path, name)
    for node in tree.body:  # module level
        for name in _imported(node):
            assert name not in LAZY_ONLY, (path, name)


def test_new_modules_are_covered():
    """The tracker, the frame-input loop and their data modules are
    among the files the import checks walk."""
    have = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"tracker/harris.py", "tracker/klt.py", "tracker/frontend.py",
            "tracker/__init__.py", "eval/kitti_eval.py",
            "io/synthetic_dataset.py", "vo/metrics.py", "device.py",
            "core/neighbors.py", "core/windows.py", "kernels.py",
            "core/row_segmentation.py", "io/kitti.py", "io/native.py",
            "io/messages.py", "io/checkpoint.py", "obs/timing.py",
            "vo/pose_graph.py", "vo/closures.py", "conversions/__init__.py",
            "conversions/convert.py", "collectives.py", "dist/__init__.py",
            "dist/mesh.py", "dist/sharded.py", "dist/launch.py",
            "obs/launches.py"} <= have


@pytest.mark.parametrize("source", sorted(
    p.name for p in (PKG / "csrc").glob("*.cu")))
def test_kernel_source_is_bound(source):
    """Every CUDA source is a library of kernels.py: each entry point
    declared there is an `extern "C" int` function of the source with as
    many parameters as argument types, and the source shares the error
    text helper."""
    from mono_lidar_depth_tpu_torch import kernels

    text = (PKG / "csrc" / source).read_text()
    entry_points = kernels._ENTRY_POINTS[source[:-len(".cu")]]
    found = {name: params for name, params in re.findall(
        r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert set(found) == set(entry_points)
    for name, argtypes in entry_points.items():
        assert len(found[name].split(",")) == len(argtypes), name
    assert '#include "common.cuh"' in text
    assert "jax" not in re.sub(r"//.*", "", text).lower()


def test_gate_kernel_is_bound_and_shares_the_lk_helpers():
    """The fused gate is the fourth library; it and the LK passes take
    their blend, warp sum and centre clamp from one header, which defines
    them once."""
    from mono_lidar_depth_tpu_torch import kernels

    assert set(kernels._ENTRY_POINTS) == {"windows", "lk_track",
                                          "gather_neighbors", "zncc_gate"}
    assert len(kernels._ENTRY_POINTS["zncc_gate"]["mld_zncc_gate"]) == 22
    assert len(kernels._ENTRY_POINTS["lk_track"]["mld_lk_track"]) == 13
    header = (PKG / "csrc" / "lk_common.cuh").read_text()
    for source in ("lk_track.cu", "zncc_gate.cu"):
        text = (PKG / "csrc" / source).read_text()
        assert '#include "lk_common.cuh"' in text
        for helper in ("lerp2", "warp_sum", "split_frac", "clampi"):
            assert f" {helper}(" in header
            assert not re.search(rf"__device__[^;{{]*\b{helper}\(", text)


@pytest.mark.parametrize("edited", ["lk_common.cuh", "common.cuh",
                                    "zncc_gate.cu"])
def test_build_hash_covers_headers(tmp_path, monkeypatch, edited):
    """An edit to a header or a source moves the build directory, so no
    library built from the old text is loaded."""
    import shutil

    from mono_lidar_depth_tpu_torch import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", csrc)
    monkeypatch.setattr(kernels, "_CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "_build")
    before = kernels.build_dir()
    assert before == kernels.build_dir() and before.parent == tmp_path / "_build"
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert kernels.build_dir() != before
    assert kernels.library_path("zncc_gate").parent == kernels.build_dir()


def test_gather_scale_layout_matches_the_source():
    """kernels.GatherScale mirrors `struct MldGatherScale` field for
    field: names, order, sizes."""
    from mono_lidar_depth_tpu_torch import kernels

    text = (PKG / "csrc" / "gather_neighbors.cu").read_text()
    body = re.search(r"struct MldGatherScale \{(.*?)\};", text, re.S).group(1)
    body = re.sub(r"//.*", "", body)
    c_fields = []
    for ctype, names in re.findall(r"(\w+\*?)\s+([\w, ]+);", body):
        c_fields += [(n.strip(), ctype) for n in names.split(",")]
    size = {"float": 4, "int32_t": 4}
    py_fields = [(n, ctypes.sizeof(t)) for n, t in kernels.GatherScale._fields_]
    assert py_fields == [(n, size.get(t, 8)) for n, t in c_fields]
    assert ctypes.sizeof(kernels.GatherScale) == 64
    assert "gather_neighbors" in kernels._ENTRY_POINTS


def test_lk_level_layout_matches_the_source():
    """kernels.LkLevel mirrors `struct MldLkLevel` field for field: names,
    order, sizes; and MAX_LEVELS and MAX_PATCH are the source's."""
    from mono_lidar_depth_tpu_torch import kernels
    from mono_lidar_depth_tpu_torch.tracker import klt

    text = (PKG / "csrc" / "lk_track.cu").read_text()
    body = re.search(r"struct MldLkLevel \{(.*?)\};", text, re.S).group(1)
    body = re.sub(r"//.*", "", body)
    c_fields = []
    for ctype, names in re.findall(r"(\w+\*?)\s+([\w, ]+);", body):
        c_fields += [(n.strip(), ctype) for n in names.split(",")]
    size = {"float": 4, "int32_t": 4}
    py_fields = [(n, ctypes.sizeof(t)) for n, t in kernels.LkLevel._fields_]
    assert py_fields == [(n, size.get(t, 8)) for n, t in c_fields]
    assert ctypes.sizeof(kernels.LkLevel) == 40
    assert f"kMaxLevels = {klt.MAX_LEVELS};" in text
    assert f"kMaxPatch = {klt.MAX_PATCH};" in text


def _public_callables():
    """(qualified name, callable) of every public function, class and
    public method or classmethod defined in the port."""
    for mod_name in ["mono_lidar_depth_tpu_torch"] + _port_modules():
        mod = importlib.import_module(mod_name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__",
                                               None) != mod_name:
                continue
            if inspect.isfunction(obj):
                yield f"{mod_name}.{name}", obj
            elif inspect.isclass(obj):
                yield f"{mod_name}.{name}", obj
                for attr, member in vars(obj).items():
                    if attr.startswith("_"):
                        continue
                    fn = getattr(member, "__func__", member)
                    if inspect.isfunction(fn):
                        yield f"{mod_name}.{name}.{attr}", fn


def test_no_public_default_is_the_cpu():
    """Every `device=` default is the card (`default_device()`), and no
    parameter of any kind defaults to "cpu"."""
    from mono_lidar_depth_tpu_torch.device import default_device

    seen = []
    for qual, fn in _public_callables():
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            continue
        for pname, prm in params.items():
            d = prm.default
            is_cpu = (d == "cpu" or (isinstance(d, torch.device)
                                     and d.type == "cpu"))
            assert not is_cpu, f"{qual}({pname}=...) defaults to the CPU"
            if pname == "device" and d is not inspect.Parameter.empty:
                assert d == default_device(), (qual, d)
                seen.append(qual)
    assert default_device() == torch.device("cuda", 0)
    # the entry points named in the port's rule
    for want in ("vo.pipeline.OdometryState.create",
                 "vo.pipeline.run_odometry",
                 "tracks.pipeline.TrackletDepthState.create",
                 "tracks.table.TrackTable.create",
                 "core.depth_estimator.no_ground_plane",
                 "convert.state_from_numpy", "obs.stats.DepthCalcStats.zeros",
                 "core.geometry.PinholeCamera.intrinsics",
                 "core.geometry.SE3.identity",
                 "eval.kitti_eval.eval_vo_sequence",
                 "eval.kitti_eval.eval_depth_sequence",
                 "eval.kitti_eval.measure_depth_device_time",
                 "io.kitti.KittiSequence.lidar_to_cam",
                 "io.kitti.KittiCalib.lidar_to_cam",
                 "io.synthetic_dataset.SyntheticSequence.lidar_to_cam",
                 "vo.closures.run_pose_graph_backend",
                 "vo.closures.closure_constraint_from_frames"):
        assert f"mono_lidar_depth_tpu_torch.{want}" in seen, want


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


def _source(obj) -> str:
    """Source of a function or class without its docstrings' text."""
    tree = ast.parse(inspect.cleandoc("\n" + inspect.getsource(obj)))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and (
                ast.get_docstring(node) is not None):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.unparse(tree)


@pytest.mark.parametrize("module,names", [
    ("io.native", ["_load", "native_available", "read_velodyne_native",
                   "NativeScanLoader"]),
    ("io.messages", ["FeatureTracks"]),
    ("io.kitti", ["read_velodyne", "pad_cloud", "make_synthetic_scan"]),
    ("eval.kitti_eval", ["_prefetch_iter", "_dev_img"]),
    ("obs.stats", ["success_rates"]),
])
def test_host_module_copies_match(module, names):
    """The host-side modules that the port copies (the originals sit in a
    package that imports JAX): the same code, docstrings aside."""
    jmod = importlib.import_module(f"mono_lidar_depth_tpu.{module}")
    tmod = importlib.import_module(f"mono_lidar_depth_tpu_torch.{module}")
    for name in names:
        ours, theirs = _source(getattr(tmod, name)), _source(
            getattr(jmod, name))
        if name == "_dev_img":  # astype(float32) / 255 against _div(.to(...),
            # 255.0): the same quotient, a true division on a card too
            assert theirs.split("/")[1] == " 255.0"
            assert ours.split("return ")[1] == (
                "_div(img.to(torch.float32), 255.0)")
            continue
        if name == "success_rates":  # one local variable inlined
            assert "SuccessRegionGrowing" in ours and "covered" in ours
            continue
        assert ours == theirs, name
    if module == "io.native":
        assert tmod._NATIVE_DIR == jmod._NATIVE_DIR == REPO / "native"
        assert tmod._LIB_PATH == jmod._LIB_PATH
    if module == "io.messages":
        assert [f.name for f in dataclasses.fields(tmod.FeatureTracks)] == [
            f.name for f in dataclasses.fields(jmod.FeatureTracks)]


@pytest.mark.parametrize("port_module,ref_module,names", [
    ("vo.closures", "eval.kitti_eval",
     ["propose_loop_closures", "_appearance_descriptor",
      "propose_loop_closures_appearance", "union_closure_candidates",
      "filter_consistent_closures", "calibrate_closure_weights",
      "_so3_log", "_so3_exp"]),
    ("conversions.convert", "conversions.convert",
     ["add_outlier_flags", "lift_to_depth", "mark_depth_outlier",
      "newest_pair_points"]),
])
def test_closure_and_conversion_copies_match(port_module, ref_module, names):
    """The closure backend's host numpy and the numpy conversions are the
    JAX package's code, docstrings aside; the port's eval package
    re-exports the reference's eval names."""
    jmod = importlib.import_module(f"mono_lidar_depth_tpu.{ref_module}")
    tmod = importlib.import_module(f"mono_lidar_depth_tpu_torch.{port_module}")
    for name in names:
        assert _source(getattr(tmod, name)) == _source(getattr(jmod, name)), \
            name
    from mono_lidar_depth_tpu import eval as jeval
    from mono_lidar_depth_tpu_torch import eval as teval
    assert set(jeval.__all__) <= set(teval.__all__)
    for name in ("closure_constraint_from_frames",
                 "filter_consistent_closures"):
        assert hasattr(teval.kitti_eval, name), name


def test_kitti_loader_interface_matches():
    """The port's KittiSequence has the JAX loader's public attributes and
    methods, plus what SyntheticSequence offers the evaluators."""
    from mono_lidar_depth_tpu_torch.io.synthetic_dataset import (
        SyntheticSequence)

    def public(cls):
        return {n for n in vars(cls) if not n.startswith("_")}

    assert public(jkitti.KittiSequence) <= public(tkitti.KittiSequence)
    assert {"scans", "scan", "image", "semantic", "lidar_to_cam"} <= (
        public(tkitti.KittiSequence) & public(SyntheticSequence))
    for name in ("_load_poses", "scans"):
        assert _source(getattr(tkitti.KittiSequence, name)) == _source(
            getattr(jkitti.KittiSequence, name))
    assert inspect.signature(tkitti.KittiSequence.__init__) == (
        inspect.signature(jkitti.KittiSequence.__init__))


def test_unported_markers_are_gone():
    """Neither optional configuration raises any more."""
    from mono_lidar_depth_tpu_torch.core import depth_estimator
    from mono_lidar_depth_tpu_torch.tracks import pipeline

    for mod, name in ((depth_estimator, "_NO_ROW_SEGMENTATION"),
                      (depth_estimator, "_check_supported"),
                      (pipeline, "_NO_SEMANTIC")):
        assert not hasattr(mod, name), name
    for path in PKG.rglob("*.py"):
        assert "NotImplementedError" not in path.read_text(), path
