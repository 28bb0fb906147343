"""scripts/make_parity_record_torch.py and the three scripts it runs, the
port's twins of scripts/make_parity_record.py, exp_success_rate.py,
bench_scaling.py and multihost_demo.py, against the references on the
CPU.

  * Configuration: the record's spec, DepthEstimatorConfig, config-2 modes,
    eval_* and proposal arguments, drift and every call the stages make
    equal the reference's keyword for keyword (read from its source with
    `ast`; the stages run on stand-ins that record their calls); the drift
    injection equals the reference's statements to the bit.  The sweep's
    spec, configuration, flags, row keys, `top_outcomes` and `--max-range`
    capping (byte-equal scans) against exp_success_rate.py; the scaling
    table's and the demo's numpy data byte-equal to bench_scaling.py's and
    multihost_demo.py's, their printed keys equal.
  * The record's keys are the reference's plus `port`
    (chip_smoke.parity_py_keys reads them from the four sources); the
    markdown, rendered from one record dict by the twin and by the
    reference's own `_render_md`, has the same tables row for row, the
    same sections in order and the reference's prose but for the header,
    the device/host paragraph and the scaling heading and demo line.
  * Sequence level, on 12 frames of the record's sequence at its
    configuration, with the JAX package's RANSAC draws and image injected
    (tests/torch_parity.inject_jax_frame_draws): the `road_veto_off` and
    `production` rows against the JAX package's `eval_depth_sequence`;
    `persist_landmarks` VO against its `eval_vo_sequence`; and the
    persisted landmarks (`lm_world`, `lm_id`) through chunking, a
    checkpoint and the resume, to the bit.
  * Modules 2 and 3 on CPU gloo ranks (1 and 2 ranks; the demo's 2
    processes); `main()` refuses without a card and refuses the
    reference's tags; with `--device cpu` and its subprocess legs
    stubbed it writes both files.
"""

import argparse
import ast
import dataclasses
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mono_lidar_depth_tpu as J
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.core.result_types import (
    DepthResultType as JDepthResultType)
from mono_lidar_depth_tpu.eval import kitti_eval as jeval
from mono_lidar_depth_tpu.io.kitti import KittiSequence as JKittiSequence
from mono_lidar_depth_tpu.io.synthetic_dataset import (
    SyntheticSpec as JSpec, generate_kitti_sequence)
from mono_lidar_depth_tpu.vo import ba as jba
from mono_lidar_depth_tpu.vo import pipeline as jvo
from mono_lidar_depth_tpu_torch.core.result_types import DepthResultType as R
from mono_lidar_depth_tpu_torch.eval import kitti_eval as teval
from mono_lidar_depth_tpu_torch.io.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from mono_lidar_depth_tpu_torch.io.kitti import KittiSequence

from torch_parity import inject_jax_frame_draws

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
sys.path.insert(0, str(SCRIPTS))  # spawned ranks import the twins by name

import bench_scaling_torch as S  # noqa: E402
import exp_success_rate_torch as E  # noqa: E402
import make_parity_record_torch as P  # noqa: E402
import multihost_demo_torch as M  # noqa: E402

FRAMES = 12  # frames of the sequence-level comparisons


def _tree(name: str):
    return ast.parse((SCRIPTS / f"{name}.py").read_text())


def _fn(tree, name: str) -> ast.FunctionDef:
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _calls(node, callee: str) -> list:
    return sorted((n for n in ast.walk(node) if isinstance(n, ast.Call)
                   and ast.unparse(n.func) == callee),
                  key=lambda n: (n.lineno, n.col_offset))


def _const_kwargs(call, names=None) -> dict:
    """The keyword arguments of a call whose values are constants, or
    names resolved through `names`."""
    out = {}
    for kw in call.keywords:
        if isinstance(kw.value, ast.Constant):
            out[kw.arg] = kw.value.value
        elif names is not None and ast.unparse(kw.value) in names:
            out[kw.arg] = names[ast.unparse(kw.value)]
    return out


def _statements(path: Path, fn: ast.FunctionDef, first: str, last: str
                ) -> str:
    """The source of `fn`'s body statements from the one that unparses to
    start with `first` to the one that unparses to `last`, dedented."""
    body = [n for n in ast.walk(fn) if isinstance(n, ast.stmt)]
    start = next(n for n in body if ast.unparse(n).startswith(first))
    end = next(n for n in body if ast.unparse(n) == last)
    lines = path.read_text().splitlines()[start.lineno - 1:end.end_lineno]
    indent = len(lines[0]) - len(lines[0].lstrip())
    return "\n".join(ln[indent:] for ln in lines)


# ---- module 4: the record's configuration --------------------------------

REF = SCRIPTS / "make_parity_record.py"
REF_MAIN = _fn(_tree("make_parity_record"), "main")


def test_spec_and_config_are_the_references():
    assert "\nW, H = 384, 128\n" in REF.read_text()
    wh = {"W": P.W, "H": P.H}
    spec = dataclasses.asdict(P.record_spec(220))
    (call,) = _calls(REF_MAIN, "SyntheticSpec")
    want = _const_kwargs(call, wh)
    assert ast.unparse(next(k.value for k in call.keywords
                            if k.arg == "frames")) == "frames"
    assert len(want) == len(call.keywords) - 1
    assert all(spec[k] == v for k, v in want.items()) and spec["frames"] == 220
    (call,) = _calls(REF_MAIN, "DepthEstimatorConfig")
    want = _const_kwargs(call, wh)
    assert len(want) == len(call.keywords)
    cfg = dataclasses.asdict(P.record_config())
    assert all(cfg[k] == v for k, v in want.items())
    assert P.record_config() == T.DepthEstimatorConfig(**want)


def _reference_modes() -> list:
    """(name, configuration overrides, eval keywords) of config 2, read
    from the reference's mode loop, its `cfg.replace` chain and its
    fast-rasterization call."""
    loop = next(n for n in ast.walk(REF_MAIN) if isinstance(n, ast.For)
                and ast.unparse(n.target) == "(name, kw)")
    modes = []
    for elt in loop.iter.elts:
        name = elt.elts[0].value
        kw = eval(ast.unparse(elt.elts[1]), {"dict": dict})
        modes.append([name, {}, kw])
    chain = next(n for n in loop.body if isinstance(n, ast.If))
    while chain is not None:
        name = chain.test.comparators[0].value
        (call,) = _calls(chain.body[0], "cfg.replace")
        next(m for m in modes if m[0] == name)[1] = _const_kwargs(call)
        chain = chain.orelse[0] if chain.orelse else None
    fast = next(c for c in _calls(REF_MAIN, "cfg.replace")
                if ast.unparse(c) == "cfg.replace(fast_rasterization=True)")
    modes.append(["fast_rasterization", _const_kwargs(fast), {}])
    return [tuple(m) for m in modes]


def test_modes_are_the_references():
    assert [(n, o, k) for n, o, k in P.MODES + (P.FAST,)] == \
        _reference_modes()
    names = [n for n, _, _ in P.MODES + (P.FAST,)]
    md = _fn(_tree("make_parity_record"), "_render_md")
    order = next(n for n in ast.walk(md) if isinstance(n, ast.For)
                 and ast.unparse(n.target) == "k"
                 and "fast_rasterization" in ast.unparse(n.iter))
    assert list(P.MD_ORDER) == [e.value for e in order.iter.elts]
    assert sorted(names) == sorted(P.MD_ORDER)


class _Recorder:
    """Stand-ins for the functions the stages call: each records (callee,
    its arguments) and returns something of the right shape."""

    def __init__(self, frames):
        self.calls = []
        self.frames = frames

    def __call__(self, name, fn):
        def stand_in(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return stand_in


def _stub_stages(mp, frames):
    rec = _Recorder(frames)
    ids = list(range(1, frames))
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4), (frames - 1, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(frames - 1, 3))

    def depth(seq, cfg, **kw):
        return {"success_rate_all": 0.4, "success_rate_lidar_covered": 0.6,
                "total_points": 10, "counters": [0] * 21, "frames": 1}

    def vo(seq, cfg, ocfg, **kw):
        return {"frames": frames - 1, "poses": poses, "frame_ids": ids,
                "ate_rmse": 1.0, "rpe_trans_rmse": 0.05,
                "rpe_rot_rmse_deg": 1.5}

    stubs = {
        "eval_depth_sequence": depth,
        "measure_depth_device_time": lambda *a, **k: {
            "device_s": 1.0, "device_ms_per_frame": 10.0, "frames": 1},
        "eval_vo_sequence": vo,
        "propose_loop_closures": lambda *a, **k: [(0, 6)],
        "propose_loop_closures_appearance": lambda *a, **k: [(1, 7)],
        "closure_constraint_from_frames": lambda *a, **k: (
            np.eye(3), np.zeros(3), np.ones(6)),
        "filter_consistent_closures": lambda poses, closures, **k: closures,
        "run_pose_graph_backend": lambda poses, used, **k: poses,
    }
    for name, fn in stubs.items():
        mp.setattr(P, name, rec(name, fn))
    seq = SimpleNamespace(gt_poses=np.tile(np.eye(4), (frames, 1, 1)))
    return rec, seq


def test_stage_calls_are_the_references(monkeypatch, capsys):
    """Every call of stages 2-4b, keyword for keyword against the
    reference's calls of the same functions (the port adds `device`)."""
    rec, seq = _stub_stages(monkeypatch, 9)
    port = {"seconds": {}, "launches": {}}
    out = P.record_stages(seq, P.record_config(), "cpu", port)
    assert list(out) == ["depth", "vo", "pose_graph",
                         "pose_graph_high_drift"]
    capsys.readouterr()
    got: dict = {}
    on_device = {"eval_depth_sequence", "measure_depth_device_time",
                 "eval_vo_sequence", "closure_constraint_from_frames",
                 "run_pose_graph_backend"}
    for name, args, kwargs in rec.calls:
        assert (kwargs.pop("device", None) == "cpu") == (name in on_device)
        got.setdefault(name, []).append((args, kwargs))

    # config 2
    modes = _reference_modes()
    ref_eval = _calls(REF_MAIN, "eval_depth_sequence")
    assert {json.dumps(_const_kwargs(c)) for c in ref_eval} == {
        json.dumps(P.DEPTH_KW)}
    want_cfgs = []
    for name, over, kw in modes:
        n = 1 if name == "fast_rasterization" else 2
        want_cfgs += [(P.record_config().replace(**over), kw)] * n
    assert [(a[1], {k: v for k, v in kw.items() if k not in P.DEPTH_KW})
            for a, kw in got["eval_depth_sequence"]] == want_cfgs
    assert all({k: kw[k] for k in P.DEPTH_KW} == P.DEPTH_KW
               for _, kw in got["eval_depth_sequence"])
    (call,) = _calls(REF_MAIN, "measure_depth_device_time")
    (args, kwargs), = got["measure_depth_device_time"]
    assert kwargs == _const_kwargs(call) and args[1] == P.record_config()

    # config 3: three re-initialized runs, then persisted landmarks
    ref_vo = _calls(REF_MAIN, "eval_vo_sequence")
    assert [ast.unparse(c.args[2]) for c in ref_vo] == [
        "OdometryConfig()", "OdometryConfig(persist_landmarks=True)"]
    assert all(_const_kwargs(c) == P.VO_KW for c in ref_vo)
    assert [(a[2], kw) for a, kw in got["eval_vo_sequence"]] == [
        (T.OdometryConfig(), P.VO_KW)] * 3 + [
        (T.OdometryConfig(persist_landmarks=True), P.VO_KW)]

    # configs 4 and 4b
    ref_prop = [_const_kwargs(c) for c in _calls(REF_MAIN,
                                                 "propose_loop_closures")]
    assert [kw for _, kw in got["propose_loop_closures"]] == ref_prop
    ref_app = {json.dumps(_const_kwargs(c)) for c in _calls(
        REF_MAIN, "propose_loop_closures_appearance")}
    assert [json.dumps(kw) for _, kw in got[
        "propose_loop_closures_appearance"]] == sorted(ref_app)
    (ref_cc,) = {ast.unparse(kw.value) for c in _calls(
        REF_MAIN, "closure_constraint_from_frames") for kw in c.keywords}
    assert ref_cc == "cfg.max_features"
    assert all(kw == {"max_features": P.record_config().max_features}
               for _, kw in got["closure_constraint_from_frames"])
    assert [kw.arg for c in _calls(REF_MAIN, "filter_consistent_closures")
            for kw in c.keywords] == ["remeasure"] * 2
    assert [sorted(kw) for _, kw in got["filter_consistent_closures"]] == [
        ["remeasure"]] * 2
    ref_pg = [_const_kwargs(c) for c in _calls(REF_MAIN,
                                               "run_pose_graph_backend")]
    assert [kw for _, kw in got["run_pose_graph_backend"]] == ref_pg
    # every candidate verified once, and each filter remeasures through
    # the same verification
    assert len(got["closure_constraint_from_frames"]) == 4
    assert out["pose_graph_high_drift"]["injected"] == next(
        ast.literal_eval(v) for n in ast.walk(REF_MAIN)
        if isinstance(n, ast.Dict) for k, v in zip(n.keys, n.values)
        if isinstance(k, ast.Constant) and k.value == "injected")
    assert out["pose_graph"]["closures_used"] == 2
    assert port["verify"]["pose_graph"]["calls"] == 2


def test_drift_injection_is_the_references():
    """The reference's config-4b statements (from `yaw = ...` to `drifted
    = np.stack(drifted)`), run on the same poses, give the same bits."""
    code = _statements(REF, REF_MAIN, "yaw = ", "drifted = np.stack(drifted)")
    rng = np.random.default_rng(3)
    poses = np.tile(np.eye(4), (40, 1, 1))
    for k in range(40):
        th = 0.05 * k
        poses[k, :3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]]
        poses[k, :3, 3] = rng.normal(size=3) + [0.0, 0.0, 0.55 * k]
    ns = {"np": np, "poses": poses}
    exec(compile(code, str(REF), "exec"), ns)
    got = P.inject_drift(poses)
    assert got.dtype == ns["drifted"].dtype and got.shape == (40, 4, 4)
    assert got.tobytes() == ns["drifted"].tobytes()


def _flags(tree) -> dict:
    """{dest: default} of every add_argument in a source."""
    out = {}
    for c in _calls(tree, "ap.add_argument"):
        dest = c.args[0].value.lstrip("-").replace("-", "_")
        kw = {k.arg: k.value for k in c.keywords}
        if "default" not in kw:  # store_true: False; else None
            out[dest] = False if "action" in kw else None
        elif ast.unparse(kw["default"]) == "str(REPO)":
            out[dest] = "str(REPO)"
        else:
            out[dest] = ast.literal_eval(kw["default"])
    return out


def _twin_flags(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_flags_are_the_references():
    ref = _flags(_tree("make_parity_record"))
    twin = _twin_flags(P.parser())
    assert ref.pop("platform") is None and ref.pop("tag") == "r5"
    assert twin.pop("device") == "cuda:0" and twin.pop("commit") is None
    assert twin.pop("tag") == "torch_h100"
    assert twin.pop("out") == str(P.REPO) and ref.pop("out") == "str(REPO)"
    assert twin == ref
    ref = _flags(_tree("exp_success_rate"))
    twin = _twin_flags(E.parser())
    assert ref.pop("platform") is None and twin.pop("device") == "cuda:0"
    assert twin == ref


# ---- the record's keys and its markdown ------------------------------------

def _record(tmp_path, monkeypatch):
    """main() on 4 frames on the CPU with its subprocess legs stubbed."""
    sweep = [json.loads(ln) for ln in (
        '{"lidar_rows": 20, "max_range": null, "road_texture": 1.0, '
        '"far_veto": true, "success_all": 0.4, "success_covered": 0.66, '
        '"total_points": 100, "top_outcomes": {"Success": 0.3}}',)]
    monkeypatch.setattr(P, "sweep_leg", lambda extra, device, frames=60: (
        [dict(r, far_veto="--no-far-veto" not in extra) for r in sweep],
        {"launches": {}}))
    monkeypatch.setattr(P, "scaling_leg", lambda device, ranks=(1, 2, 4): (
        [{"workload": "depth_association_frame_parallel", "devices": [1],
          "frames_per_s": [1.0], "efficiency_at_max": 1.0, "note": "n"},
         {"workload": "distributed_schur_ba", "devices": [1],
          "solves_per_s": [1.0], "efficiency_at_max": 1.0, "note": "n"}],
        {"cards": 0, "launches": {}}))
    monkeypatch.setattr(P, "demo_leg", lambda device: {"ok": True, "tail": [
        '{"multihost_processes": 2, "global_devices": 2, '
        '"distributed_final_cost": 1.0, "single_process_final_cost": 1.0, '
        '"match": true}']})
    assert P.main(["--device", "cpu", "--frames", "4", "--tag", "cpu_small",
                   "--out", str(tmp_path), "--commit", "abc1234"]) == 0
    return json.loads((tmp_path / "PARITY_cpu_small.json").read_text())


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        tmp = tmp_path_factory.mktemp("record")
        return tmp, _record(tmp, mp)


def test_main_writes_the_record(written):
    tmp, rec = written
    chip_smoke.check_parity_keys(rec)
    assert rec["frames"] == 4 and rec["backend"] == "cpu"
    assert rec["commit"] == rec["port"]["commit"] == "abc1234"
    port = rec["port"]
    assert port["torch"] == torch.__version__ and port["card"].startswith(
        "cpu")
    assert set(port["seconds"]) >= {"render", "depth", "vo", "pose_graph",
                                    "pose_graph_high_drift", "total"}
    assert set(port["launches"]) == {"depth", "vo", "pose_graph",
                                     "pose_graph_high_drift"}
    # on the CPU every wrapper takes its plain version: no launch
    assert all(n == 0 for stage in port["launches"].values()
               for n in stage.values())
    assert port["reinit_runs"]["max_pose_diff"] == [0.0, 0.0]
    md = (tmp / "PARITY_cpu_small.md").read_text()
    assert md.startswith("# PARITY_cpu_small") and "## Config 4b" in md


def _reference_render():
    spec = importlib.util.spec_from_file_location("make_parity_record", REF)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._render_md


def _sections(md: str) -> tuple[list, list, list]:
    """(headings, table rows, other lines) of a markdown text."""
    lines = md.splitlines()
    return ([ln for ln in lines if ln.startswith("#")],
            [ln for ln in lines if ln.startswith("|")],
            [ln for ln in lines if ln and not ln.startswith(("#", "|"))])


@pytest.mark.parametrize("which", ["r5", "port"])
def test_markdown_matches_the_references(written, which):
    """Rendered from one record dict (PARITY_r5.json, and the port's CPU
    record), the twin's markdown has the reference's tables row for row,
    its sections in order (the header and the scaling heading may differ)
    and every other line of its prose in order, but for the device/host
    paragraph and the demo line; the twin adds the cold-call note and
    the port section."""
    rec = (json.loads((REPO / "PARITY_r5.json").read_text()) if which == "r5"
           else written[1])
    ref_h, ref_t, ref_p = _sections(_reference_render()(rec, "x"))
    got_h, got_t, got_p = _sections(P.render_md(rec, "x"))
    assert got_t == ref_t
    assert got_h[0] == ref_h[0] == "# PARITY_x — committed evaluation record"
    scaling = [i for i, h in enumerate(ref_h) if h.startswith("## Scaling")]
    assert len(scaling) == 1 and got_h[scaling[0]].startswith("## Scaling")
    assert [h for i, h in enumerate(got_h[:len(ref_h)]) if i not in scaling] \
        == [h for i, h in enumerate(ref_h) if i not in scaling]
    assert got_h[len(ref_h):] == (
        ["## Port: seconds and kernel launches per stage"]
        if "port" in rec else [])
    differ = ("Regenerated by", "Device/host split", "2-process")
    kept = [ln for ln in ref_p if not ln.startswith(differ)]
    it = iter(got_p)
    assert all(any(ln == g for g in it) for ln in kept)
    assert "remote tunnel" not in P.render_md(rec, "x")
    assert "virtual 8-device mesh" not in P.render_md(rec, "x")


def test_main_refuses(capsys):
    assert not torch.cuda.is_available()
    before = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in REPO.glob("PARITY_r*")}
    assert P.main([]) == 1  # cuda:0 by default, and there is no card here
    for tag in ("r5", "r2", "r12"):
        assert P.main(["--tag", tag, "--device", "cpu", "--frames", "4"]) == 2
    assert "make_parity_record_torch:" in capsys.readouterr().err
    assert {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in REPO.glob("PARITY_r*")} == before
    assert P.REFERENCE_TAG.fullmatch("torch_h100") is None
    for main in (E.main, S.main, M.main):
        assert main([]) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run(4)


# ---- module 1: the density sweep ----------------------------------------

EXP = SCRIPTS / "exp_success_rate.py"
EXP_MAIN = _fn(_tree("exp_success_rate"), "main")


@pytest.mark.parametrize("rows,far_veto", [(10, True), (20, False),
                                           (40, True), (64, False)])
def test_sweep_spec_and_config_are_the_references(rows, far_veto):
    (call,) = _calls(EXP_MAIN, "SyntheticSpec")
    names = {"W": E.W, "H": E.H, "args.frames": 60, "rows": rows,
             "args.road_texture": 0.5}
    want = _const_kwargs(call, names)
    assert len(want) == len(call.keywords)
    assert dataclasses.asdict(E.sweep_spec(60, rows, 0.5)) == \
        dataclasses.asdict(T.SyntheticSpec(**want))
    (call,) = _calls(EXP_MAIN, "DepthEstimatorConfig")
    kw = {k.arg: k.value for k in call.keywords}
    want = {k: eval(ast.unparse(v), {"W": E.W, "H": E.H, "rows": rows,
                                     "args": SimpleNamespace(
                                         no_far_veto=not far_veto)})
            for k, v in kw.items()}
    assert E.sweep_config(rows, far_veto) == T.DepthEstimatorConfig(**want)
    assert E.sweep_config(64).max_points == 32768
    (call,) = _calls(EXP_MAIN, "eval_depth_sequence")
    assert _const_kwargs(call) == E.DEPTH_KW


def test_max_range_capping_is_the_references():
    """The reference's `capped_scans` wrapper and the twin's, on the same
    rendered scans: byte-equal."""
    block = next(n for n in ast.walk(EXP_MAIN) if isinstance(n, ast.If)
                 and ast.unparse(n.test) == "args.max_range is not None")
    code = "\n".join(ast.unparse(s) for s in block.body)
    spec = E.sweep_spec(3, 20)
    ref_seq, seq = T.render_sequence(spec), T.render_sequence(spec)
    ns = {"seq": ref_seq, "args": SimpleNamespace(max_range=20.0)}
    exec(compile(code, str(EXP), "exec"), ns)
    E.cap_range(seq, 20.0)
    got, want = list(seq.scans(16384)), list(ref_seq.scans(16384))
    assert len(got) == 3
    for (a, n), (b, m) in zip(got, want):
        assert n == m and 0 < n < 10000
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert np.linalg.norm(a[:n, :3], axis=1).max() <= 20.0


def test_top_outcomes_are_the_references():
    """The reference's statements from `counters = ...` to the end of its
    loop, on made-up counters with ties, name the same outcomes."""
    code = _statements(EXP, EXP_MAIN, "counters = out.get",
                       ast.unparse(next(
                           n for n in ast.walk(EXP_MAIN)
                           if isinstance(n, ast.If)
                           and ast.unparse(n.test) == "counters is not None")))
    counters = [0, 40, 90, 7, 0, 3, 7, 2, 12, 0, 0, 0, 0, 0, 0, 0, 33, 0, 0,
                0, 5]
    ns = {"out": {"counters": counters}, "DepthResultType": JDepthResultType}
    exec(compile(code, str(EXP), "exec"), ns)
    got = E.top_outcomes(counters)
    assert list(got.items()) == list(ns["fails"].items())
    assert [R[k] for k in got] == [R.RadiusSearchInsufficientPoints,
                                   R.Success, R.SuccessRoad,
                                   R.TriangleNotPlanar,
                                   R.HistogramNoLocalMax,
                                   R.TresholdDepthLocalGreaterMax]


def test_sweep_prints_the_references_lines(capsys):
    out = E.run(4, [10], device="cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    keys = chip_smoke.parity_py_keys()[("density_sweep", "*")]
    assert len(lines) == 2 and list(lines[0]) == keys
    assert lines[1] == {"sweep": [lines[0]]} == {"sweep": out["sweep"]}
    assert lines[0]["lidar_rows"] == 10 and lines[0]["far_veto"] is True
    assert 0 < lines[0]["success_covered"] < 1
    assert set(out["port"]["launches"].values()) == {0}


# ---- modules 2 and 3: the scaling table and the demo ----------------------

def test_scaling_data_is_the_references():
    """bench_scaling.py's statements that draw its data, run with 2 as the
    largest device count, against `workload_inputs(2)`: byte-equal."""
    tree = _tree("bench_scaling")
    main = _fn(tree, "main")
    path = SCRIPTS / "bench_scaling.py"
    first = _statements(path, main, "rng = np.random", "fvalids = jnp.ones("
                        "(B, cfg.max_features), bool)")
    second = _statements(path, main, "K, L = (8", ast.unparse(next(
        n for n in ast.walk(main) if isinstance(n, ast.Assign)
        and ast.unparse(n.targets[0]) == "problem")))
    (call,) = _calls(main, "DepthEstimatorConfig")
    assert _const_kwargs(call) == S.CFG
    (call,) = _calls(main, "PinholeCamera")
    assert tuple(c.value for c in call.args) == S.CAMERA
    (call,) = _calls(main, "distributed_ba")
    assert _const_kwargs(call) == {"iters": S.BA_ITERS}
    ns = {"np": np, "jnp": jnp, "jax": jax, "BAProblem": jba.BAProblem,
          "cfg": J.DepthEstimatorConfig(**S.CFG),
          "args": SimpleNamespace(devices=[1, 2])}
    exec(compile(first + "\n" + second, str(path), "exec"), ns)
    inp = S.workload_inputs(2)
    want = (ns["clouds"], ns["cvalids"], ns["feats"], ns["fvalids"])
    for a, b in zip(inp["frames"], want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(inp["ba"], ns["problem"]):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    assert inp["draws"][0].shape == (4, S.CFG["ransac_subsample_points"])


def test_scaling_on_cpu_ranks(capsys):
    out = S.run([1, 2], "cpu", reps=1)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    keys = chip_smoke.parity_py_keys()
    assert lines == out["lines"] and len(lines) == 2
    for i, line in enumerate(lines):
        assert list(line) == keys[("scaling", i)]
        assert line["devices"] == [1, 2]
    assert all(f > 0 for f in lines[0]["frames_per_s"] + lines[1][
        "solves_per_s"])
    assert "CPU ranks" in lines[0]["note"]
    assert out["port"]["cards"] == 0 and len(out["port"]["world_seconds"]) == 2


def test_demo_problem_is_the_references():
    """multihost_demo.py's worker statements that draw its problem (with
    its 4 global devices): byte-equal to `problem_arrays()`."""
    path = SCRIPTS / "multihost_demo.py"
    tree = _tree("multihost_demo")
    worker = _fn(tree, "worker")
    code = _statements(path, worker, "cam = PinholeCamera", ast.unparse(next(
        n for n in ast.walk(worker) if isinstance(n, ast.Assign)
        and ast.unparse(n.targets[0]) == "host_problem")))
    consts = {ast.unparse(n.targets[0]): n.value.value for n in tree.body
              if isinstance(n, ast.Assign)
              and isinstance(n.value, ast.Constant)}
    assert consts["NPROC"] == M.NPROC
    assert consts["NPROC"] * consts["LOCAL_DEVICES"] == \
        M.REFERENCE_GLOBAL_DEVICES
    ns = {"np": np, "jnp": jnp, "PinholeCamera": J.PinholeCamera,
          "BAProblem": jba.BAProblem,
          "n_global": M.REFERENCE_GLOBAL_DEVICES}
    exec(compile(code, str(path), "exec"), ns)
    assert tuple(ns["cam"]) == (640, 480, 500.0, 320.0, 240.0)
    for a, b in zip(M.problem_arrays(), ns["host_problem"]):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    (call,) = _calls(worker, "distributed_ba")
    assert _const_kwargs(call) == {"iters": M.ITERS}


def test_demo_on_cpu_processes():
    out = subprocess.run([sys.executable, str(SCRIPTS /
                                              "multihost_demo_torch.py"),
                          "--device", "cpu"], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    (line,) = [json.loads(ln) for ln in out.stdout.splitlines()
               if ln.startswith("{")]
    assert list(line) == chip_smoke.parity_py_keys()[
        ("multihost_demo", "tail")]
    assert line["multihost_processes"] == line["global_devices"] == 2
    assert line["match"] is True
    # the reference's TPU run: 179.9174 distributed, 179.9177 single
    assert abs(line["single_process_final_cost"] - 179.9177) < 1e-2


# ---- sequence level against the JAX package --------------------------------

@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """FRAMES frames of the record's sequence on disk, through each
    package's loader."""
    root = str(tmp_path_factory.mktemp("parity_record"))
    spec = dataclasses.asdict(P.record_spec(FRAMES))
    generate_kitti_sequence(root, "98", JSpec(**spec))
    return (JKittiSequence(root, "98", image_width=P.W, image_height=P.H),
            KittiSequence(root, "98", image_width=P.W, image_height=P.H))


# The outcomes between which a lane can move when the two packages' fp32
# arithmetic rounds otherwise: the road pass's plane fit (SuccessRoad or
# one of the four depth gates on its ill-conditioned depth), and the
# primary triangle (Success or TriangleNotPlanar on a near-tie of
# `max_spanning_triangle`'s Gram-form distances).
ROUNDING_OUTCOMES = {R.Success, R.TresholdDepthGlobalGreaterMax,
                     R.TresholdDepthGlobalSmallerMin,
                     R.TresholdDepthLocalGreaterMax,
                     R.TresholdDepthLocalSmallerMin, R.TriangleNotPlanar,
                     R.SuccessRoad}


@pytest.mark.parametrize("row", ["road_veto_off", "production"])
def test_depth_rows_match_jax(disk, monkeypatch, row):
    """The two rows this record is the first to run on a sequence, with
    JAX's draws and image injected.  Counters outside ROUNDING_OUTCOMES
    equal, and the lanes that moved (half the counters' L1 difference) at
    most 0.2% of the counted lanes: phase 7's card-vs-CPU bar of 0.998,
    for the same two rounding mechanisms.

    The bar of test_depth_eval_ransac_matches_jax (one lane) does not hold
    here: with the any-far veto off, more lanes reach the road fit.
    Measured on these 12 frames: 3 lanes of 2,000-odd in each row.
    road_veto_off: frame 3, two road lanes (JAX SuccessRoad 17.140 m / the
    port's local gate with 16.497 m; JAX's global gate / the port's local).
    production: frame 1, a road depth equal to 8e-8 relative (96.0371 m)
    on the local gate's edge; frame 9, a road lane; frame 11, lane 85:
    Success in JAX, TriangleNotPlanar in the port, from the same neighbour
    points: JAX's jitted `max_spanning_triangle` (XLA's fused arithmetic)
    picks another third corner, and JAX under `jax.disable_jit()` gives
    the port's code."""
    jseq, tseq = disk
    _, over, kw = next(m for m in P.MODES if m[0] == row)
    cfg = P.record_config().replace(**over)
    inject_jax_frame_draws(monkeypatch, tseq, cfg)
    want = jeval.eval_depth_sequence(
        jseq, J.DepthEstimatorConfig(**dataclasses.asdict(cfg)),
        **P.DEPTH_KW, **kw)
    got = T.eval_depth_sequence(tseq, cfg, device="cpu", **P.DEPTH_KW, **kw)
    print(f"{row}: counters port {got['counters']}, JAX {want['counters']}")
    assert got["frames"] == want["frames"] == FRAMES - 1
    assert got["total_points"] == want["total_points"] > 1000
    g, w = np.asarray(got["counters"]), np.asarray(want["counters"])
    free = np.zeros(21, bool)
    free[[int(r) for r in ROUNDING_OUTCOMES]] = True
    np.testing.assert_array_equal(g[~free], w[~free])
    moved = np.abs(g - w).sum() / 2
    assert moved <= 0.002 * want["total_points"], moved
    for k in ("success_rate_all", "success_rate_lidar_covered"):
        assert abs(got[k] - want[k]) <= 0.002


@pytest.fixture(scope="module")
def persist_vo(disk):
    """persist_landmarks VO over the disk sequence: JAX's, the port's with
    JAX's draws injected, and the port's own (its SeedSequence draws)."""
    jseq, tseq = disk
    cfg = P.record_config()
    want = jeval.eval_vo_sequence(
        jseq, J.DepthEstimatorConfig(**dataclasses.asdict(cfg)),
        jvo.OdometryConfig(persist_landmarks=True), **P.VO_KW)
    with pytest.MonkeyPatch.context() as mp:
        inject_jax_frame_draws(mp, tseq, cfg)
        got = T.eval_vo_sequence(tseq, cfg,
                                 T.OdometryConfig(persist_landmarks=True),
                                 device="cpu", **P.VO_KW)
        reinit = T.eval_vo_sequence(tseq, cfg, T.OdometryConfig(),
                                    device="cpu", **P.VO_KW)
    return want, got, reinit


def test_persist_landmarks_matches_jax(persist_vo):
    """test_vo_eval_matches_jax's bar: RPE within 0.01 m and 0.1 deg, ATE
    under 1.15x JAX's, positions within 0.1 m; and the option is live:
    persisting changes the port's trajectory."""
    want, got, reinit = persist_vo
    print(f"persist: port ATE {got['ate_rmse']:.5f} RPE "
          f"{got['rpe_trans_rmse']:.5f} / {got['rpe_rot_rmse_deg']:.4f}; JAX "
          f"ATE {want['ate_rmse']:.5f} RPE {want['rpe_trans_rmse']:.5f} / "
          f"{want['rpe_rot_rmse_deg']:.4f}; max |pose| difference "
          f"{np.abs(got['poses'] - want['poses']).max():.2e}")
    assert got["frames"] == want["frames"] == FRAMES - 1
    assert abs(got["rpe_trans_rmse"] - want["rpe_trans_rmse"]) < 0.01
    assert abs(got["rpe_rot_rmse_deg"] - want["rpe_rot_rmse_deg"]) < 0.1
    assert got["ate_rmse"] < 1.15 * want["ate_rmse"]
    np.testing.assert_allclose(got["poses"][:, :3, 3],
                               want["poses"][:, :3, 3], atol=0.1)
    assert not np.array_equal(got["poses"], reinit["poses"])


def test_persisted_landmarks_survive_chunks_and_resume(disk, monkeypatch,
                                                      tmp_path):
    """persist_landmarks VO in chunks of 4 against one chunk, and stopped
    after frame 6, checkpointed, loaded and resumed: `lm_world` and
    `lm_id` read back from the file to the bit, and the stitched poses
    equal the uninterrupted run's to the bit."""
    _, tseq = disk
    cfg, ocfg = P.record_config(), T.OdometryConfig(persist_landmarks=True)
    kw = dict(P.VO_KW, device="cpu")
    whole = T.eval_vo_sequence(tseq, cfg, ocfg, return_carry=True, **kw)
    monkeypatch.setattr(teval, "_CHUNK_FRAMES", 4)
    chunked = T.eval_vo_sequence(tseq, cfg, ocfg, return_carry=True, **kw)
    assert np.array_equal(chunked["poses"], whole["poses"])
    for leaf in ("lm_world", "lm_id"):
        assert torch.equal(getattr(chunked["carry"][1], leaf),
                           getattr(whole["carry"][1], leaf))
    part1 = T.eval_vo_sequence(tseq, cfg, ocfg, max_frames=7,
                               return_carry=True, **kw)
    saved = part1["carry"][1]
    assert int((saved.lm_id >= 0).sum()) > 50  # landmarks are persisted
    ckpt = str(tmp_path / "persist.npz")
    save_checkpoint(ckpt, part1["carry"], {"next_frame": 7})
    fresh = (T.init_tracker(torch.zeros((P.H, P.W)), cfg.max_features,
                            levels=4),
             T.OdometryState.create(cfg, ocfg, P.VO_KW["max_tracks"],
                                    P.VO_KW["max_length"], "cpu"))
    carry, meta = load_checkpoint(ckpt, fresh)
    assert meta["next_frame"] == 7
    for leaf in ("lm_world", "lm_id"):
        a, b = getattr(carry[1], leaf), getattr(saved, leaf)
        assert a.dtype == b.dtype and torch.equal(a, b), leaf
    part2 = T.eval_vo_sequence(tseq, cfg, ocfg, start_frame=7,
                               init_carry=carry, **kw)
    stitched = np.concatenate([part1["poses"], part2["poses"]])
    assert np.array_equal(stitched, whole["poses"])


def test_replay_on_cpu_of_a_cpu_run_is_the_run(disk):
    """replay_on_cpu draws each frame's RANSAC sample as a run on the
    given device draws it; given a CPU run, it reproduces that run to the
    bit (on a card run it says where the two devices' trajectories
    part)."""
    _, tseq = disk
    cfg = P.record_config()
    vo = T.eval_vo_sequence(tseq, cfg, T.OdometryConfig(), device="cpu",
                            **P.VO_KW)
    out = P.replay_on_cpu(tseq, cfg, vo, "cpu")
    assert out["max_dR"] == out["max_dt_m"] == 0.0
    assert out["first_frame_apart"] is None
    assert out == dict(P.vo_metrics(vo), max_dR=0.0, max_dt_m=0.0,
                       first_frame_apart=None)
    assert teval._frame_rng.__name__ == "_frame_rng"  # restored


def test_replay_steps_on_cpu_of_a_cpu_run_is_the_run(disk):
    """replay_steps_on_cpu runs config 3 again one frame per chunk,
    keeping every carry, and steps each frame once on the CPU from the
    carry before it; given a CPU run, every step is the run's own to the
    bit: no pose gap, no frame apart, every lane's code and every leaf
    equal, the frame-by-frame run equal to the run; the evaluators' names
    are restored."""
    _, tseq = disk
    cfg = P.record_config()
    vo = T.eval_vo_sequence(tseq, cfg, T.OdometryConfig(), device="cpu",
                            **P.VO_KW)
    out = P.replay_steps_on_cpu(tseq, cfg, vo, "cpu")
    assert out["frames"] == FRAMES - 1 and out["equals_run"]
    assert out["max_dR"] == out["max_dt_m"] == 0.0
    assert out["pose_frames"] == out["count_frames"] == [] == (
        out["code_frames"])
    assert out["first_frame"] is None and out["int_apart"] == {}
    assert out["codes_agree"] == 1.0
    assert set(out["float_leaves_max"].values()) == {0.0}
    assert teval._CHUNK_FRAMES == 256
    assert teval._scan_vo_chunk.__name__ == "_scan_vo_chunk"
    assert teval._frame_rng.__name__ == "_frame_rng"
    assert P.tracks_pipeline.estimate_depths_pair.__name__ == (
        "estimate_depths_pair")
    # the recorders ran the eager body and gave process_frame back
    for mod in (P.tracks_pipeline, P.vo_pipeline, teval):
        assert mod.process_frame is T.process_frame
