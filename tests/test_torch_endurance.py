"""scripts/endurance_run_torch.py, the port's twin of
scripts/endurance_run.py, against the reference on the CPU.

  * The sequence: `render_sequence` of the endurance spec (a few frames of
    the 220-frame circuit, and a multi-lap spec with a 40-frame lap) against
    the JAX package's `generate_kitti_sequence` read back by its
    `KittiSequence`: images, labels and scans byte-equal, ground-truth
    poses within the `%.9e` text's 1e-8 relative, times within the
    `%.6f` text's 5e-7.  The spec and the depth configuration are the
    reference's keyword for keyword, read from its source.
  * `run()` at 32 frames with the checkpoint at 16: the record's keys are
    the reference's (read from its source) plus `port`, the resume
    deviation is exactly 0.0, and stage 2's poses equal a direct
    `eval_vo_sequence` call; with `skip_checkpoint` stage 3 is
    `{"skipped": True}`.
  * The backend leg on a short multi-lap loop (a 64-frame lap, `min_gap`
    scaled to 50) against the same chain built from the JAX package's
    functions, both verifying with JAX's PRNGKey(0) RANSAC draws:
    proposed, verified and used counts equal, ATE after the backend within
    5% of JAX's (tests/test_torch_closures.py's bar) and below the input's.
  * The drift injection equals the reference's code to the bit.
  * `main()` refuses without a card and refuses the reference's tags;
    with `--device cpu` it writes ENDURANCE_<tag>.json.
"""

import ast
import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.eval import kitti_eval as jeval
from mono_lidar_depth_tpu.io.kitti import KittiSequence as JKittiSequence
from mono_lidar_depth_tpu.io.kitti import read_velodyne
from mono_lidar_depth_tpu.io.synthetic_dataset import (
    SyntheticSpec as JSpec, generate_kitti_sequence)
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.vo import closures as tcl
from mono_lidar_depth_tpu_torch.vo.metrics import ate_rmse

from torch_parity import jax_ransac_draws

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "scripts" / "endurance_run.py"


def _load_twin():
    spec = importlib.util.spec_from_file_location(
        "endurance_run_torch", REPO / "scripts" / "endurance_run_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


E = _load_twin()


def _reference_main() -> ast.FunctionDef:
    tree = ast.parse(REFERENCE.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _reference_kwargs(callee: str) -> dict:
    """The constant keyword arguments of the reference's first call of
    `callee` in source order (its W and H read as the twin's)."""
    call = min((n for n in ast.walk(_reference_main())
                if isinstance(n, ast.Call) and ast.unparse(n.func) == callee),
               key=lambda n: (n.lineno, n.col_offset))
    out = {}
    for kw in call.keywords:
        if isinstance(kw.value, ast.Constant):
            out[kw.arg] = kw.value.value
        elif ast.unparse(kw.value) in ("W", "H"):
            out[kw.arg] = {"W": E.W, "H": E.H}[ast.unparse(kw.value)]
    return out


# ---- the sequence -------------------------------------------------------

def test_spec_and_config_are_the_references():
    assert "\nW, H = 384, 128\n" in REFERENCE.read_text()
    assert (E.W, E.H) == (384, 128)
    spec = dataclasses.asdict(E.endurance_spec(2048))
    kw = _reference_kwargs("SyntheticSpec")
    assert kw and all(spec[k] == v for k, v in kw.items()), (kw, spec)
    assert spec["frames"] == 2048 and E.laps_of(E.endurance_spec(2048)) == (
        2048 // 220)
    cfg = dataclasses.asdict(E.endurance_config())
    kw = _reference_kwargs("DepthEstimatorConfig")
    assert kw and all(cfg[k] == v for k, v in kw.items()), (kw, cfg)
    vo_kw = _reference_kwargs("eval_vo_sequence")
    assert vo_kw == dict(E.VO_KW), vo_kw


@pytest.mark.parametrize("frames,lap", [(4, 220), (50, 40)])
def test_render_matches_the_references_files(tmp_path, frames, lap):
    spec = E.endurance_spec(frames, lap)
    seq = E.render_sequence(spec)
    generate_kitti_sequence(str(tmp_path), "97",
                            JSpec(**dataclasses.asdict(spec)))
    jseq = JKittiSequence(str(tmp_path), "97", image_width=E.W,
                          image_height=E.H)
    assert len(seq) == len(jseq) == frames
    for k in range(frames):
        img, jimg = seq.image(k), jseq.image(k)
        assert img.dtype == jimg.dtype == np.uint8
        assert img.shape == jimg.shape == (E.H, E.W)
        assert img.tobytes() == jimg.tobytes(), k
        assert seq.semantic(k).tobytes() == jseq.semantic(k).tobytes(), k
        raw, n = read_velodyne(str(jseq.scan_paths[k]))
        assert n > 1000 and seq.raw_scans[k].tobytes() == raw.tobytes(), k
    np.testing.assert_allclose(seq.gt_poses, jseq.gt_poses, rtol=1e-8,
                               atol=0)
    np.testing.assert_allclose(seq.times, jseq.times, rtol=0, atol=5e-7)
    if lap < frames:  # the circuit closes: the second lap retraces the first
        np.testing.assert_allclose(seq.gt_poses[lap:, :3, :],
                                   seq.gt_poses[:frames - lap, :3, :],
                                   atol=1e-9)


# ---- run(): record, resume, stage 2 -------------------------------------

def _run(frames, checkpoint_at, **kw):
    """run() on the CPU; returns (the record, the JSON lines it printed,
    stage 2's eval_vo_sequence dict)."""
    seen = {}
    real = E.vo_stage

    def vo_stage(*args, **kwargs):
        out = real(*args, **kwargs)
        seen["vo"] = out[0]
        return out

    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(printed):
        mp.setattr(E, "vo_stage", vo_stage)
        rec = E.run(frames, checkpoint_at, "cpu", **kw)
    lines = [json.loads(ln) for ln in printed.getvalue().splitlines()]
    return rec, lines, seen["vo"]


@pytest.fixture(scope="module")
def record():
    return _run(32, 16)


def test_run_record_has_the_references_keys(record):
    rec, lines, _ = record
    chip_smoke.check_endurance_keys(rec)
    top, nested = chip_smoke.endurance_py_keys()
    assert top == ["frames", "backend", "gen_wall_s", "vo",
                   "checkpoint_resume", "pose_graph", "pose_graph_high_drift"]
    assert sorted(nested) == sorted(top[3:])
    assert [next(iter(ln)) for ln in lines] == top[3:]
    assert [json.dumps(ln[k]) for ln, k in zip(lines, top[3:])] == [
        json.dumps(rec[k]) for k in top[3:]]  # NaN where no closure is used
    assert rec["frames"] == 32 and rec["backend"] == "cpu"
    port = rec["port"]
    assert port["torch"] == torch.__version__ and port["card"].startswith(
        "cpu")
    # on the CPU every wrapper takes its plain version: no launch
    assert set(port["launches"]) == set(top[3:])
    assert all(n == 0 for stage in port["launches"].values()
               for n in stage.values())
    assert rec["pose_graph_high_drift"]["injected"] == (
        "0.05 deg/frame yaw bias + 3% scale error")


def test_resume_is_bit_identical(record):
    resume = record[0]["checkpoint_resume"]
    assert resume["max_pose_deviation"] == 0.0 and resume["equivalent"]
    assert resume["checkpoint_frame"] == 16 and resume["checkpoint_bytes"] > 0


def test_stage_2_is_eval_vo_sequence(record):
    rec, _, vo = record
    seq = E.render_sequence(E.endurance_spec(32))
    direct = T.eval_vo_sequence(seq, E.endurance_config(), device="cpu",
                                **E.VO_KW)
    np.testing.assert_array_equal(vo["poses"], direct["poses"])
    assert vo["frame_ids"] == direct["frame_ids"] == list(range(1, 32))
    assert rec["vo"]["frames"] == 31
    assert rec["vo"]["ate_rmse_m"] == round(float(direct["ate_rmse"]), 3)
    assert rec["pose_graph"]["ate_vo_m"] == rec["vo"]["ate_rmse_m"]


def test_skip_checkpoint():
    rec, lines, _ = _run(12, 6, skip_checkpoint=True)
    assert rec["checkpoint_resume"] == {"skipped": True}
    assert lines[1] == {"checkpoint_resume": {"skipped": True}}
    assert "checkpoint_resume" not in rec["port"]["launches"]
    chip_smoke.check_endurance_keys(rec)


# ---- the backend leg against the JAX package's chain ---------------------

LAP, FRAMES, MIN_GAP = 64, 88, 50


@pytest.fixture
def jax_draws(monkeypatch):
    """Every verification direction of the port draws JAX's PRNGKey(0)
    RANSAC sample of its own cloud (tests/test_torch_closures.py)."""
    cfg = E.endurance_config()

    def rng(cloud_valid):
        return RansacDraws(*jax_ransac_draws(
            jax.random.PRNGKey(0), cloud_valid.cpu().numpy(),
            cfg.ransac_subsample_points, cfg.ransac_num_hypotheses))

    monkeypatch.setattr(tcl, "_closure_rng", rng)


def _jax_leg(jseq, traj, ids, laps):
    """The reference's run_backend on the JAX package's functions."""
    jcfg = jeval.DepthEstimatorConfig(**dataclasses.asdict(
        E.endurance_config()))
    memo = {}

    def measure(fi, fj):
        if (fi, fj) not in memo:
            memo[(fi, fj)] = jeval.closure_constraint_from_frames(
                jseq, jcfg, fi, fj, max_features=jcfg.max_features)
        return memo[(fi, fj)]

    app = jeval.propose_loop_closures_appearance(
        jseq, [int(f) for f in ids], min_gap=MIN_GAP, stride=4,
        max_candidates=8 * laps)
    cands = jeval.union_closure_candidates(
        jeval.propose_loop_closures(
            traj, min_gap=MIN_GAP, radius=8.0, stride=4,
            max_candidates=16 * laps, min_candidates=2 * laps), app)
    found = []
    for (i, j) in cands:
        z = measure(ids[i], ids[j])
        if z is not None:
            found.append((i, j, *z))
    used = jeval.filter_consistent_closures(
        traj, found, remeasure=lambda a, b: measure(ids[a], ids[b]))
    opt = jeval.run_pose_graph_backend(traj, used, consistency_filter=False)
    return cands, found, used, opt


def test_backend_leg_matches_jax(tmp_path, jax_draws):
    spec = E.endurance_spec(FRAMES, LAP)
    seq = E.render_sequence(spec)
    generate_kitti_sequence(str(tmp_path), "97",
                            JSpec(**dataclasses.asdict(spec)))
    jseq = JKittiSequence(str(tmp_path), "97", image_width=E.W,
                          image_height=E.H)
    ids = list(range(1, FRAMES))  # eval_vo_sequence's frame ids
    gt = seq.gt_poses[ids]
    traj = E.inject_drift(gt)
    laps = E.laps_of(spec)
    assert laps == 1
    memo = E.ClosureMemo(seq, E.endurance_config(), "cpu")
    out, ate_in, ate_pg, opt = E.backend_leg(
        traj, "drifted", ids, gt, laps,
        E.appearance_candidates(seq, ids, laps, min_gap=MIN_GAP), memo,
        "cpu", min_gap=MIN_GAP)
    cands, found, used, jopt = _jax_leg(jseq, traj, ids, laps)
    ate_j = float(ate_rmse(jopt[:, :3, 3], gt[:, :3, 3]))
    print(f"backend leg: {out}; JAX: {len(cands)} proposed, {len(found)} "
          f"verified, {len(used)} used, ATE {ate_j:.4f} m")
    assert (out["closures_proposed"], out["closures_verified"],
            out["closures_used"]) == (len(cands), len(found), len(used))
    assert len(used) >= 2
    assert out["ate_drifted_m"] == round(ate_in, 3)
    assert out["ate_posegraph_m"] == round(ate_pg, 3)
    assert np.isfinite(ate_pg) and ate_pg < ate_in
    assert abs(ate_pg - ate_j) <= 0.05 * ate_j, (ate_pg, ate_j)
    # the memo measured each pair once, and a remeasure is the first
    # measurement itself
    assert memo.calls == len(memo.memo) >= len(cands)
    fi, fj = next(iter(memo.memo))
    first = memo.memo[(fi, fj)]
    assert memo(fi, fj) is first and memo.calls == len(memo.memo)


# ---- the drift injection ------------------------------------------------

def test_drift_injection_is_the_references():
    """The reference's stage-5 statements (from `yaw = ...` to `drifted =
    np.stack(drifted)`), run on the same poses, give the same bits."""
    main = _reference_main()
    body = [n for n in ast.walk(main) if isinstance(n, ast.stmt)]
    start = next(n for n in body if isinstance(n, ast.Assign)
                 and ast.unparse(n.targets[0]) == "yaw")
    end = next(n for n in body if isinstance(n, ast.Assign)
               and ast.unparse(n) == "drifted = np.stack(drifted)")
    lines = REFERENCE.read_text().splitlines()[start.lineno - 1:end.lineno]
    code = "\n".join(ln[4:] for ln in lines)  # main's body indentation
    rng = np.random.default_rng(3)
    poses = np.tile(np.eye(4), (40, 1, 1))
    for k in range(40):
        th = 0.05 * k
        poses[k, :3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]]
        poses[k, :3, 3] = rng.normal(size=3) + [0.0, 0.0, 0.55 * k]
    ns = {"np": np, "poses": poses}
    exec(compile(code, str(REFERENCE), "exec"), ns)
    got = E.inject_drift(poses)
    assert got.dtype == ns["drifted"].dtype and got.shape == (40, 4, 4)
    assert got.tobytes() == ns["drifted"].tobytes()


# ---- the CLI -------------------------------------------------------------

def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("argv,code", [
    ([], 1),  # cuda:0 by default, and there is no card here
    (["--device", "cuda:0", "--frames", "4"], 1),
    (["--tag", "r5", "--device", "cpu", "--frames", "4"], 2),
    (["--tag", "r4", "--device", "cpu", "--frames", "4"], 2),
])
def test_main_refuses(argv, code, capsys):
    assert not torch.cuda.is_available()
    before = {p: _digest(REPO / p) for p in ("ENDURANCE_r4.json",
                                             "ENDURANCE_r5.json")}
    assert E.main(argv) == code
    assert "endurance_run_torch:" in capsys.readouterr().err
    assert {p: _digest(REPO / p) for p in before} == before


def test_main_writes_the_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(E, "REPO", tmp_path)
    assert E.main(["--device", "cpu", "--frames", "6", "--checkpoint-at",
                   "3", "--tag", "cpu_small"]) == 0
    rec = json.loads((tmp_path / "ENDURANCE_cpu_small.json").read_text())
    chip_smoke.check_endurance_keys(rec)
    assert rec["frames"] == 6
    assert rec["checkpoint_resume"]["max_pose_deviation"] == 0.0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(json.loads(ln) for ln in out)
