"""The odometry step reads the card back once, for its two branch
predicates (vo/pipeline.py).  Three idioms elsewhere used to read it back
seven more times per step; these tests hold their replacements to the
same bits and keep the first idiom out of the per-frame code.

  * `x[i]` with a 0-dim index tensor `i` converts `i` to a Python int on
    the host.  core/ransac.py selects its best hypothesis with
    `index_select` on a 1-element index.
  * `torch.tensor([..], device=card)` copies a host list on every call.
    core/geometry.py builds its unit axes on the device.
  * `x[idx] = 1` copies the scalar from the host.  tracks/table.py uses
    `index_fill_`.

The comparisons with the JAX functions are at the bars of
tests/test_torch_depth.py, test_torch_geometry.py and test_torch_tracks.py.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu as J
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.core import geometry as jgeo
from mono_lidar_depth_tpu.tracks import table as jtable
from mono_lidar_depth_tpu_torch.convert import state_to_numpy
from mono_lidar_depth_tpu_torch.core import geometry as tgeo
from mono_lidar_depth_tpu_torch.tracks import table as ttable

from torch_parity import (assert_trees_equal, jax_ransac_draws, to_numpy,
                          to_port)

PKG = Path(T.__file__).resolve().parent
# the per-frame modules: those of the subpackages, and the graph replay
PER_FRAME = sorted([str(p.relative_to(PKG)) for d in
                    ("core", "tracks", "vo", "tracker", "eval", "obs", "dist")
                    for p in (PKG / d).glob("*.py")] + ["graphs.py"])


def _is_cached(fn: ast.FunctionDef) -> bool:
    return any("cache" in ast.unparse(d) for d in fn.decorator_list)


def _takes_device(fn: ast.FunctionDef) -> bool:
    a = fn.args
    return "device" in [x.arg for x in a.args + a.kwonlyargs]


def host_list_tensors(source: str) -> list[tuple[str, int]]:
    """(function, line) of every `torch.tensor(<list or tuple literal>,
    device=...)` that runs per call: inside a function that is neither
    cached nor a constructor (one that takes the `device` to build on)."""
    found = []

    def visit(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = None if _is_cached(node) or _takes_device(node) else node
            if fn is None:
                return  # nested functions of an exempt one are exempt too
        if (fn is not None and isinstance(node, ast.Call)
                and ast.unparse(node.func) in ("torch.tensor",
                                               "torch.as_tensor")
                and node.args
                and isinstance(node.args[0], (ast.List, ast.Tuple))
                and any(k.arg == "device" for k in node.keywords)):
            found.append((fn.name, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(ast.parse(source), None)
    return found


def test_the_check_finds_the_pattern():
    src = (
        "import functools, torch\n"
        "def per_call(A):\n"
        "    return torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype,\n"
        "                        device=A.device)\n"
        "def constructor(n, device):\n"
        "    return torch.tensor([0.0, 1.0], device=device)\n"
        "@functools.lru_cache(maxsize=None)\n"
        "def cached(dev):\n"
        "    return torch.tensor((1, 2), device=dev)\n"
        "def from_array(a, x):\n"
        "    return torch.tensor(a, device=x.device)\n"
        "def on_host():\n"
        "    return torch.tensor([1, 2])\n")
    assert host_list_tensors(src) == [("per_call", 3)]


@pytest.mark.parametrize("path", PER_FRAME)
def test_no_host_list_becomes_a_tensor_per_call(path):
    assert len(PER_FRAME) >= 20
    assert host_list_tensors((PKG / path).read_text()) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unit_axis(dtype):
    like = torch.zeros((4, 3), dtype=dtype)
    for axis, want in enumerate(([1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                                 [0.0, 0.0, 1.0])):
        e = tgeo._unit_axis(like, axis)
        assert e.dtype == dtype and e.device == like.device
        assert torch.equal(e, torch.tensor(want, dtype=dtype))


def _sym(rng, n):
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return a @ a.transpose(0, 2, 1)


def test_eigenvector_fallbacks_match_jax():
    """The two places that took a constant from a host list: the e_z
    fallback of a fully degenerate matrix and `_any_orthogonal`'s base
    axis on either side of |v_x| = 0.9.  Bit-exact to JAX where no
    rounding enters, else at test_torch_geometry.py's 1e-5."""
    rng = np.random.default_rng(0)
    S = _sym(rng, 16)
    S[:3] = 0.0  # every cross product of rows vanishes: e_z
    S[3:6] = np.eye(3, dtype=np.float32) * 2.0  # all-equal eigenvalues
    S[6] = np.diag([1.0, 1.0, 3.0])  # a repeated pair
    v = torch.from_numpy(S)
    got = tgeo.smallest_eigenvector_sym3x3(v).numpy()
    want = np.asarray(jgeo.smallest_eigenvector_sym3x3(jnp.asarray(S)))
    np.testing.assert_array_equal(got[:6], want[:6])
    np.testing.assert_array_equal(got[:6], np.tile([0.0, 0.0, 1.0], (6, 1)))
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=1e-5)
    evals, vecs = tgeo.sym3x3_eigh(v)
    jevals, jvecs = jgeo.sym3x3_eigh(jnp.asarray(S))
    np.testing.assert_allclose(evals.numpy(), np.asarray(jevals), atol=1e-5)
    np.testing.assert_array_equal(vecs.numpy()[:6], np.asarray(jvecs)[:6])

    units = rng.normal(size=(32, 3)).astype(np.float32)
    units[:4] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.9, 0.3, 0.316]]
    units /= np.linalg.norm(units, axis=1, keepdims=True)
    assert (np.abs(units[:, 0]) < 0.9).any()
    assert (np.abs(units[:, 0]) >= 0.9).any()
    w = tgeo._any_orthogonal(torch.from_numpy(units)).numpy()
    jw = np.asarray(jgeo._any_orthogonal(jnp.asarray(units)))
    np.testing.assert_allclose(w, jw, atol=1e-6, rtol=0)
    np.testing.assert_allclose((w * units).sum(1), 0.0, atol=1e-6)


def _plane_cloud(rng, n, tilt):
    """A tilted plane with noise under a band of clutter."""
    xy = rng.uniform(-20, 20, (n, 2))
    z = -1.7 + tilt * xy[:, 0] + 0.02 * rng.normal(size=n)
    pts = np.concatenate([xy, z[:, None]], 1)
    pts[: n // 4, 2] += rng.uniform(0.5, 3.0, n // 4)
    return pts.astype(np.float32)


def test_ransac_no_usable_hypothesis():
    """No hypothesis within the axis cone: every count is -1, the
    selection falls on hypothesis 0 and ok is False, as in JAX (the
    existing RANSAC tests all find a ground)."""
    rng = np.random.default_rng(5)
    n, S_sub, n_hyp = 1024, 256, 32
    pts = _plane_cloud(rng, n, 0.0)[:, [2, 0, 1]]  # a wall, normal along x
    valid = np.ones(n, bool)
    key = jax.random.PRNGKey(5)
    want = to_numpy(J.fit_ground_plane_ransac(
        jnp.asarray(pts), jnp.asarray(valid), key, num_hypotheses=n_hyp,
        subsample=S_sub))
    sub_idx, picks = jax_ransac_draws(key, valid, S_sub, n_hyp)
    got = state_to_numpy(T.fit_ground_plane_ransac(
        torch.from_numpy(pts), torch.from_numpy(valid), sub_idx=sub_idx,
        picks=picks, num_hypotheses=n_hyp, subsample=S_sub))
    assert not bool(got.ok) and not bool(want.ok)
    assert got.ok.shape == () and got.coeffs.shape == (4,)
    np.testing.assert_array_equal(got.inlier_mask, want.inlier_mask)
    np.testing.assert_allclose(got.coeffs, want.coeffs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("T_slots,M", [(32, 24), (16, 24)])
def test_update_tracks_seed_length(T_slots, M):
    """New tracks are seeded with length 1 then pushed to 2 by
    `index_fill_`, overflowing ones dropped: the whole table bit-exact to
    JAX over three frames with fresh ids in each."""
    rng = np.random.default_rng(T_slots)
    jt = jtable.TrackTable.create(T_slots, 5)
    tt = to_port(jt)
    for frame in range(3):
        ids = (rng.permutation(40)[:M] + 10 * frame).astype(np.int32)
        ids_valid = rng.random(M) < 0.8
        uv_prev, uv_new = (rng.uniform(0, 100, (M, 2)).astype(np.float32)
                           for _ in range(2))
        d_prev, d_new = (rng.uniform(1, 50, M).astype(np.float32)
                         for _ in range(2))
        stamp = np.float32(0.1 * frame)
        jt, jslot = jtable.update_tracks(
            jt, *map(jnp.asarray, (ids, ids_valid, uv_new, uv_prev, d_new,
                                   d_prev, stamp)))
        tt, tslot = ttable.update_tracks(
            tt, *map(torch.from_numpy, (ids, ids_valid, uv_new, uv_prev,
                                        d_new, d_prev)),
            torch.tensor(stamp))
        assert_trees_equal(state_to_numpy(tt), to_numpy(jt))
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    length = tt.length.numpy()
    assert set(np.unique(length)) <= {0, 2, 3, 4} and (length == 2).any()


@pytest.mark.parametrize("path,functions", [
    ("core/row_segmentation.py", None),
    ("core/ransac.py", ["fit_ground_plane_semantic", "_pixel_index",
                        "_ls_plane", "_orient_up"]),
    ("tracks/pipeline.py", ["_frame_ground_plane", "_front", "_back",
                            "_process_frame_eager", "process_frame",
                            "process_sequence"]),
    # the CUDA-graph replay: signature, copies in and out, replays
    ("graphs.py", None),
    ("eval/kitti_eval.py", ["_scan_depth_chunk", "_scan_vo_chunk",
                            "_chunk_frame", "_frame_rng"]),
    ("vo/pose_graph.py", ["_weight6", "_edge_residual", "_edge_lin",
                          "_affine_combine", "_scan_plan", "_scan_apply",
                          "_affine_scan", "_inv6_scaled", "_chain_factor",
                          "_chain_preconditioner", "_linearize", "_scatter",
                          "_chain_sums", "_chain_blocks", "_gn_step",
                          "optimize_pose_graph",
                          "graph_cost", "sequential_edges"]),
    ("vo/closures.py", ["_closure_pose_device", "_closure_rng"]),
    ("vo/ba.py", None),
    ("collectives.py", ["all_reduce_sum"]),
    ("dist/sharded.py", None),
    # bench_torch.py sits at the repo root, beside the package
    ("../bench_torch.py", ["frame_at", "ground_plane", "depth_frame",
                           "depth_leg", "combined_leg", "pose_gn_leg",
                           "window_ba_leg"]),
    # the endurance twin: its per-pair memo (ClosureMemo.__call__) and
    # the drift injection over every frame; its frames run inside
    # eval_vo_sequence
    ("../scripts/endurance_run_torch.py", ["__call__", "inject_drift"]),
    # the evaluation record's twin: its counted verification of a pair
    # and the drift injection; its frames run inside the sequence evaluators
    ("../scripts/make_parity_record_torch.py", ["__call__", "inject_drift"]),
    # the launch counters the twins read around each stage
    ("obs/launches.py", ["kernel_launches", "launches_since"]),
    # the depth cascade's kernel wrapper, inside the association's graph
    ("core/depth_cascade.py", None),
])
def test_no_read_back_in_the_new_per_frame_code(path, functions):
    """Region growing, the semantic plane, the graph replay, the chunk
    runners, the pose graph (but `_pcg`), BA, the collective, the sharded programs, the
    bench's leg bodies (all but its serving loop) and the endurance twin's
    per-pair and per-frame functions read nothing back to the host: no `.item()`, `.tolist()`, `.cpu()`,
    `.numpy()`, `int(...)`, `float(...)` or `bool(...)` of a tensor, and no
    Python loop over features (`for` appears only over frames, scales and
    labels)."""
    tree = ast.parse((PKG / path).read_text())
    checked = 0
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        if functions is not None and fn.name not in functions:
            continue
        checked += 1
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = ast.unparse(node.func)
                assert name.rsplit(".", 1)[-1] not in (
                    "item", "tolist", "cpu", "numpy"), (fn.name, node.lineno)
                assert name not in ("bool",), (fn.name, node.lineno)
                if name in ("int", "float"):  # enum members and config only
                    arg = ast.unparse(node.args[0])
                    assert arg.startswith(("R.", "last", "W", "H", '"', "'")), (
                        fn.name, arg)
    assert checked >= (4 if functions is None else len(functions))


def test_pcg_reads_the_card_only_for_its_exit_flag():
    """The pose graph's one host read: `bool(active)` in `_pcg`, taken
    every `_CG_CHECK` iterations; nothing else there reads back."""
    tree = ast.parse((PKG / "vo/pose_graph.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_pcg")
    reads = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = ast.unparse(node.func)
            if name.rsplit(".", 1)[-1] in ("item", "tolist", "cpu", "numpy") \
                    or name in ("bool", "int", "float"):
                reads.append(ast.unparse(node))
    assert reads == ["bool(active)"]
    src = ast.unparse(fn)
    assert "k % _CG_CHECK == 0" in src


def test_intrinsics_are_made_once_per_camera_and_device():
    """The semantic branch takes the camera matrix from a cache: building
    it from a host list on every frame would synchronize with the card."""
    from mono_lidar_depth_tpu_torch.tracks import pipeline

    cam = T.PinholeCamera(width=64, height=48, focal_length=50.0, cx=32.0,
                          cy=24.0)
    a = pipeline._intrinsics(cam, torch.device("cpu"))
    assert pipeline._intrinsics(cam, torch.device("cpu")) is a
    assert torch.equal(a, cam.intrinsics("cpu"))
    other = pipeline._intrinsics(cam._replace(cx=30.0), torch.device("cpu"))
    assert other is not a and float(other[0, 2]) == 30.0
