"""The port's distributed layer (mono_lidar_depth_tpu_torch/dist/) against
the JAX package's dist/ and against the port's single-process solvers.

The port's ranks are processes spawned by `dist.launch.run_ranks`: gloo
on the CPU, one torch thread each, every world bounded by RANK_TIMEOUT_S
so that a hang fails the test.  One world of each size runs all three
programs once (`torch_dist_workers.programs`, which imports no JAX); the
tests read its results.  JAX's programs run in this process on the
8-device virtual mesh of tests/conftest.py.

Bars:
  * association: codes and counters bit-exact against JAX's sharded
    program (JAX's RANSAC draws injected), and equal to the bit at 1, 2
    and 4 ranks; depths at the bars of tests/test_torch_depth.py
    (successes within 5e-3 relative, median under 1e-6);
  * BA: test_dist.py's bars of distributed against single-process (final
    cost rtol 1e-3, R 1e-4, t 1e-3, landmarks 1e-2), against the port's
    `run_ba` and JAX's `distributed_ba`, and test_dist.py's convergence;
  * pose graph (the drifted 220-pose loop of test_torch_pose_graph.py,
    230 edges, padded to 232 at 4 ranks and for JAX's 8-mesh, 20 GN
    iterations, 250 CG): positions within 5e-4 of the extent and
    rotations within 3e-3 rad of the port's single-process solve and of
    JAX's distributed one (the bars of test_220_pose_loop_matches_jax),
    and every rank counts the same PCG iterations;
  * a world of one rank equals group=None to the bit.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mono_lidar_depth_tpu as J
from mono_lidar_depth_tpu import dist as jdist
from mono_lidar_depth_tpu.io.kitti import make_synthetic_scan, pad_cloud
from mono_lidar_depth_tpu.vo.ba import BAProblem as JBAProblem
from mono_lidar_depth_tpu.vo.pose_graph import PoseGraph as JPoseGraph
from mono_lidar_depth_tpu_torch.dist.launch import run_ranks

import test_torch_pose_graph as tpg
import torch_dist_workers
from test_vo import _ba_problem
from torch_parity import CAMERA, R_LC, SMALL, T_LC, jax_ransac_draws

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240.0
B = 4  # frames of the association batch
BA_CAMERA = dict(width=640, height=480, focal_length=500.0, cx=320.0,
                 cy=240.0)
PG_KW = dict(gn_iters=20, cg_iters=250)


def _np_tree(tree):
    return tuple(np.array(x) for x in tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    P, M = SMALL["max_points"], SMALL["max_features"]
    frames = []
    for _ in range(B):
        n = P - 500
        cloud, valid = pad_cloud(make_synthetic_scan(rng, n), n, P)
        uv = rng.uniform([1, 1], [CAMERA["width"] - 2, CAMERA["height"] - 2],
                         (M, 2)).astype(np.float32)
        frames.append((cloud, valid, uv, rng.random(M) < 0.95))
    frames = tuple(np.stack(x) for x in zip(*frames))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    draws = [jax_ransac_draws(keys[b], frames[1][b],
                              SMALL["ransac_subsample_points"],
                              SMALL["ransac_num_hypotheses"])
             for b in range(B)]
    problem, R_gt, _, _ = _ba_problem(np.random.default_rng(1234), K=4,
                                      L=128)
    graph = tpg._loop_graph(220, np.random.default_rng(220))
    return dict(
        cfg=SMALL, camera=CAMERA, lidar_to_cam=(R_LC, T_LC), frames=frames,
        keys=keys, draws=tuple(np.stack([d[i].numpy() for d in draws])
                               for i in range(2)),
        ba=_np_tree(problem), ba_R_gt=R_gt, ba_camera=BA_CAMERA,
        ba_iters=(6, 10), graph=_np_tree(graph), pg_kw=PG_KW)


_worlds = {}


@pytest.fixture(scope="module")
def world(inputs):
    """world(n): the rank results of an n-rank CPU world, run once."""
    send = {k: v for k, v in inputs.items() if k not in ("keys", "ba_R_gt")}

    def get(n):
        if n not in _worlds:
            _worlds[n] = run_ranks(torch_dist_workers.programs, n, (send,),
                                   device="cpu", timeout=RANK_TIMEOUT_S)
        return _worlds[n]

    return get


def _jax_pad(g: JPoseGraph, multiple: int) -> JPoseGraph:
    """JAX's docstring padding: invalid identity edges at pose 0."""
    pad = -g.edge_i.shape[0] % multiple
    return g._replace(
        edge_i=jnp.concatenate([g.edge_i, jnp.zeros(pad, g.edge_i.dtype)]),
        edge_j=jnp.concatenate([g.edge_j, jnp.zeros(pad, g.edge_j.dtype)]),
        Z_R=jnp.concatenate([g.Z_R, jnp.tile(jnp.eye(3, dtype=g.Z_R.dtype),
                                             (pad, 1, 1))]),
        Z_t=jnp.concatenate([g.Z_t, jnp.zeros((pad, 3), g.Z_t.dtype)]),
        edge_weight=jnp.concatenate([g.edge_weight,
                                     jnp.zeros(pad, g.edge_weight.dtype)]),
        edge_valid=jnp.concatenate([g.edge_valid, jnp.zeros(pad, bool)]))


@pytest.fixture(scope="module")
def jax_refs(inputs):
    cfg = J.DepthEstimatorConfig(**SMALL)
    cam = J.PinholeCamera(**CAMERA)
    T = J.SE3(jnp.asarray(R_LC), jnp.asarray(T_LC))
    step = jdist.sharded_depth_association(cfg, cam, T, jdist.make_mesh(B))
    assoc = tuple(np.asarray(x) for x in step(
        *map(jnp.asarray, inputs["frames"]), inputs["keys"]))
    problem = JBAProblem(*map(jnp.asarray, inputs["ba"]))
    ba = jdist.distributed_ba(J.PinholeCamera(**BA_CAMERA),
                              jdist.make_mesh(8, landmark_parallel=8),
                              iters=6)(problem)
    graph = _jax_pad(JPoseGraph(*map(jnp.asarray, inputs["graph"])), 8)
    pg = jdist.distributed_pose_graph(jdist.make_mesh(8), **PG_KW)(graph)
    return dict(assoc=assoc, ba=(np.asarray(ba.problem.R),
                                 np.asarray(ba.problem.t),
                                 np.asarray(ba.problem.landmarks),
                                 float(ba.initial_cost),
                                 float(ba.final_cost)),
                pg=(np.asarray(pg.R), np.asarray(pg.t)))


def _assert_association(got, want, n_valid):
    """Codes and counters bit-exact; depths at test_torch_depth.py's bars;
    the counters count every valid feature of the batch."""
    (td, tc, tcnt), (jd, jc, jcnt) = got, want
    assert td.shape == jd.shape == (B, SMALL["max_features"])
    assert np.array_equal(tc, jc)
    assert np.array_equal(tcnt, jcnt)
    assert int(tcnt.sum()) == n_valid
    both = (tc == jc) & (jd > 0)
    assert both.sum() > 0
    rel = np.abs(td - jd)[both] / np.abs(jd)[both]
    assert rel.max() < 5e-3 and np.median(rel) < 1e-6


def _assert_ba_close(got, want):
    """test_dist.py's bars: (R, t, landmarks, c0, c1) tuples."""
    np.testing.assert_allclose(got[4], want[4], rtol=1e-3)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    np.testing.assert_allclose(got[2], want[2], atol=1e-2)


def _assert_pg_close(got, want, graph):
    """The bars of test_220_pose_loop_matches_jax: positions within 5e-4 of
    the extent, rotations within 3e-3 rad."""
    extent = float(np.ptp(graph[1], axis=0).max())
    dt = float(np.abs(got[1] - want[1]).max())
    dr = tpg._angle(got[0], want[0])
    print(f"positions {dt:.3e} m of {extent:.1f} m ({dt / extent:.2e}), "
          f"rotations {dr:.3e} rad")
    assert np.isfinite(got[1]).all()
    assert dt <= 5e-4 * extent and dr <= 3e-3, (dt, extent, dr)


def _gathered_ba(ranks, iters):
    """(R, t, all landmarks, c0, c1) of a world: the poses and costs of
    rank 0 (every rank's are the same bits), the landmark blocks joined."""
    R, t, _, c0, c1 = ranks[0]["ba"][iters]
    for r in ranks:
        assert np.array_equal(r["ba"][iters][0], R)
        assert np.array_equal(r["ba"][iters][1], t)
        assert r["ba"][iters][3:] == (c0, c1)
    return R, t, np.concatenate([r["ba"][iters][2] for r in ranks]), c0, c1


def test_mesh_shapes(world):
    for rank, facts in enumerate(r["mesh"] for r in world(4)):
        assert facts[1]["shape"] == (4, 1)
        assert facts[2]["shape"] == (2, 2)
        assert facts[4]["shape"] == (1, 4)
        for lp in (1, 2, 4):
            assert facts[lp]["names"] == ("frame", "landmark")
            assert facts[lp]["replicated"] == [0, 1, 2]
        assert (facts[2]["frame_rank"], facts[2]["landmark_rank"]) == (
            rank // 2, rank % 2)
        assert facts[1]["frame_block"] == [2 * rank, 2 * rank + 1]
        assert facts[2]["frame_block"] == [4 * (rank // 2) + k
                                           for k in range(4)]
        assert facts[4]["frame_block"] == list(range(8))
        assert facts[1]["landmark_block"] == [list(range(8)),
                                              list(range(8, 16))]
        assert facts[4]["landmark_block"] == [[2 * rank, 2 * rank + 1],
                                              [8 + 2 * rank, 9 + 2 * rank]]
        assert len(facts["errors"]) == 2
        assert "divisible by landmark_parallel" in facts["errors"][0]
        assert "world of 4" in facts["errors"][1]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_association_matches_jax(world, jax_refs, inputs, n):
    ranks = world(n)
    for r in ranks[1:]:
        assert np.array_equal(r["assoc"][2], ranks[0]["assoc"][2])
    got = (np.concatenate([r["assoc"][0] for r in ranks]),
           np.concatenate([r["assoc"][1] for r in ranks]),
           ranks[0]["assoc"][2])
    _assert_association(got, jax_refs["assoc"], int(inputs["frames"][3].sum()))
    one = world(1)[0]["assoc"]
    for a, b in zip(got, one):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_ba_matches_single(world, jax_refs, n):
    got = _gathered_ba(world(n), 6)
    _assert_ba_close(got, world(1)[0]["ba"][6, None])
    _assert_ba_close(got, jax_refs["ba"])


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_ba_converges(world, inputs, n):
    R, _, _, c0, c1 = _gathered_ba(world(n), 10)
    assert c1 < 0.1 * c0
    R_gt = inputs["ba_R_gt"]
    for k in range(1, 4):
        dR = R[k] @ R_gt[k].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.3


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_pose_graph_matches_single(world, jax_refs, inputs, n):
    """At 4 ranks the 230 edges are padded to 232."""
    ranks = world(n)
    R, t, counts = ranks[0]["pg"]
    assert len(counts) == PG_KW["gn_iters"]
    for r in ranks[1:]:
        assert r["pg"][2] == counts  # the same PCG exits on every rank
        assert np.array_equal(r["pg"][0], R) and np.array_equal(r["pg"][1], t)
    _assert_pg_close((R, t), world(1)[0]["pg", None], inputs["graph"])
    _assert_pg_close((R, t), jax_refs["pg"], inputs["graph"])


def test_world_of_one_equals_group_none(world):
    r = world(1)[0]
    for iters in (6, 10):
        got, want = r["ba"][iters], r["ba"][iters, None]
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    assert np.array_equal(r["pg"][0], r["pg", None][0])
    assert np.array_equal(r["pg"][1], r["pg", None][1])


def test_make_mesh_initializes_from_the_environment(monkeypatch):
    """Without a default process group `make_mesh` starts one from the
    launcher's environment with the backend asked for, and refuses a
    backend other than the running group's."""
    import torch.distributed as dist

    from mono_lidar_depth_tpu_torch.dist import make_mesh
    from mono_lidar_depth_tpu_torch.dist.launch import _free_port

    assert not dist.is_initialized()
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                     RANK="0", WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    try:
        mesh = make_mesh(device="cpu", backend="gloo")
        assert tuple(mesh.shape) == (1, 1)
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="runs gloo, not nccl"):
            make_mesh(device="cpu", backend="nccl")
    finally:
        dist.destroy_process_group()


def _graft():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import __graft_entry__
    import __graft_entry_torch__

    return __graft_entry__, __graft_entry_torch__


def test_graft_dryrun_multichip_cpu(monkeypatch):
    """The multichip dryrun at KITTI shapes (131k-point scans,
    2048 features, 1226x370, 2048 landmarks, the 4541-pose graph) over two
    gloo ranks on the CPU; without a card and without device="cpu" it
    raises instead of falling back."""
    import torch

    _, graft = _graft()
    recs = graft.dryrun_multichip(2, device="cpu")
    assert len(recs) == 2
    for r in recs[1:]:
        assert np.array_equal(r["counters"], recs[0]["counters"])
        assert r["ba_cost"] == recs[0]["ba_cost"]
        assert np.array_equal(r["t"], recs[0]["t"])
    assert int(recs[0]["counters"].sum()) == 2 * 2048
    assert recs[0]["ba_cost"][1] < recs[0]["ba_cost"][0]
    assert recs[0]["t"].shape == (4541, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.dryrun_multichip(2)


def test_graft_entry_matches_jax():
    """entry(): the same tiny step and inputs as JAX's; codes and counters
    equal, depths within 5e-3 relative (the step's 1024-point scan leaves
    every feature without a depth in both); the card by default."""
    import inspect

    from mono_lidar_depth_tpu_torch.device import default_device

    jgraft, graft = _graft()
    assert inspect.signature(graft.entry).parameters["device"].default == (
        default_device())
    jfn, jargs = jgraft.entry()
    tfn, targs = graft.entry(device="cpu")
    for a, b in zip(targs, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    (td, tc, tcnt), (jd, jc, jcnt) = tfn(*targs), jfn(*jargs)
    td, tc, jd, jc = td.numpy(), tc.numpy(), np.asarray(jd), np.asarray(jc)
    assert np.array_equal(tc, jc)
    assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert int(tcnt.sum()) == 128
    np.testing.assert_allclose(td, jd, rtol=5e-3, atol=0)
