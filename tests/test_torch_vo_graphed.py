"""The odometry solvers' graphed path (vo/graphed.py) on the CPU.

A plain callable stands in for the CUDA graph: "capture" runs the body
once on the static tensors, "replay" runs it again and copies its results
into the outputs of the first run, as a replay rewrites its graph's
memory.  That drives everything but the card's graph API: the warm-up,
the copies in, the clones out, the cache.

Bars: the pose GN from a warm start, from identity, from no initial pose
and with fewer than 6 stage-2 inliers, and `run_ba` with and without its
costs, equal the eager bodies to the bit over calls that replay; a
returned `PoseEstimate` or `BAResult` is unchanged after three later
calls; the signature changes with a shape, a dtype, `iters`, `camera`, a
Huber width and the TF32 switch, and stays across one stream's frames;
CPU tensors, and tensors on two devices, run the eager body; the cache
keeps its bound; an `odometry_step` stream with a forced retry equals the
eager stream to the bit, its retry replaying the first GN's graph and
still a second call of `vo.pipeline.estimate_pose_gn`.
"""

import pytest
import torch

import mono_lidar_depth_tpu_torch as T
import test_torch_odometry_spans as odo
from mono_lidar_depth_tpu_torch import precision
from mono_lidar_depth_tpu_torch.obs import timing
from mono_lidar_depth_tpu_torch.tracks import frame_graph as fg
from mono_lidar_depth_tpu_torch.vo import ba, graphed, pose
from mono_lidar_depth_tpu_torch.vo import pipeline as vp
from mono_lidar_depth_tpu_torch.vo.lie import so3_exp
from test_torch_odometry_spans import scene  # noqa: F401  (fixture)

CAM = T.PinholeCamera(width=384, height=128, focal_length=240.0, cx=192.0,
                      cy=64.0)
BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}
GN_KW = (10, 3.0, 6.0, 0.25)  # iters, huber_px, outlier_px, min_depth
BA_KW = (6, 2.0, 2.0, 0.5, 1e-4)  # iters, huber_px, depth_weight,
#                                   huber_depth, damping


def capture_plain(body, pool=None):
    """`frame_graph.capture_cuda`'s stand-in on the CPU."""
    out = body()

    def replay():
        fg.copy_into(fg.leaves(out), fg.leaves(body()))

    return replay, out, pool


def gn_graphs(bound=graphed.BOUND):
    return graphed.Graphed(pose._estimate_pose_gn_eager, "vo.pose_gn.replay",
                           capture=capture_plain, device_type="cpu",
                           bound=bound)


def ba_graphs():
    return graphed.Graphed(ba._run_ba_eager, "vo.ba.replay",
                           capture=capture_plain, device_type="cpu")


@pytest.fixture(autouse=True)
def empty_ring():
    timing._frames.clear()
    yield
    timing._frames.clear()


def assert_bits_equal(got, want):
    a, b = fg.leaves(got), fg.leaves(want)
    assert len(a) == len(b) >= 6
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(BITS[x.element_size()]),
                           y.view(BITS[y.element_size()]))


def gn_problem(seed, N=256, start="warm"):
    """(landmarks, pixels, valid, R_init, t_init): a moved camera, pixel
    noise and 20 gross outliers; `start` the initial pose (`few`: a warm
    start with 5 valid observations)."""
    g = torch.Generator().manual_seed(seed)
    X = (torch.rand(N, 3, generator=g) * torch.tensor([20.0, 6.0, 45.0])
         + torch.tensor([-10.0, -3.0, 5.0]))
    R = so3_exp(torch.tensor([0.01, -0.02, 0.005]))
    t = torch.tensor([0.1, -0.05, 0.8])
    p = X @ R.T + t
    uv = torch.stack([240 * p[:, 0] / p[:, 2] + 192,
                      240 * p[:, 1] / p[:, 2] + 64], 1)
    uv = uv + 0.3 * torch.randn(N, 2, generator=g)
    uv[:20] += 30.0
    valid = torch.rand(N, generator=g) < 0.95
    if start == "few":
        valid = torch.arange(N) >= N - 5
    if start == "identity":
        return X, uv, valid, torch.eye(3), torch.zeros(3)
    if start == "none":
        return X, uv, valid, None, None
    return (X, uv, valid, so3_exp(0.01 * torch.randn(3, generator=g)) @ R,
            t + 0.1 * torch.randn(3, generator=g))


def ba_problem(seed, K=5, L=256):
    g = torch.Generator().manual_seed(seed)
    lm = (torch.rand(L, 3, generator=g) * torch.tensor([20.0, 6.0, 45.0])
          + torch.tensor([-10.0, -3.0, 5.0]))
    Rs, ts, uvs, ds = [], [], [], []
    for k in range(K):
        R = so3_exp(torch.tensor([0.0, 0.01 * k, 0.0]))
        t = torch.tensor([0.0, 0.0, -1.0 * k])
        p = lm @ R.T + t
        uvs.append(torch.stack([240 * p[:, 0] / p[:, 2] + 192,
                                240 * p[:, 1] / p[:, 2] + 64], 1)
                   + 0.5 * torch.randn(L, 2, generator=g))
        ds.append(p[:, 2] + 0.05 * torch.randn(L, generator=g))
        Rs.append(R @ so3_exp(0.003 * torch.randn(3, generator=g)))
        ts.append(t + 0.05 * torch.randn(3, generator=g))
    obs_mask = torch.rand(K, L, generator=g) < 0.9
    return ba.BAProblem(
        R=torch.stack(Rs), t=torch.stack(ts),
        landmarks=lm + 0.1 * torch.randn(L, 3, generator=g),
        obs_uv=torch.stack(uvs), obs_mask=obs_mask,
        depth_prior=torch.stack(ds),
        depth_mask=obs_mask & (torch.rand(K, L, generator=g) < 0.6),
        fixed=torch.arange(K) == K - 1,
        lm_valid=torch.rand(L, generator=g) < 0.97)


@pytest.mark.parametrize("start", ["warm", "identity", "none", "few"])
def test_gn_equals_eager_to_the_bit(start):
    g = gn_graphs()
    for seed in range(4):
        args = (CAM, *gn_problem(seed, start=start), *GN_KW)
        got = g(*args)
        assert_bits_equal(got, pose._estimate_pose_gn_eager(*args))
        if start == "few":  # the stage-2 refit is skipped
            assert int(got.num_inliers) <= 5
        else:
            assert int(got.num_inliers) > 200
    assert len(g.graphs) == 1
    assert timing.frame_spans() == {}  # no frame record open: none kept


@pytest.mark.parametrize("compute_cost", [True, False])
def test_ba_equals_eager_to_the_bit(compute_cost):
    g = ba_graphs()
    for seed in range(3):
        args = (CAM, ba_problem(seed), *BA_KW, compute_cost)
        got = g(*args)
        assert_bits_equal(got, ba._run_ba_eager(*args))
        if compute_cost:
            assert float(got.final_cost) < 0.5 * float(got.initial_cost)
    assert len(g.graphs) == 1


def test_returned_results_unchanged_by_later_calls():
    gn, bag = gn_graphs(), ba_graphs()
    gn(CAM, *gn_problem(0), *GN_KW)
    bag(CAM, ba_problem(0), *BA_KW, True)
    held = (gn(CAM, *gn_problem(1), *GN_KW),
            bag(CAM, ba_problem(1), *BA_KW, True))
    snapshot = fg.clone_tree(held)
    for seed in (2, 3, 4):
        gn(CAM, *gn_problem(seed, start="identity"), *GN_KW)
        bag(CAM, ba_problem(seed), *BA_KW, True)
    assert_bits_equal(held, snapshot)


def test_signature():
    g = gn_graphs()
    X, uv, valid, R0, t0 = gn_problem(0)
    key = g.signature((CAM, X, uv, valid, R0, t0, *GN_KW))
    assert key is not None
    # another frame's values, and the retry's identity start
    for start in ("warm", "identity"):
        assert g.signature((CAM, *gn_problem(7, start=start), *GN_KW)) == key
    changed = [
        (CAM, X[:-1], uv[:-1], valid[:-1], R0, t0, *GN_KW),
        (CAM, X, uv.double(), valid, R0, t0, *GN_KW),
        (CAM, X, uv, valid, None, None, *GN_KW),
        (CAM, X, uv, valid, R0, t0, 9, *GN_KW[1:]),
        (CAM._replace(cx=CAM.cx + 1.0), X, uv, valid, R0, t0, *GN_KW),
        (CAM, X, uv, valid, R0, t0, GN_KW[0], 2.5, *GN_KW[2:]),
    ]
    keys = [g.signature(args) for args in changed]
    pb = ba_problem(0)
    bag = ba_graphs()
    ba_key = bag.signature((CAM, pb, *BA_KW, False))
    keys += [bag.signature((CAM, pb, *BA_KW, True)),
             bag.signature((CAM, pb, BA_KW[0], 2.5, *BA_KW[2:], False)),
             bag.signature((CAM, pb._replace(landmarks=pb.landmarks[:-1]),
                            *BA_KW, False))]
    assert bag.signature((CAM, ba_problem(5), *BA_KW, False)) == ba_key
    # TF32 on, as a later caller might switch it: another capture
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        keys.append(g.signature((CAM, X, uv, valid, R0, t0, *GN_KW)))
    finally:
        precision.enforce_fp32()
    assert g.signature((CAM, X, uv, valid, R0, t0, *GN_KW)) == key
    assert None not in keys
    assert len(set(keys + [key, ba_key])) == len(changed) + 6


def test_eager_where_no_graph_applies():
    X, uv, valid, R0, t0 = gn_problem(0)
    args = (CAM, X, uv, valid, R0, t0, *GN_KW)
    # CPU tensors: the process's own caches are for CUDA tensors
    assert pose._GRAPHS.signature(args) is None
    assert ba._GRAPHS.signature((CAM, ba_problem(0), *BA_KW, True)) is None
    before = (len(pose._GRAPHS.graphs), len(ba._GRAPHS.graphs))
    with timing.span("odo.step", frame=True):
        got = pose.estimate_pose_gn(*args)
        res = ba.run_ba(CAM, ba_problem(0), *BA_KW, True)
    assert (len(pose._GRAPHS.graphs), len(ba._GRAPHS.graphs)) == before
    assert set(timing._frames.ring[-1]) == {"odo.step"}
    assert_bits_equal(got, pose._estimate_pose_gn_eager(*args))
    assert_bits_equal(res, ba._run_ba_eager(CAM, ba_problem(0), *BA_KW,
                                            True))
    # tensors on two devices
    g = gn_graphs()
    assert g.signature((CAM, X.to("meta"), uv, valid, R0, t0,
                        *GN_KW)) is None


def test_cache_bound():
    g = gn_graphs(bound=2)
    problem = gn_problem(0)
    for iters in (10, 8, 10, 6):
        g(CAM, *problem, iters, *GN_KW[1:])
    assert len(g.graphs) == 2
    assert [k[1][1][6] for k in g.graphs] == [10, 6]  # least recent out


def test_odometry_stream_equals_eager_to_the_bit(scene, monkeypatch):  # noqa: F811
    """Tracker and step over the scene's frames with a retry forced at
    the third, graphed and eager: every output equal to the bit.  The
    first step captures the GN (no BA runs at the first frame), the
    second the BA; the retry replays the first GN's graph, and is still
    a second call of the pipeline's `estimate_pose_gn`."""
    want = odo.leaves(odo.run_stream(scene, retry_at=(3,)))
    timing._frames.clear()
    gn, bag = gn_graphs(), ba_graphs()
    monkeypatch.setattr(pose, "_GRAPHS", gn)
    monkeypatch.setattr(ba, "_GRAPHS", bag)
    calls = []
    seen = vp.estimate_pose_gn
    monkeypatch.setattr(vp, "estimate_pose_gn",
                        lambda *a, **k: calls.append(len(timing._frames.ring))
                        or seen(*a, **k))
    got = odo.leaves(odo.run_stream(scene, retry_at=(3,)))
    assert len(got) == len(want) > 50
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(gn.graphs) == len(bag.graphs) == 1
    steps = list(timing._frames.ring)[1::2]
    retried = ["vo.pose_retry" in r for r in steps]
    assert retried[:3] == [False, False, True]
    assert [calls.count(i) for i in range(1, 2 * len(steps), 2)] == [
        1 + r for r in retried]
    assert ["vo.pose_gn.replay" in r for r in steps] == [False, True, True,
                                                         True]
    assert ["vo.ba.replay" in r for r in steps] == [False, False, True,
                                                    True]
    assert all(r["vo.pose_gn.replay"] <= r["vo.pose_gn"] + r.get(
        "vo.pose_retry", 0.0) for r in steps[1:])
