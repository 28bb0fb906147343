"""The port's one CUDA-graph replay (`graphs.Graphed`) on the CPU, over
each of its four users: `process_frame`'s front and back segments (the
arguments `process_frame` hands them over the scene's frames), the pose
GN and the window BA.  A plain callable stands in for the CUDA graph
(`capture_plain`): "capture" runs the body once on the static tensors,
"replay" runs it again and copies its results into the outputs of the
first run, as a replay rewrites its graph's memory.  The users' own tests
take their scene, stand-in and problems from here.

Bars, for each user: the signature stays across one stream's calls and
changes with a tensor's shape, a tensor's dtype, a Python value, the
camera and the TF32 switch; the cache keeps its bound, the least recently
used signature leaving; what a replayed call returned equals the eager
body and is unchanged after three later calls.
"""

import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch import graphs, precision
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as tsyn
from mono_lidar_depth_tpu_torch.io.kitti import pad_cloud
from mono_lidar_depth_tpu_torch.obs import timing
from mono_lidar_depth_tpu_torch.tracks import pipeline
from mono_lidar_depth_tpu_torch.vo import ba, pose
from mono_lidar_depth_tpu_torch.vo.lie import so3_exp

USERS = ["front", "back", "gn", "ba"]
SPEC = dict(frames=8, image_width=384, image_height=128, focal=240.0,
            lidar_rows=20, lidar_cols=500, step=0.7)
SMALL = dict(max_points=16384, max_features=256, image_width=384,
             image_height=128, ransac_num_hypotheses=128,
             ransac_subsample_points=1024, radiusSearch_count_min=1)
BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}
CAM = T.PinholeCamera(width=384, height=128, focal_length=240.0, cx=192.0,
                      cy=64.0)
GN_KW = (10, 3.0, 6.0, 0.25)  # iters, huber_px, outlier_px, min_depth
BA_KW = (6, 2.0, 2.0, 0.5, 1e-4)  # iters, huber_px, depth_weight,
#                                   huber_depth, damping


def capture_plain(body):
    """`graphs.capture_cuda`'s stand-in on the CPU.  A replay runs no
    Python, so the body's spans record nothing there."""
    out = body()

    def replay():
        record, timing._frames.open = timing._frames.open, None
        try:
            graphs.copy_into(graphs.leaves(out), graphs.leaves(body()))
        finally:
            timing._frames.open = record

    return replay, out


def plain(eager, name, bound=graphs.BOUND):
    """`eager` graphed on the CPU with the stand-in."""
    return graphs.Graphed(eager, name, capture=capture_plain,
                          device_type="cpu", bound=bound)


@pytest.fixture(scope="module")
def scene():
    """Config, camera, transform, the primed state and 7 frames, each with
    its label image and pre-drawn RANSAC indices."""
    seq = tsyn.render_sequence(tsyn.SyntheticSpec(**SPEC), seed=6)
    cfg = T.DepthEstimatorConfig(**SMALL)
    rng = np.random.default_rng(11)
    M = cfg.max_features
    uv = np.clip(rng.uniform([4, 40], [380, 124], (M, 2))[None]
                 + np.cumsum(rng.normal(0, 1.0, (len(seq), M, 2)), 0),
                 [1, 1], [382, 126]).astype(np.float32)
    frames = []
    for k, (xyzi, count) in enumerate(seq.scans(cfg.max_points)):
        cloud, valid = pad_cloud(xyzi, count, cfg.max_points)
        # tracks come and go: every frame drops some ids and adds new ones
        ids = np.arange(M, dtype=np.int32) + 17 * k * (rng.random(M) < 0.2)
        draws = RansacDraws(
            torch.from_numpy(np.flatnonzero(valid)[
                rng.integers(0, count, 1024)]),
            torch.from_numpy(rng.integers(0, 1024, (128, 3))))
        frames.append(T.FrameInput(
            cloud=torch.from_numpy(cloud), cloud_valid=torch.from_numpy(valid),
            ids=torch.from_numpy(ids.astype(np.int32)),
            ids_valid=torch.from_numpy(rng.random(M) < 0.9),
            uv_new=torch.from_numpy(uv[k]),
            uv_prev=torch.from_numpy(uv[max(k - 1, 0)]),
            stamp=torch.tensor(seq.times[k], dtype=torch.float32),
            rng=draws,
            semantic=torch.from_numpy(seq.semantic(k).astype(np.int32))))
    cam, l2c = seq.camera, seq.lidar_to_cam("cpu")
    state = T.TrackletDepthState.create(cfg, M, 8, "cpu")
    state = T.prime_state(cfg, cam, l2c, state, frames[0].cloud,
                          frames[0].cloud_valid, frames[0].rng,
                          semantic=frames[0].semantic)
    return cfg, cam, l2c, state, frames[1:]


def assert_bits_equal(got, want, least=20):
    a, b = graphs.leaves(got), graphs.leaves(want)
    assert len(a) == len(b) >= least
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



@pytest.fixture(scope="module")
def frame_calls(scene):
    """The arguments `process_frame` hands each segment over the scene's
    frames, its segments running their eager bodies."""
    cfg, cam, l2c, state, frames = scene
    calls = {"front": [], "back": []}
    with pytest.MonkeyPatch.context() as mp:
        for name, body in (("front", pipeline._front),
                           ("back", pipeline._back)):
            mp.setattr(pipeline, f"_{name.upper()}",
                       lambda *a, n=name, b=body: calls[n].append(a) or b(*a))
        for f in frames:
            state, _, _ = T.process_frame(cfg, cam, l2c, state, f)
    timing._frames.clear()
    return calls


def _with_cfg(args, value):
    return (args[0].replace(treshold_depth_max=value), *args[1:])


class User:
    """One user of `Graphed`: its eager body, span, a stream of calls and
    `variant(args, j)`, the call with the j-th of three Python values."""

    def __init__(self, name, frame_calls):
        if name in ("front", "back"):
            self.eager = getattr(pipeline, f"_{name}")
            self.span = "assoc.replay"
            self.calls = frame_calls[name]
            self.variant = lambda a, j: _with_cfg(a, (81.0, 82.0, 83.0)[j])
            self.least = {"front": 13, "back": 9}[name]
        elif name == "gn":
            self.eager, self.span = (pose._estimate_pose_gn_eager,
                                     "vo.pose_gn.replay")
            self.calls = [(CAM, *gn_problem(s), *GN_KW)
                          for s in range(6)]
            self.variant = lambda a, j: (*a[:6], (10, 8, 6)[j], *a[7:])
            self.least = 6
        else:
            self.eager, self.span = ba._run_ba_eager, "vo.ba.replay"
            self.calls = [(CAM, ba_problem(s), *BA_KW, True)
                          for s in range(6)]
            self.variant = lambda a, j: (*a[:2], (6, 5, 4)[j], *a[3:])
            self.least = 6

    def graphed(self, bound=graphs.BOUND):
        return plain(self.eager, self.span, bound)


@pytest.fixture(params=USERS)
def user(request, frame_calls):
    timing._frames.clear()
    yield User(request.param, frame_calls)
    timing._frames.clear()


def _edit_leaf(args, edit):
    """`args` with `edit` applied to its first tensor of one dimension or
    more that is float32."""
    ts = graphs.leaves(args)
    k = next(i for i, t in enumerate(ts)
             if t.dim() and t.dtype == torch.float32)
    ts[k] = edit(ts[k])
    return graphs.rebuild(args, iter(ts))


def test_signature(user):
    g = user.graphed()
    args = user.calls[0]
    key = g.signature(args)
    assert key is not None
    # the stream's later calls: other values, the same signature
    assert all(g.signature(a) == key for a in user.calls[1:])
    changed = [
        _edit_leaf(args, lambda t: t[:-1]),
        _edit_leaf(args, lambda t: t.double()),
        user.variant(args, 1),
        tuple(a._replace(cx=a.cx + 1.0) if isinstance(a, T.PinholeCamera)
              else a for a in args),
    ]
    keys = [g.signature(a) for a in changed]
    # TF32 on, as a later caller might switch it: another capture
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        keys.append(g.signature(args))
    finally:
        precision.enforce_fp32()
    assert g.signature(args) == key
    assert None not in keys
    assert len(set(keys + [key])) == len(changed) + 2


def test_cache_bound(user):
    g = user.graphed(bound=2)
    a, b, c = (user.variant(user.calls[0], j) for j in range(3))
    for args in (a, b, a, c):  # a hit moves `a` to the most recent end
        g(*args)
    assert list(g.graphs) == [g.signature(a), g.signature(c)]


def test_returned_results_unchanged_by_later_calls(user):
    g = user.graphed()
    g(*user.calls[0])  # the warm-up, then the capture
    with timing.span("root", frame=True):
        held = g(*user.calls[1])
    assert set(timing._frames.ring[-1]) == {"root", user.span}
    assert_bits_equal(held, user.eager(*user.calls[1]), user.least)
    snapshot = graphs.clone_tree(held)
    for args in user.calls[2:5]:
        g(*args)
    assert_bits_equal(held, snapshot, user.least)
