"""`process_frame`'s graphed path (tracks/frame_graph.py) on the CPU.

A plain callable stands in for the CUDA graph: "capture" runs the body
once on the static tensors, "replay" runs it again and copies its results
into the outputs of the first run, as a replay rewrites its graph's
memory.  That drives everything but the card's graph API: the copies in,
the skipped copy of the state the graph returned last, graph B's copy
back, the eager gather between the graphs, the clones out.

Bars: over the scene's frames the graphed path equals the eager body to
the bit (semantic and pre-drawn RANSAC planes, and the road pass off); a
returned state is unchanged after three later frames; a foreign state
(primed, or an older frame's) is copied in and gives the eager result;
the signature changes with a shape, a dtype, `semantic`, the kind of
`rng`, `cfg`, `camera` and the TF32 switch, and stays across one
stream's frames; CPU tensors, region growing, zero depths and a RANSAC
generator run the eager body; the cache keeps its bound; a replayed
frame records only `assoc.frame` and `assoc.replay`, and the capture
none of the stages.
"""

import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as tsyn
from mono_lidar_depth_tpu_torch.io.kitti import pad_cloud
from mono_lidar_depth_tpu_torch import precision
from mono_lidar_depth_tpu_torch.obs import timing
from mono_lidar_depth_tpu_torch.tracks import frame_graph as fg
from mono_lidar_depth_tpu_torch.tracks import pipeline

SPEC = dict(frames=8, image_width=384, image_height=128, focal=240.0,
            lidar_rows=20, lidar_cols=500, step=0.7)
SMALL = dict(max_points=16384, max_features=256, image_width=384,
             image_height=128, ransac_num_hypotheses=128,
             ransac_subsample_points=1024, radiusSearch_count_min=1)
BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}
STAGES = {"assoc.frame", "assoc.ground_plane", "assoc.match_tracks",
          "assoc.rasterize", "assoc.depth_pair", "depth.segment",
          "depth.road", "assoc.update_tracks"}


def capture_plain(body, pool=None):
    """`frame_graph.capture_cuda`'s stand-in on the CPU.  A replay runs no
    Python, so the body's spans record nothing there."""
    out = body()

    def replay():
        record, timing._frames.open = timing._frames.open, None
        try:
            fg.copy_into(fg.leaves(out), fg.leaves(body()))
        finally:
            timing._frames.open = record

    return replay, out, pool


def graphs(bound=fg.BOUND):
    return fg.FrameGraphs(pipeline._process_frame_eager, pipeline._front,
                          pipeline._back, capture=capture_plain,
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


@pytest.fixture(autouse=True)
def empty_ring():
    timing._frames.clear()
    yield
    timing._frames.clear()


def without_semantic(frames):
    return [f._replace(semantic=None) for f in frames]


def run(step, cfg, cam, l2c, state, frames):
    outs = []
    for f in frames:
        state, depths, codes = step(cfg, cam, l2c, state, f)
        outs.append((state, depths, codes))
    return outs


def graphed(g):
    def step(cfg, cam, l2c, state, frame):
        graph = g.get(cfg, cam, l2c, state, frame)
        assert graph is not None
        return graph(l2c, state, frame)
    return step


def assert_bits_equal(got, want):
    a, b = fg.leaves(got), fg.leaves(want)
    assert len(a) == len(b) >= 20
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(BITS[x.element_size()]),
                           y.view(BITS[y.element_size()]))


@pytest.mark.parametrize("plane", ["semantic", "ransac_draws", "none"])
def test_graphed_equals_eager_to_the_bit(scene, plane):
    cfg, cam, l2c, state, frames = scene
    if plane == "ransac_draws":
        frames = without_semantic(frames)
    if plane == "none":  # the road pass off: `no_ground_plane` per frame
        cfg = cfg.replace(do_use_ransac_plane=False)
    g = graphs()
    want = run(pipeline._process_frame_eager, cfg, cam, l2c, state, frames)
    got = run(graphed(g), cfg, cam, l2c, state, frames)
    for k, (a, b) in enumerate(zip(got, want)):
        assert_bits_equal(a, b)
    assert len(g.graphs) == 1
    codes = torch.stack([c for _, _, c in got])
    assert (codes == 1).sum() > 100  # the cascade found depths
    # the first frame ran eagerly and captured, the capture recording
    # nothing; the others replayed
    assert len(timing._frames.ring) == 2 * len(frames)
    ring = list(timing._frames.ring)[-len(frames):]
    assert set(ring[0]) == STAGES - ({"depth.road"} if plane == "none"
                                     else set())
    assert all(set(r) == {"assoc.frame", "assoc.replay"} for r in ring[1:])
    assert timing.frame_spans()["assoc.replay"]["frames"] == len(frames) - 1


def test_returned_state_unchanged_by_later_frames(scene):
    cfg, cam, l2c, state, frames = scene
    g = graphs()
    step = graphed(g)
    state, _, _ = step(cfg, cam, l2c, state, frames[0])
    held = step(cfg, cam, l2c, state, frames[1])
    snapshot = fg.clone_tree(held)
    state = held[0]
    for f in frames[2:5]:
        state, _, _ = step(cfg, cam, l2c, state, f)
    assert_bits_equal(held, snapshot)


def test_foreign_state_is_copied_in(scene, monkeypatch):
    """The primed state after frames have run, then an older frame's
    state: each is copied in and gives what the eager body gives from it;
    the state the graph returned last is not copied."""
    cfg, cam, l2c, primed, frames = scene
    step = graphed(graphs())
    outs = run(step, cfg, cam, l2c, primed, frames[:3])
    sources = []
    real = fg.copy_into
    monkeypatch.setattr(fg, "copy_into", lambda d, s: (
        sources.extend(s), real(d, s))[1])
    last = None
    for given, frame in ((primed, frames[3]), (outs[0][0], frames[4]),
                         (None, frames[5])):
        given = last[0] if given is None else given
        sources.clear()
        last = step(cfg, cam, l2c, given, frame)
        want = pipeline._process_frame_eager(cfg, cam, l2c, given, frame)
        assert_bits_equal(last, want)
        copied = any(s is given.table.track_id for s in sources)
        assert copied == (frame is not frames[5])


def test_signature(scene):
    cfg, cam, l2c, state, frames = scene
    g = graphs()
    key = g.signature(cfg, cam, l2c, state, frames[0])
    assert key is not None
    nxt, _, _ = pipeline._process_frame_eager(cfg, cam, l2c, state,
                                              frames[0])
    assert g.signature(cfg, cam, l2c, nxt, frames[1]) == key
    f = frames[0]
    M = f.ids.shape[0]
    changed = [
        (cfg, cam, l2c, state, f._replace(ids=f.ids[:M - 1],
                                          ids_valid=f.ids_valid[:M - 1],
                                          uv_new=f.uv_new[:M - 1],
                                          uv_prev=f.uv_prev[:M - 1])),
        (cfg, cam, l2c, state, f._replace(semantic=f.semantic.to(
            torch.int64))),
        (cfg, cam, l2c, state, f._replace(semantic=None)),
        (cfg, cam, l2c, state, f._replace(rng=torch.Generator())),
        (cfg.replace(treshold_depth_max=80.0), cam, l2c, state, f),
        (cfg, cam._replace(cx=cam.cx + 1.0), l2c, state, f),
        (cfg, cam, l2c, state._replace(counters=state.counters.long()), f),
    ]
    keys = [g.signature(*args) for args in changed]
    # TF32 on, as a later caller might switch it: another capture
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        keys.append(g.signature(cfg, cam, l2c, state, f))
    finally:
        precision.enforce_fp32()
    assert g.signature(cfg, cam, l2c, state, f) == key
    assert None not in keys
    assert len(set(keys + [key])) == len(changed) + 2


def test_eager_where_the_graphs_do_not_apply(scene):
    cfg, cam, l2c, state, frames = scene
    f = frames[0]
    g = graphs()
    assert g.signature(cfg.replace(do_use_depth_segmentation=True), cam, l2c,
                       state, f) is None
    assert g.signature(cfg.replace(set_all_depths_to_zero=True), cam, l2c,
                       state, f) is None
    # RANSAC from a generator runs eagerly; with a label image it is unused
    gen = torch.Generator().manual_seed(3)
    assert g.signature(cfg, cam, l2c, state,
                       f._replace(semantic=None, rng=gen)) is None
    assert g.signature(cfg, cam, l2c, state, f._replace(rng=gen)) is not None
    # CPU tensors: the process's own cache is for CUDA tensors
    assert pipeline._GRAPHS.signature(cfg, cam, l2c, state, f) is None
    before = len(pipeline._GRAPHS.graphs)
    got = T.process_frame(cfg, cam, l2c, state, f)
    assert len(pipeline._GRAPHS.graphs) == before
    assert set(timing._frames.ring[-1]) == STAGES
    assert_bits_equal(got, pipeline._process_frame_eager(cfg, cam, l2c,
                                                         state, f))


def test_cache_bound(scene):
    cfg, cam, l2c, state, frames = scene
    g = graphs(bound=2)
    f = frames[0]
    cfgs = [cfg, cfg.replace(treshold_depth_max=80.0),
            cfg.replace(treshold_depth_max=60.0)]
    first = g.get(cfgs[0], cam, l2c, state, f)
    g.get(cfgs[1], cam, l2c, state, f)
    assert g.get(cfgs[0], cam, l2c, state, f) is first  # hit: most recent
    g.get(cfgs[2], cam, l2c, state, f)
    assert len(g.graphs) == 2
    assert [k[1] for k in g.graphs] == [cfgs[0], cfgs[2]]


def test_copy_into_one_foreach_copy_per_dtype(monkeypatch):
    calls = []
    real = torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_",
                        lambda d, s: (calls.append(d[0].dtype), real(d, s)))
    src = [torch.tensor([1.5, -2.0]), torch.tensor([3, -4], dtype=torch.int32),
           torch.tensor([True, False]), torch.tensor(7, dtype=torch.int64),
           torch.tensor(0.25), torch.tensor([False]),
           torch.arange(12, dtype=torch.float32).reshape(3, 4).t()]
    dst = [torch.zeros_like(t) for t in src]
    fg.copy_into(dst, src)
    assert sorted(map(str, calls)) == ["torch.bool", "torch.float32",
                                       "torch.int32", "torch.int64"]
    for d, s in zip(dst, src):
        assert d.dtype == s.dtype and torch.equal(d, s)
    cloned = fg.clone_tree((src[0], (src[2], None), src[6]))
    assert cloned[1][1] is None and torch.equal(cloned[2], src[6])
    assert cloned[0].data_ptr() != src[0].data_ptr()
