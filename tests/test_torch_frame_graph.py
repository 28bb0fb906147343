"""`process_frame`'s graphed path (two `graphs.Graphed` segments around the
eager neighbor gather) on the CPU.

A plain callable stands in for the CUDA graph
(`test_torch_graphs.capture_plain`), which drives everything but the
card's graph API: the copies in, the eager gather between the segments,
the clones out, the state built from both segments' results.

Bars: over the scene's frames the graphed path equals the eager body to
the bit (semantic and pre-drawn RANSAC planes, and the road pass off); a
returned state is unchanged after three later frames; a foreign state
(primed, or an older frame's) gives the eager result; region growing,
zero depths and a RANSAC generator run the eager body, and CPU tensors
run the segments' eager bodies, equal to the eager body; an `rng`
that no stage reads (a label image is given) stays out of the key, so
frames with two different generators replay under one; the first frame
of a signature records the eager stages, a replayed frame only
`assoc.frame` and `assoc.replay`.  The mechanism's own bars, over all its
users, are in `test_torch_graphs.py`.
"""

import pytest
import torch

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch import graphs
from mono_lidar_depth_tpu_torch.obs import timing
from mono_lidar_depth_tpu_torch.tracks import pipeline
from test_torch_graphs import assert_bits_equal, plain
from test_torch_graphs import scene  # noqa: F401  (fixture)

STAGES = {"assoc.frame", "assoc.ground_plane", "assoc.match_tracks",
          "assoc.rasterize", "assoc.depth_pair", "depth.segment",
          "depth.road", "assoc.update_tracks"}
REPLAYED = {"assoc.frame", "assoc.replay"}


@pytest.fixture(autouse=True)
def empty_ring():
    timing._frames.clear()
    yield
    timing._frames.clear()


@pytest.fixture
def segments(monkeypatch):
    """`process_frame`'s two segments graphed on the CPU: (front, back)."""
    front = plain(pipeline._front, "assoc.replay")
    back = plain(pipeline._back, "assoc.replay")
    monkeypatch.setattr(pipeline, "_FRONT", front)
    monkeypatch.setattr(pipeline, "_BACK", back)
    return front, back


def without_semantic(frames):
    return [f._replace(semantic=None) for f in frames]


def run(step, cfg, cam, l2c, state, frames):
    outs = []
    for f in frames:
        state, depths, codes = step(cfg, cam, l2c, state, f)
        outs.append((state, depths, codes))
    return outs


@pytest.mark.parametrize("plane", ["semantic", "ransac_draws", "none"])
def test_graphed_equals_eager_to_the_bit(scene, segments, plane):  # noqa: F811
    cfg, cam, l2c, state, frames = scene
    if plane == "ransac_draws":
        frames = without_semantic(frames)
    if plane == "none":  # the road pass off: `no_ground_plane` per frame
        cfg = cfg.replace(do_use_ransac_plane=False)
    want = run(pipeline._process_frame_eager, cfg, cam, l2c, state, frames)
    got = run(T.process_frame, cfg, cam, l2c, state, frames)
    for a, b in zip(got, want):
        assert_bits_equal(a, b)
    assert [len(s.graphs) for s in segments] == [1, 1]
    codes = torch.stack([c for _, _, c in got])
    assert (codes == 1).sum() > 100  # the cascade found depths
    # the first frame ran eagerly and captured; the others replayed, each
    # segment in `assoc.replay`, one frame of it
    assert len(timing._frames.ring) == 2 * len(frames)
    ring = list(timing._frames.ring)[-len(frames):]
    assert set(ring[0]) == STAGES - ({"depth.road"} if plane == "none"
                                     else set())
    assert all(set(r) == REPLAYED for r in ring[1:])
    assert timing.frame_spans()["assoc.replay"]["frames"] == len(frames) - 1


def test_returned_state_unchanged_by_later_frames(scene, segments):  # noqa: F811
    cfg, cam, l2c, state, frames = scene
    state, _, _ = T.process_frame(cfg, cam, l2c, state, frames[0])
    held = T.process_frame(cfg, cam, l2c, state, frames[1])
    snapshot = graphs.clone_tree(held)
    state = held[0]
    for f in frames[2:5]:
        state, _, _ = T.process_frame(cfg, cam, l2c, state, f)
    assert_bits_equal(held, snapshot)


def test_foreign_state_gives_the_eager_result(scene, segments):  # noqa: F811
    """The primed state after frames have run, then an older frame's
    state: each gives what the eager body gives from it."""
    cfg, cam, l2c, primed, frames = scene
    outs = run(T.process_frame, cfg, cam, l2c, primed, frames[:3])
    for given, frame in ((primed, frames[3]), (outs[0][0], frames[4])):
        got = T.process_frame(cfg, cam, l2c, given, frame)
        assert set(timing._frames.ring[-1]) == REPLAYED
        want = pipeline._process_frame_eager(cfg, cam, l2c, given, frame)
        assert_bits_equal(got, want)


@pytest.mark.parametrize("case", ["depth_segmentation", "zero_depths",
                                  "ransac_generator"])
def test_eager_body_where_the_segments_do_not_apply(scene, segments,  # noqa: F811
                                                     monkeypatch, case):
    cfg, cam, l2c, state, frames = scene
    f = frames[0]
    if case == "depth_segmentation":
        cfg = cfg.replace(do_use_depth_segmentation=True)
    elif case == "zero_depths":
        cfg = cfg.replace(set_all_depths_to_zero=True)
    else:  # RANSAC from a generator: no label image
        f = f._replace(semantic=None, rng=torch.Generator().manual_seed(3))
    ran = []
    monkeypatch.setattr(pipeline, "_process_frame_eager",
                        lambda *a: ran.append(a) or "eager")
    assert T.process_frame(cfg, cam, l2c, state, f) == "eager"
    assert len(ran) == 1 and ran[0][3] is state
    assert [len(s.graphs) for s in segments] == [0, 0]


def test_cpu_tensors_run_the_segments_eagerly(scene):  # noqa: F811
    """The process's own segments are for CUDA tensors: on the CPU both
    run their eager bodies, which record the eager frame's stages."""
    cfg, cam, l2c, state, frames = scene
    f = frames[0]
    assert pipeline._FRONT.signature((cfg, cam, l2c, state.table, f)) is None
    before = [len(pipeline._FRONT.graphs), len(pipeline._BACK.graphs)]
    got = T.process_frame(cfg, cam, l2c, state, f)
    assert [len(pipeline._FRONT.graphs), len(pipeline._BACK.graphs)] == before
    assert set(timing._frames.ring[-1]) == STAGES
    assert_bits_equal(got, pipeline._process_frame_eager(cfg, cam, l2c,
                                                         state, f))


def test_unread_rng_stays_out_of_the_key(scene, segments):  # noqa: F811
    """With a label image RANSAC does not run: two frames that carry two
    different generators replay under one key, equal to the eager body,
    and neither generator is drawn from."""
    cfg, cam, l2c, state, frames = scene
    front, back = segments
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    held = [g.get_state() for g in gens]
    for f, gen in zip(frames[:2], gens):
        got = T.process_frame(cfg, cam, l2c, state, f._replace(rng=gen))
        replayed = set(timing._frames.ring[-1]) == REPLAYED
        want = pipeline._process_frame_eager(cfg, cam, l2c, state, f)
        assert_bits_equal(got, want)
        state = got[0]
    assert replayed and [len(s.graphs) for s in segments] == [1, 1]
    assert all(torch.equal(g.get_state(), h) for g, h in zip(gens, held))


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
    graphs.copy_into(dst, src)
    assert sorted(map(str, calls)) == ["torch.bool", "torch.float32",
                                       "torch.int32", "torch.int64"]
    for d, s in zip(dst, src):
        assert d.dtype == s.dtype and torch.equal(d, s)
    cloned = graphs.clone_tree((src[0], (src[2], None), src[6]))
    assert cloned[1][1] is None and torch.equal(cloned[2], src[6])
    assert cloned[0].data_ptr() != src[0].data_ptr()
