"""`process_frame`'s two CUDA-graph segments (`graphs.Graphed`) against
its eager body on a card, at the benchmark cell's size
(`limo_bench/configs/kitti_hdl64_tracklet_depth.json`: KITTI's HDL-64
scans, road labels, 2,048 tracks).  Skipped where there is no CUDA
device.  Run on the chip, from the repo root, with

    python3 -m pytest -q -s -p no:cacheprovider -o addopts= --noconftest \
        <this file>

(this file imports no JAX; `-s` shows the readings each test prints).

Bars: over one 220-frame lap of the cell's scene from the primed state,
U-turn frames without a plane included, depths, codes and every state
tensor of the graphed frames equal the eager body's to the bit, and two
states held from the first frames are unchanged after the lap; a frame
under an outer stream capture runs the eager body into that graph; the
RANSAC plane from pre-drawn indices is graphed and from a generator runs
eagerly, each equal to the eager body, the generator advanced alike; the
road pass off is graphed, equal to the eager body; TF32 switched on
captures anew, equal to the eager body under it; a profiled replay shows
the graphs' kernels.
"""

import statistics
import time

import pytest
import torch

CONFIG = "kitti_hdl64_tracklet_depth"
SEED = 2 ** 31 + 1807
BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def leaves(tree):
    from mono_lidar_depth_tpu_torch import graphs

    return graphs.leaves(tree)


def cached():
    """The number of signatures each segment holds: (front, back)."""
    from mono_lidar_depth_tpu_torch.tracks import pipeline

    return len(pipeline._FRONT.graphs), len(pipeline._BACK.graphs)


def apart(got, want):
    """Indices of the tensor leaves that differ in a bit."""
    a, b = leaves(got), leaves(want)
    assert len(a) == len(b) >= 20
    out = []
    for k, (x, y) in enumerate(zip(a, b)):
        bits = BITS[x.element_size()]
        if (x.dtype, x.shape) != (y.dtype, y.shape) or not torch.equal(
                x.view(bits), y.view(bits)):
            out.append(k)
    return out


class Scene:
    """The cell's lap, tracks and primed state (`limo_bench`'s own
    set-up), and its frames as the benchmark hands them over."""

    def __init__(self, device, cfg=None, traffic=None):
        import mono_lidar_depth_tpu_torch as T
        from limo_bench import run
        from limo_bench.pipelines import tracklet_depth

        cfg = cfg or run.load_json(run.BENCH / "configs" / f"{CONFIG}.json")
        traffic = dict(traffic or run.load_json(
            run.BENCH / "traffic" / "online.json"), warmup_frames=0)
        self.T = T
        self.cell = tracklet_depth.Cell(T, cfg, traffic, SEED, device, 1.0)
        self.lap = self.cell.lap.labels.shape[0]
        self.primed = self.cell.state

    def frame(self, f: int):
        c = self.cell
        j, off = c.cycle.index(f)
        ids, ok, uv_new, uv_prev = (x[j].to(c.dev) for x in c.tracks)
        cloud, valid, sem = c._upload_scan(f)
        return self.T.FrameInput(
            cloud=cloud, cloud_valid=valid, ids=ids + off, ids_valid=ok,
            uv_new=uv_new, uv_prev=uv_prev, stamp=c.stamps[f],
            rng=c._draws(f), semantic=sem)

    def args(self, cfg=None):
        c = self.cell
        return cfg or c.dcfg, c.cam, c.l2c


@pytest.fixture(scope="module")
def scene():
    _need_card()
    return Scene(torch.device("cuda"))


def eager():
    from mono_lidar_depth_tpu_torch.tracks import pipeline

    return pipeline._process_frame_eager


def side_by_side(scene, frames, cfg=None, edit=lambda f: f, state=None):
    """The graphed and the eager path from one state over `frames`: the
    frames at which they part, with the leaves apart and whether the eager
    body parts from itself there."""
    T, (cfg, cam, l2c) = scene.T, scene.args(cfg)
    sg = se = state or scene.primed
    parted, outs = [], []
    for f in frames:
        inp = edit(scene.frame(f))
        got = T.process_frame(cfg, cam, l2c, sg, inp)
        want = eager()(cfg, cam, l2c, se, inp)
        diff = apart(got, want)
        if diff:
            again = eager()(cfg, cam, l2c, se, inp)
            parted.append((f, diff, apart(again, want)))
        outs.append((got, want))
        sg, se = got[0], want[0]
    return parted, outs


@pytest.mark.card
def test_graphed_equals_eager_over_a_lap(scene):
    from mono_lidar_depth_tpu_torch.obs import timing

    timing._frames.clear()
    before = cached()
    frames = range(1, scene.lap + 1)
    parted, outs = side_by_side(scene, frames)
    no_plane = sum(int(not bool(got[0].gp_last.ok)) for got, _ in outs)
    print(f"\nlap: {len(frames)} frames from the primed state, {no_plane} "
          f"without a plane; graphed apart from eager at {parted} "
          f"(frame, leaves apart, leaves where eager parts from itself)")
    assert not parted
    assert 0 < no_plane < len(frames)
    # what the first two frames returned, held through the lap
    assert [apart(*outs[k]) for k in (0, 1)] == [[], []]
    assert cached() == (before[0] + 1, before[1] + 1)
    spans = timing.frame_spans()
    assert spans["assoc.replay"]["frames"] == len(frames) - 1
    assert spans["assoc.frame"]["frames"] == 2 * len(frames)


@pytest.mark.card
def test_host_ms_of_a_replay(scene):
    """Host ms of `process_frame` per replayed frame, the device left to
    run (no synchronize inside the timed call), and the frame's whole
    time with its read-back."""
    T, (cfg, cam, l2c) = scene.T, scene.args()
    state = scene.primed
    host, whole = [], []
    for f in range(1, 61):
        inp = scene.frame(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, depths, codes = T.process_frame(cfg, cam, l2c, state, inp)
        t1 = time.perf_counter()
        torch.stack([depths, codes.to(depths.dtype)]).cpu()
        t2 = time.perf_counter()
        if f > 10:
            host.append(1e3 * (t1 - t0))
            whole.append(1e3 * (t2 - t0))
    print(f"\nreplay: host ms median {statistics.median(host):.4f} "
          f"(min {min(host):.4f}, max {max(host):.4f}), with the read-back "
          f"median {statistics.median(whole):.4f} ms over {len(host)} "
          f"frames")
    assert statistics.median(host) < statistics.median(whole)


@pytest.mark.card
def test_eager_under_an_outer_capture(scene):
    T, (cfg, cam, l2c) = scene.T, scene.args()
    inp = scene.frame(3)
    want = eager()(cfg, cam, l2c, scene.primed, inp)
    before = cached()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        got = T.process_frame(cfg, cam, l2c, scene.primed, inp)
    assert cached() == before
    outer.replay()
    torch.cuda.synchronize()
    assert apart(got, want) == []


@pytest.mark.card
def test_ransac_draws_graphed_generator_eager(scene):
    """The pre-drawn RANSAC frame keys a front of its own; its back reads
    what the semantic frame's back reads, and may share its graph."""
    no_labels = lambda f: f._replace(semantic=None)  # noqa: E731
    before = cached()
    parted, _ = side_by_side(scene, range(1, 9), edit=no_labels)
    assert not parted, parted
    drawn = cached()
    assert drawn[0] == before[0] + 1 and drawn[1] <= before[1] + 1

    T, (cfg, cam, l2c) = scene.T, scene.args()
    gens = [torch.Generator(device="cuda").manual_seed(5) for _ in range(2)]
    state = scene.primed
    for f in range(1, 4):
        inp = scene.frame(f)._replace(semantic=None)
        got = T.process_frame(cfg, cam, l2c, state, inp._replace(rng=gens[0]))
        want = eager()(cfg, cam, l2c, state, inp._replace(rng=gens[1]))
        assert apart(got, want) == []
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
        state = got[0]
    assert cached() == drawn


@pytest.mark.card
def test_tf32_switched_on_captures_anew(scene):
    """A caller that switches TF32 on (the benchmark's control does) gets
    graphs captured under it, equal to the eager body under it."""
    from mono_lidar_depth_tpu_torch import precision

    before = cached()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        parted, _ = side_by_side(scene, range(1, 5))
    finally:
        precision.enforce_fp32()
    assert not parted, parted
    assert cached() == (before[0] + 1, before[1] + 1)


@pytest.mark.card
def test_road_pass_off_graphed(scene):
    cfg = scene.args()[0].replace(do_use_ransac_plane=False)
    parted, _ = side_by_side(scene, range(1, 6), cfg=cfg)
    assert not parted, parted


@pytest.mark.card
def test_profiled_replay_shows_the_graphs_kernels(scene):
    """Kernels per frame that the profiler sees: eager frames, then frames
    replaying graphs that were captured before the profiler started."""
    from torch.profiler import ProfilerActivity, profile

    T, (cfg, cam, l2c) = scene.T, scene.args()
    counts = {}
    for side, step in (("eager", eager()), ("replay", T.process_frame)):
        state = scene.primed
        state, _, _ = step(cfg, cam, l2c, state, scene.frame(1))
        state, _, _ = step(cfg, cam, l2c, state, scene.frame(2))
        inputs = [scene.frame(f) for f in range(3, 6)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for inp in inputs:
                state, _, _ = step(cfg, cam, l2c, state, inp)
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        counts[side] = (len(dev) / len(inputs),
                        1e-3 * sum(e.time_range.end - e.time_range.start
                                   for e in dev) / len(inputs))
        host = {e.name for e in prof.events()}
        counts[side + "_graph_launch"] = "cudaGraphLaunch" in host
    print(f"\nprofiled frames: {counts} (device activities per frame, their "
          f"device ms per frame)")
    assert counts["replay_graph_launch"]
    assert counts["replay"][0] >= 0.9 * counts["eager"][0]
