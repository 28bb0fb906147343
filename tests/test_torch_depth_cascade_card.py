"""The depth cascade's kernel (`core/depth_cascade.cascade_cuda`,
csrc/depth_cascade.cu) against the plain body
(`depth_estimator._depth_cascade_plain`) on a card, to the bit: depths,
codes and the debug fields.  Skipped where there is no CUDA device.  Run
on a machine with the card, from the repo root, with

    python3 -m pytest -q -s -p no:cacheprovider -o addopts= --noconftest \
        tests/test_torch_depth_cascade_card.py

(this file imports no JAX; `-s` shows the readings each test prints).

Bars:
  * (a) every cascade call of a 220-frame lap of each benchmark cell's
    configuration (`limo_bench/configs/`), the node's tracks and the
    odometry stream's tracker lanes, equals the plain body on its inputs;
    and the lap replayed through `process_frame`'s graphs (the node) and
    `odometry_step` (the odometry stream) equals the eager frames with the
    plain body, in every returned tensor;
  * (b) on lap inputs and on synthetic windows, each switch the kernel
    takes, one at a time: histogram off, first three points, planar check
    off, PCA, the three road estimators, the far veto off, both modes of
    both gates, the local gate absolute, gates off, the ray gate off, the
    road pass off, `collect_debug`; and wider synthetic windows;
  * (c) edge lanes: empty windows, 1 and 2 points, coincident points,
    exact ties in the pair ranking, road points on the ground plane
    (weights at 1 / eps), no road points, no ground plane, invalid
    features, depths on bin borders, planes at the 0 m and 100 m gates;
  * a profiled replayed frame holds the kernel exactly once.
It prints the kernel's time, its bound and the plain body's time at the
main path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

SEED = 2 ** 31 + 2207
BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def apart(got, want) -> list:
    """Indices of the tensor leaves that differ in a bit."""
    from mono_lidar_depth_tpu_torch.graphs import leaves

    a, b = leaves(got), leaves(want)
    assert len(a) == len(b) >= 3
    out = []
    for k, (x, y) in enumerate(zip(a, b)):
        bits = BITS[x.element_size()]
        if (x.dtype, x.shape) != (y.dtype, y.shape) or not torch.equal(
                x.contiguous().view(bits), y.contiguous().view(bits)):
            out.append(k)
    return out


def lanes_apart(got, want) -> torch.Tensor:
    """Lanes whose depth or code differs in a bit."""
    d = got.depths.view(torch.int32) != want.depths.view(torch.int32)
    return torch.nonzero(d | (got.codes != want.codes))[:, 0]


class Inputs:
    """The arguments of one `_depth_cascade` call, cloned."""

    def __init__(self, cfg, camera, nb1, nb2, uv, valid, coeffs, gp_ok):
        from mono_lidar_depth_tpu_torch.graphs import clone_tree

        self.cfg, self.camera = cfg, camera
        self.nb1, self.nb2, self.uv, self.valid, self.coeffs, self.gp_ok = (
            clone_tree((nb1, nb2, uv, valid, coeffs, gp_ok)))

    def run(self, cfg=None, plain=False):
        from mono_lidar_depth_tpu_torch.core import depth_estimator as de

        fn = de._depth_cascade
        fn = de._depth_cascade_plain if plain else getattr(fn, "routed", fn)
        cfg = cfg or self.cfg
        nb2 = self.nb2 if cfg.do_use_ransac_plane else None
        return fn(cfg, self.camera, self.nb1, nb2, self.uv, self.valid,
                  self.coeffs, self.gp_ok)


def compare(inp: Inputs, cfg=None) -> str:
    """'' where the kernel equals the plain body on `inp`, else what
    differs."""
    from mono_lidar_depth_tpu_torch.core import depth_cascade

    before = depth_cascade.launches
    got = inp.run(cfg)
    want = inp.run(cfg, plain=True)
    assert depth_cascade.launches == before + 1
    diff = apart(got, want)
    if not diff:
        return ""
    lanes = lanes_apart(got, want)[:6].tolist()
    rows = [(n, float(got.depths[n]), int(got.codes[n]),
             float(want.depths[n]), int(want.codes[n])) for n in lanes]
    return (f"leaves {diff} apart; lanes (n, depth, code | plain depth, code)"
            f" {rows} of {int(lanes_apart(got, want).numel())}")


# ---- the benchmark's cells


def _cell(config: str):
    import mono_lidar_depth_tpu_torch as T
    from limo_bench import run
    from limo_bench.pipelines import limo_odometry, tracklet_depth

    cfg = run.load_json(run.BENCH / "configs" / f"{config}.json")
    traffic = dict(run.load_json(run.BENCH / "traffic" / "online.json"),
                   warmup_frames=0)
    mod = tracklet_depth if cfg["pipeline"] == "tracklet_depth" \
        else limo_odometry
    return T, mod.Cell(T, cfg, traffic, SEED, torch.device("cuda"), 1.0)


def node_frame(T, c, f: int):
    j, off = c.cycle.index(f)
    ids, ok, uv_new, uv_prev = (x[j].to(c.dev) for x in c.tracks)
    cloud, valid, sem = c._upload_scan(f)
    return T.FrameInput(cloud=cloud, cloud_valid=valid, ids=ids + off,
                        ids_valid=ok, uv_new=uv_new, uv_prev=uv_prev,
                        stamp=c.stamps[f], rng=c._draws(f), semantic=sem)


class Recorder:
    """`_depth_cascade` in its module, comparing every call's kernel result
    with the plain body's on the same inputs; keeps some inputs."""

    def __init__(self, keep_every: int = 0):
        from mono_lidar_depth_tpu_torch.core import depth_estimator as de

        self.de, self.routed = de, de._depth_cascade
        self.calls, self.bad, self.kept = 0, [], []
        self.keep_every = keep_every

    def __call__(self, cfg, camera, nb1, nb2, uv, valid, coeffs, gp_ok,
                 frame=None):
        inp = Inputs(cfg, camera, nb1, nb2, uv, valid, coeffs, gp_ok)
        out = self.routed(cfg, camera, nb1, nb2, uv, valid, coeffs, gp_ok,
                          frame)
        diff = compare(inp)
        if diff:
            self.bad.append((self.calls, diff))
        if self.keep_every and self.calls % self.keep_every == 0:
            self.kept.append(inp)
        self.calls += 1
        return out

    def __enter__(self):
        self.de._depth_cascade = self
        return self

    def __exit__(self, *exc):
        self.de._depth_cascade = self.routed


@pytest.fixture(scope="module")
def node():
    _need_card()
    return _cell("kitti_hdl64_tracklet_depth")


@pytest.fixture(scope="module")
def odometry():
    _need_card()
    return _cell("kitti_hdl64_limo")


@pytest.fixture(scope="module")
def lap_inputs(node):
    """Cascade inputs kept from the node's lap (test_node_lap fills it)."""
    return []


@pytest.mark.card
def test_node_lap_inputs(node, lap_inputs):
    from mono_lidar_depth_tpu_torch.tracks import pipeline

    T, c = node
    lap = c.lap.labels.shape[0]
    state = c.state
    with Recorder(keep_every=9) as rec:
        for f in range(1, lap + 1):
            state, _, _ = pipeline._process_frame_eager(
                c.dcfg, c.cam, c.l2c, state, node_frame(T, c, f))
    lap_inputs.extend(rec.kept)
    print(f"\nnode lap: {rec.calls} cascade calls, kernel apart from the "
          f"plain body at {rec.bad[:3]}")
    assert rec.calls == lap and not rec.bad


def odometry_frames(T, c, count: int):
    """(f, FrameInput) of the odometry cell from its primed state, the
    tracker run once."""
    tr, ts = c.tr, c.ts
    for f in range(c.f, c.f + count):
        cloud, valid, sem = c._upload_scan(f)
        ts, out = T.track_frame(ts, c._upload_image(f),
                                cell_size=tr["cell_size"], patch=tr["patch"],
                                iters=tr["iters"])
        yield f, T.FrameInput(cloud=cloud, cloud_valid=valid, ids=out.ids,
                              ids_valid=out.valid, uv_new=out.uv_new,
                              uv_prev=out.uv_prev, stamp=c.stamps[f],
                              rng=c._draws(f), semantic=sem)


class EagerFrames:
    """`odometry_step`'s association run by the eager frame body."""

    def __init__(self, T):
        self.vp = T.vo.pipeline

    def __enter__(self):
        from mono_lidar_depth_tpu_torch.tracks import pipeline

        self.saved = self.vp.process_frame
        self.vp.process_frame = pipeline._process_frame_eager

    def __exit__(self, *exc):
        self.vp.process_frame = self.saved


@pytest.mark.card
def test_odometry_lap_inputs(odometry):
    T, c = odometry
    lap = c.images.shape[0]
    state = c.os
    with EagerFrames(T), Recorder() as rec:
        for _, inp in odometry_frames(T, c, lap):
            state = T.odometry_step(c.dcfg, c.ocfg, c.cam, c.l2c, state,
                                    inp)[0]
    print(f"\nodometry lap: {rec.calls} cascade calls, kernel apart from "
          f"the plain body at {rec.bad[:3]}")
    assert rec.calls >= lap and not rec.bad


class PlainBody:
    """`_depth_cascade` replaced by the plain body in its module."""

    def __enter__(self):
        from mono_lidar_depth_tpu_torch.core import depth_estimator as de

        self.de, self.routed = de, de._depth_cascade
        de._depth_cascade = de._depth_cascade_plain

    def __exit__(self, *exc):
        self.de._depth_cascade = self.routed


@pytest.mark.card
def test_node_replayed_equals_plain(node):
    """`process_frame` (its graphs, the kernel inside the back) against the
    eager frame with the plain body, over a lap from the primed state."""
    from mono_lidar_depth_tpu_torch.tracks import pipeline

    T, c = node
    sg = se = c.state
    parted = []
    for f in range(1, c.lap.labels.shape[0] + 1):
        inp = node_frame(T, c, f)
        got = T.process_frame(c.dcfg, c.cam, c.l2c, sg, inp)
        with PlainBody():
            want = pipeline._process_frame_eager(c.dcfg, c.cam, c.l2c, se,
                                                 inp)
        diff = apart(got, want)
        if diff:
            parted.append((f, diff))
        sg, se = got[0], want[0]
    print(f"\nnode replayed against the plain body: apart at {parted[:5]}")
    assert not parted


@pytest.mark.card
def test_odometry_replayed_equals_plain(odometry):
    """`odometry_step` with its graphs (the kernel in the association's
    back) against the step with eager frames and the plain body, over a
    lap from one state."""
    T, c = odometry
    sg = se = c.os
    parted = []
    for f, inp in odometry_frames(T, c, c.images.shape[0]):
        got = T.odometry_step(c.dcfg, c.ocfg, c.cam, c.l2c, sg, inp)
        with EagerFrames(T), PlainBody():
            want = T.odometry_step(c.dcfg, c.ocfg, c.cam, c.l2c, se, inp)
        diff = apart(got, want)
        if diff:
            parted.append((f, diff))
        sg, se = got[0], want[0]
    print(f"\nodometry replayed against the plain body: apart at "
          f"{parted[:5]}")
    assert not parted


# ---- synthetic windows


def synthetic(cfg, camera, N: int = 2048, seed: int = 7) -> Inputs:
    """Windows of the cell's shapes on the card: planar patches at 1-140 m
    with noise, masks of every density, ground flags, per-lane ground
    planes; then edge lanes (see the module's docstring)."""
    from mono_lidar_depth_tpu_torch.core.neighbors import NeighborSet

    rng = np.random.default_rng(seed)
    (ky1, kx1), (ky2, kx2) = cfg.primary_window, cfg.road_window
    K1, K2 = ky1 * kx1, ky2 * kx2

    def window(K):
        depth = rng.uniform(1.0, 140.0, (N, 1))
        normal = rng.normal(size=(N, 3))
        normal[:, 2] += 2.0
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        xy = rng.normal(size=(N, K, 2)) * rng.uniform(0.05, 3.0, (N, 1, 1))
        z = depth - (normal[:, None, 0] * xy[..., 0]
                     + normal[:, None, 1] * xy[..., 1]) / normal[:, None, 2]
        z = z + rng.normal(size=(N, K)) * rng.choice(
            [0.0, 1e-3, 0.05, 2.0], (N, 1))
        pts = np.stack([xy[..., 0], xy[..., 1], z], -1).astype(np.float32)
        mask = rng.random((N, K)) < rng.choice(
            [0.0, 0.02, 0.05, 0.2, 0.6, 1.0], (N, 1))
        mask &= pts[..., 2] > 0
        return pts, mask

    h = rng.uniform(1.2, 1.9, N)
    p1, m1 = window(K1)
    p2, m2 = window(K2)
    road = rng.random(N) < 0.6  # windows on the lane's ground plane y = h
    p2[road, :, 1] = (h[road, None] + rng.normal(size=(road.sum(), K2))
                      * rng.choice([0.0, 1e-3, 0.05], (road.sum(), 1)))
    flags = m2 & (rng.random((N, K2)) < rng.choice([0.0, 0.5, 0.9, 1.0],
                                                   (N, 1)))
    coeffs = np.zeros((N, 4), np.float32)
    coeffs[:, 1] = -1.0
    coeffs[:, :3] += rng.normal(size=(N, 3)) * rng.choice(
        [0.0, 1e-3], (N, 1))
    coeffs[:, 3] = h
    gp_ok = rng.random(N) < 0.8
    valid = rng.random(N) < 0.92
    uv = np.stack([rng.uniform(0, camera.width, N),
                   rng.uniform(0, camera.height, N)], -1).astype(np.float32)

    # edge lanes, from lane 0 on
    e = 0

    def lane(pts1=None, mask1=None):
        nonlocal e
        if pts1 is not None:
            p1[e] = 0.0
            m1[e] = False
            k = len(pts1)
            p1[e, :k] = pts1
            m1[e, :k] = True if mask1 is None else mask1
        e += 1
        return e - 1

    lane(np.zeros((0, 3)))  # empty window
    lane([[0.1, 0.2, 9.0]])  # one point
    lane([[0.1, 0.2, 9.0], [0.3, 0.1, 9.5]])  # two points
    lane([[0.5, 0.5, 20.0]] * 8)  # coincident points
    sq = [[x, y, 12.0] for x in (-0.5, 0.5) for y in (-0.5, 0.5)]
    lane(sq * 2)  # ties: equal diagonals, duplicated corners
    lane(sq + [[0.0, 0.0, 12.0]])
    bw = np.float32(cfg.histogram_segmentation_bin_witdh)
    for k in (10, 33, 100, 333):  # depths on bin borders
        z0 = np.float32(k) * bw
        lane([[0.1 * i, 0.07 * i * i, z0] for i in range(6)])
    for z0 in (0.0, 100.0, np.float32(cfg.treshold_depth_max)):
        n = lane([[x, y, z0] for x in (-1.0, 0.0, 1.0)
                  for y in (-1.0, 0.0, 1.0)])
        uv[n] = (camera.cx, camera.cy)  # the ray meets the plane at z0
    for n in range(e, e + 12):  # road lanes: a collinear primary fails
        p1[n] = 0.0
        m1[n] = False
        m1[n, :5] = True
        p1[n, :5] = [[0.1 * i, 1.0, 10.0] for i in range(5)]
        gp_ok[n] = True
        valid[n] = True
    n0 = e
    flags[n0] = False  # no road points
    p2[n0 + 1, :, 1] = h[n0 + 1]  # every road point on the plane: w = 1/eps
    coeffs[n0 + 1] = (0.0, -1.0, 0.0, h[n0 + 1])
    m2[n0 + 1] = True
    flags[n0 + 1] = True
    gp_ok[n0 + 2] = False  # no ground plane
    valid[n0 + 3] = False  # invalid
    flags[n0 + 4] = False
    flags[n0 + 4, :3] = m2[n0 + 4, :3] = True  # exactly three
    for n in range(n0 + 5, n0 + 12):  # flat road patches, full windows
        p2[n, :, 1] = h[n]
        m2[n] = flags[n] = True
        coeffs[n] = (0.0, -1.0, 0.0, h[n])

    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def nbset(pts, mask, flg=None):
        pts = np.where(mask[..., None], pts, np.float32(0.0))
        return NeighborSet(indices=None, mask=t(mask), points_cam=t(pts),
                           count=t(mask.sum(-1).astype(np.int32)),
                           z=t(pts[..., 2]),
                           flags=None if flg is None else t(flg & mask))

    return Inputs(cfg, camera, nbset(p1, m1), nbset(p2, m2, flags),
                  torch.from_numpy(uv).to(dev),
                  torch.from_numpy(valid).to(dev),
                  torch.from_numpy(coeffs).to(dev),
                  torch.from_numpy(gp_ok).to(dev))


VARIANTS = {
    "as_configured": {},
    "histogram_off": dict(do_use_histogram_segmentation=False),
    "first_three": dict(do_use_triangle_size_maximation=False),
    "planar_check_off": dict(do_check_triangleplanar_condition=False),
    "pca": dict(do_use_PCA=True),
    "road_least_squares": dict(plane_estimator_use_mestimator=False,
                               plane_estimator_use_leastsquares=True),
    "road_triangle": dict(plane_estimator_use_mestimator=False,
                          plane_estimator_use_triangle_maximation=True),
    "road_triangle_flatness": dict(
        plane_estimator_use_mestimator=False,
        plane_estimator_use_triangle_maximation=True,
        plane_estimator_z_x_min_relation=0.5),
    "far_veto_off": dict(road_any_far_veto=False),
    "global_adjust": dict(treshold_depth_mode=1),
    "local_adjust": dict(treshold_depth_local_mode=1),
    "local_absolute": dict(treshold_depth_local_valuetype=0,
                           treshold_depth_local_value=0.3),
    "gates_off": dict(treshold_depth_enabled=False,
                      treshold_depth_local_enabled=False,
                      do_use_cut_behind_camera=False),
    "ray_gate_off": dict(viewray_plane_orthoganality_treshold=0.0),
    "road_pass_off": dict(do_use_ransac_plane=False),
    "collect_debug": dict(collect_debug=True),
    "debug_pca_road_off": dict(collect_debug=True, do_use_PCA=True,
                               do_use_ransac_plane=False),
    # synthetic windows of 20 x 14 and 29 x 26 cells: sorts of 512 and
    # 1,024 slots, above 48 KB of shared memory a block
    "wide_windows": dict(pixelarea_search_witdh=12,
                         pixelarea_search_height=18),
}


@pytest.mark.card
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_switch_variants(node, lap_inputs, variant):
    """Each switch on lap inputs (kept by test_node_lap_inputs, or two
    frames recorded here) and on the synthetic windows with their edge
    lanes."""
    from mono_lidar_depth_tpu_torch.tracks import pipeline

    T, c = node
    if not lap_inputs:
        with Recorder(keep_every=1) as rec:
            state = c.state
            for f in (1, 2, 3):
                state, _, _ = pipeline._process_frame_eager(
                    c.dcfg, c.cam, c.l2c, state, node_frame(T, c, f))
        lap_inputs.extend(rec.kept)
    cfg = dataclasses.replace(c.dcfg, **VARIANTS[variant])
    found = {}
    for k, inp in enumerate(lap_inputs):
        diff = compare(inp, cfg)
        if diff:
            found[f"lap input {k}"] = diff
    syn = synthetic(cfg, c.cam)
    diff = compare(syn, cfg)
    if diff:
        found["synthetic"] = diff
    est = syn.run(cfg)
    hist = torch.bincount(est.codes.long(), minlength=21).tolist()
    print(f"\n{variant}: synthetic codes {hist}; apart: {found}")
    assert not found


@pytest.mark.card
def test_edge_lanes_reach_their_paths(node):
    """The synthetic set reaches the paths the edge lanes are for: the road
    fit decides lanes, some succeed, the 100 m plane passes the gate."""
    from mono_lidar_depth_tpu_torch.core.result_types import (
        DepthResultType as R)

    T, c = node
    syn = synthetic(c.dcfg, c.cam)
    est = syn.run()
    codes = est.codes.tolist()
    assert codes.count(int(R.SuccessRoad)) > 0
    assert codes.count(int(R.Success)) > 0
    assert codes[0] == int(R.RadiusSearchInsufficientPoints)
    assert codes.count(int(R.Unspecified)) > 0


@pytest.mark.card
def test_profiled_replayed_frame_holds_the_kernel_once(node):
    from torch.profiler import ProfilerActivity, profile

    T, c = node
    state = c.state
    for f in (1, 2):
        state, _, _ = T.process_frame(c.dcfg, c.cam, c.l2c, state,
                                      node_frame(T, c, f))
    inputs = [node_frame(T, c, f) for f in (3, 4, 5)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for inp in inputs:
            state, _, _ = T.process_frame(c.dcfg, c.cam, c.l2c, state, inp)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [e for e in dev if "depth_cascade_kernel" in e.name]
    ms = 1e-3 * sum(e.time_range.end - e.time_range.start for e in ours)
    print(f"\nprofiled replayed frames: {len(dev) / len(inputs):.1f} device "
          f"activities a frame, the kernel {len(ours)} times in "
          f"{len(inputs)} frames, {ms / max(len(ours), 1):.4f} ms each")
    if not dev:
        pytest.skip("the profiler returned no device records")
    assert len(ours) == len(inputs)


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.card
def test_times_at_the_main_path_shapes(node, lap_inputs):
    """Kernel and plain body on one frame pair's inputs (4,096 lanes), and
    the kernel's bound by the bytes it reads."""
    from mono_lidar_depth_tpu_torch.tracks import pipeline

    T, c = node
    with Recorder(keep_every=1) as rec:
        state = c.state
        for f in range(1, 9):
            state, _, _ = pipeline._process_frame_eager(
                c.dcfg, c.cam, c.l2c, state, node_frame(T, c, f))
    inp = rec.kept[-1]
    N, K1 = inp.nb1.mask.shape
    K2 = inp.nb2.mask.shape[1]
    kernel = _event_ms(lambda: inp.run(), 200)
    plain = _event_ms(lambda: inp.run(plain=True), 10)
    # bytes read once: uv, valid, both windows' points, depths, masks
    # (and the road flags), counts, per-lane plane and its flag; written:
    # depths and codes
    read = N * (8 + 1 + K1 * 17 + 4 + K2 * 18 + 4 + 16 + 1)
    bound = 1e3 * (read + N * 8) / HBM_BYTES_PER_S
    ok = int(inp.gp_ok.sum())
    print(f"\ntimes at N = {N}, K = {K1} / {K2} ({ok} lanes with a plane), "
          f"{torch.cuda.get_device_name(0)}: kernel {kernel:.4f} ms, bound "
          f"{bound:.4f} ms by bytes ({(read + N * 8) / 1e6:.2f} MB), plain "
          f"body {plain:.3f} ms")
    assert kernel < plain
