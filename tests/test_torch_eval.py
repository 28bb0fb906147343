"""The chunked sequence evaluators of the port (eval/kitti_eval.py).

In the port alone, on the CPU: chunking is an execution detail, so
`eval_depth_sequence` and `eval_vo_sequence` give bit-identical counters
and poses at chunk sizes 7, 9 and 256 and against the per-frame loop over
`_frame_inputs`; a run stopped after 14 frames, saved with
`save_checkpoint`, loaded and resumed at frame 14 gives bit-identical
poses.

Against the JAX package on the same files (its RANSAC draws differ):
`eval_depth_sequence` in semantic mode has no draws: every counter within
1% of the frame-feature total and the success share within 0.01; in
RANSAC mode, with JAX's draws injected, all 21 counters equal but for
one lane whose ill-conditioned float32 road-pass depth fails JAX's local
gate, and every road plane of the port on LAPACK's float64 fit;
`eval_vo_sequence`: RPE within 0.01 m / 0.1 deg, ATE within 15% of JAX's; and frame by frame with JAX's draws
injected, in semantic mode and with region growing: ids equal, poses
within 5e-3.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu as J
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.eval import kitti_eval as jeval
from mono_lidar_depth_tpu.io import synthetic_dataset as jsyn
from mono_lidar_depth_tpu.io.kitti import KittiSequence as JKittiSequence
from mono_lidar_depth_tpu.vo import pipeline as jvo
from mono_lidar_depth_tpu_torch.core.ransac import RansacDraws
from mono_lidar_depth_tpu_torch.core.result_types import DepthResultType as R
from mono_lidar_depth_tpu_torch.eval import kitti_eval as teval
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as tsyn
from mono_lidar_depth_tpu_torch.io.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from mono_lidar_depth_tpu_torch.io.kitti import KittiSequence

from torch_parity import (assert_on_f64_fit, f64_plane_fit,
                          inject_jax_frame_draws, jax_ransac_draws)

W, H = 256, 96
SPEC = dict(frames=25, image_width=W, image_height=H, focal=160.0,
            lidar_rows=16, lidar_cols=300, step=0.55)
CFG = dict(max_points=8192, max_features=256, image_width=W, image_height=H,
           radiusSearch_count_min=1, ransac_num_hypotheses=128,
           ransac_subsample_points=512)
KW = dict(max_tracks=256, max_length=6, verbose=False, device="cpu")


@pytest.fixture(scope="module")
def seq():
    return tsyn.render_sequence(tsyn.SyntheticSpec(**SPEC), seed=0)


@pytest.fixture(scope="module")
def cfg():
    return T.DepthEstimatorConfig(**CFG)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """The same sequence on disk, through each package's loader."""
    root = str(tmp_path_factory.mktemp("kitti_eval"))
    jsyn.generate_kitti_sequence(root, "95", jsyn.SyntheticSpec(**SPEC))
    return (JKittiSequence(root, "95", image_width=W, image_height=H),
            KittiSequence(root, "95", image_width=W, image_height=H))


def _with_chunk(monkeypatch, n):
    monkeypatch.setattr(teval, "_CHUNK_FRAMES", n)


# ---- chunk invariance and resume, in the port alone --------------------

def _depth_frame_loop(seq, cfg, with_sem):
    """`_frame_inputs` + `process_frame`, frame by frame."""
    cam, l2c = seq.camera, seq.lidar_to_cam("cpu")
    state = T.TrackletDepthState.create(cfg, 256, 6, "cpu")
    prime: list = []
    for frame, f in teval._frame_inputs(seq, cfg, prime=prime,
                                        use_semantics=with_sem, device="cpu"):
        if f == 1:
            state = T.prime_state(
                cfg, cam, l2c, state, prime[0][0], prime[0][1],
                teval._frame_rng(teval._frame_seed(0, 0), "cpu"),
                semantic=prime[0][2])
        state, _, _ = T.process_frame(cfg, cam, l2c, state, frame)
    return state.counters.numpy().tolist()


@pytest.mark.parametrize("plane_mode", ["ransac", "semantic"])
def test_depth_eval_chunk_invariant(seq, cfg, monkeypatch, plane_mode):
    big = T.eval_depth_sequence(seq, cfg, plane_mode=plane_mode, **KW)
    assert big["frames"] == 24 and big["total_points"] > 1000
    assert 0.1 < big["success_rate_lidar_covered"] <= 1.0
    for chunk in (7, 9):  # 25 frames -> 7/7/7/4 and 9/9/7
        _with_chunk(monkeypatch, chunk)
        small = T.eval_depth_sequence(seq, cfg, plane_mode=plane_mode, **KW)
        assert small["counters"] == big["counters"], chunk
        assert small["frames"] == 24
    assert _depth_frame_loop(seq, cfg, plane_mode == "semantic") == \
        big["counters"]


def test_depth_eval_options(seq, cfg, capsys):
    with pytest.raises(ValueError, match="plane_mode"):
        T.eval_depth_sequence(seq, cfg, plane_mode="lidar", **KW)
    short = T.eval_depth_sequence(seq, cfg, max_frames=4,
                                  **dict(KW, verbose=True))
    assert short["frames"] == 3
    report = capsys.readouterr().out
    assert report.startswith("frames: 3  feature points: ")
    assert "success (lidar-covered):" in report
    other = T.eval_depth_sequence(seq, cfg, max_frames=4, seed=1, **KW)
    assert other["total_points"] == short["total_points"]
    seq2 = tsyn.render_sequence(tsyn.SyntheticSpec(**dict(SPEC, frames=3)))
    seq2.labels = [None] * 3
    with pytest.raises(FileNotFoundError, match="semantic"):
        T.eval_depth_sequence(seq2, cfg, plane_mode="semantic", **KW)


def _vo_frame_loop(seq, cfg):
    cam, l2c = seq.camera, seq.lidar_to_cam("cpu")
    state = T.OdometryState.create(cfg, T.OdometryConfig(), 256, 6, "cpu")
    prime: list = []
    Rs, ts = [], []
    for frame, f in teval._frame_inputs(seq, cfg, prime=prime, device="cpu"):
        if f == 1:
            state = state._replace(tracklets=T.prime_state(
                cfg, cam, l2c, state.tracklets, prime[0][0], prime[0][1],
                teval._frame_rng(teval._frame_seed(0, 0), "cpu")))
        state, R_cw, t_cw, _ = T.odometry_step(cfg, T.OdometryConfig(), cam,
                                               l2c, state, frame)
        Rs.append(R_cw.numpy().astype(np.float64))
        ts.append(t_cw.numpy().astype(np.float64))
    R, t = np.stack(Rs), np.stack(ts)
    poses = np.tile(np.eye(4), (len(R), 1, 1))
    poses[:, :3, :3] = R.transpose(0, 2, 1)
    poses[:, :3, 3] = -np.einsum("fij,fj->fi", R.transpose(0, 2, 1), t)
    return poses


@pytest.fixture(scope="module")
def full_vo(seq, cfg):
    return T.eval_vo_sequence(seq, cfg, **KW)


def test_vo_eval_chunk_invariant(seq, cfg, monkeypatch, full_vo):
    assert full_vo["frames"] == 24
    assert full_vo["frame_ids"] == list(range(1, 25))
    for chunk in (7, 9):
        _with_chunk(monkeypatch, chunk)
        small = T.eval_vo_sequence(seq, cfg, **KW)
        assert small["frames"] == 24
        assert np.array_equal(small["poses"], full_vo["poses"]), chunk
        assert np.array_equal(small["diag"], full_vo["diag"]), chunk
    assert np.array_equal(_vo_frame_loop(seq, cfg), full_vo["poses"])
    assert full_vo["ate_rmse"] < 0.3 and full_vo["rpe_rot_rmse_deg"] < 0.5


def test_vo_checkpoint_resume_equivalence(seq, cfg, monkeypatch, tmp_path,
                                          full_vo):
    """Frames 0..13, the carry through the checkpoint file, resume at
    frame 14: the stitched trajectory is the uninterrupted one to the
    bit."""
    _with_chunk(monkeypatch, 7)
    part1 = T.eval_vo_sequence(seq, cfg, max_frames=14, return_carry=True,
                               **KW)
    assert "carry" not in full_vo and len(part1["carry"]) == 2
    ckpt = str(tmp_path / "vo_state.npz")
    save_checkpoint(ckpt, part1["carry"], {"next_frame": 14})
    fresh = (T.init_tracker(torch.zeros((H, W)), cfg.max_features, levels=4),
             T.OdometryState.create(cfg, T.OdometryConfig(), 256, 6, "cpu"))
    carry, meta = load_checkpoint(ckpt, fresh)
    assert meta["next_frame"] == 14
    part2 = T.eval_vo_sequence(seq, cfg, start_frame=14, init_carry=carry,
                               **KW)
    assert part1["frame_ids"][-1] + 1 == part2["frame_ids"][0] == 14
    stitched = np.concatenate([part1["poses"], part2["poses"]])
    assert np.array_equal(stitched, full_vo["poses"])
    assert part2["frame_ids"] == list(range(14, 25))
    with pytest.raises(ValueError, match="go together"):
        T.eval_vo_sequence(seq, cfg, start_frame=14, **KW)
    with pytest.raises(ValueError, match="go together"):
        T.eval_vo_sequence(seq, cfg, init_carry=carry, **KW)


def test_seeds_and_stamps_are_indexed_by_the_frame(seq, cfg):
    """`_stack_chunks` from frame 14 yields what the chunks of a run from
    frame 0 hold for those frames; another seed draws otherwise."""
    whole = list(teval._stack_chunks(seq, cfg, None, True, chunk=9))
    assert [start for _, start in whole] == [0, 9, 18]
    assert [len(a["images"]) for a, _ in whole] == [9, 9, 7]
    tail = list(teval._stack_chunks(seq, cfg, None, True, chunk=9,
                                    start_frame=14))
    assert [start for _, start in tail] == [14, 23]
    seeds = sum((a["seeds"] for a, _ in whole), [])
    assert seeds == [teval._frame_seed(0, f) for f in range(25)]
    assert len(set(seeds)) == 25 and all(0 <= s < 2 ** 64 for s in seeds)
    assert sum((a["seeds"] for a, _ in tail), []) == seeds[14:]
    stamps = np.concatenate([a["stamps"] for a, _ in whole])
    assert np.array_equal(np.concatenate([a["stamps"] for a, _ in tail]),
                          stamps[14:])
    assert np.array_equal(stamps, seq.times.astype(np.float32))
    assert np.array_equal(tail[0][0]["clouds"][0], whole[1][0]["clouds"][5])
    assert tail[0][0]["sems"].dtype == np.int32
    assert teval._frame_seed(1, 3) != teval._frame_seed(0, 3)
    a = torch.rand(4, generator=teval._frame_rng(seeds[3], "cpu"))
    b = torch.rand(4, generator=teval._frame_rng(seeds[3], "cpu"))
    assert torch.equal(a, b)
    xs = teval._chunk_xs(whole[0][0], True, True, "cpu")
    assert xs["img"].shape == (8, H, W) and xs["img"].dtype == torch.uint8
    assert xs["sem"].shape == (8, H, W) and len(xs["seed"]) == 8
    assert xs["stamp"].dtype == torch.float32


def test_measure_depth_device_time_on_the_cpu(seq, cfg, monkeypatch):
    _with_chunk(monkeypatch, 4)
    out = T.measure_depth_device_time(seq, cfg, max_frames=7, max_tracks=256,
                                      max_length=6, device="cpu")
    assert out["frames"] == 6 and out["device_s"] > 0
    assert out["device_ms_per_frame"] == pytest.approx(
        1e3 * out["device_s"] / 6)


def test_prefetch_iter():
    """Items in order from a background thread; an exception of the source
    reaches the consumer; an abandoned iterator stops its thread and
    closes the source."""
    main = threading.get_ident()
    seen = []

    def source(n, fail_at=None):
        try:
            for i in range(n):
                seen.append(threading.get_ident())
                if i == fail_at:
                    raise KeyError(i)
                yield i
        finally:
            seen.append("closed")

    assert list(teval._prefetch_iter(source(5))) == [0, 1, 2, 3, 4]
    assert seen[-1] == "closed" and main not in seen
    with pytest.raises(KeyError):
        list(teval._prefetch_iter(source(5, fail_at=2)))
    before = threading.active_count()
    del seen[:]
    it = teval._prefetch_iter(source(1000))
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before and seen[-1] == "closed"
    assert len(seen) < 20


# ---- against the JAX package ------------------------------------------

def test_depth_eval_semantic_matches_jax(disk):
    """No random draws in semantic mode: the counters are held tight."""
    jseq, tseq = disk
    kw = dict(CFG, ransac_plane_refinement_treshold=0.3)
    want = jeval.eval_depth_sequence(
        jseq, J.DepthEstimatorConfig(**kw), max_tracks=256, max_length=6,
        verbose=False, plane_mode="semantic")
    got = T.eval_depth_sequence(tseq, T.DepthEstimatorConfig(**kw),
                                plane_mode="semantic", **KW)
    assert got["frames"] == want["frames"] == 24
    total = want["total_points"]
    diff = np.abs(np.asarray(got["counters"]) - np.asarray(want["counters"]))
    print(f"semantic counters: port {got['counters']}, JAX "
          f"{want['counters']}, total {total}")
    assert diff.max() <= 0.01 * total
    assert abs(got["total_points"] - total) <= 0.01 * total
    assert abs(got["success_rate_all"] - want["success_rate_all"]) <= 0.01
    assert abs(got["success_rate_lidar_covered"]
               - want["success_rate_lidar_covered"]) <= 0.01


def test_depth_eval_ransac_matches_jax(disk, monkeypatch):
    """With the JAX package's draws injected (prime_state's PRNGKey(1234)
    and `_key_chain`'s key of each frame) and both trackers fed the same
    f32 image, every counter is equal but for one road lane.  Every road
    plane the port fits over the run (`mestimator_plane`, in float64)
    lies within fit_bound of LAPACK's float64 fit of its window, and
    within |JAX - float64| + fit_bound of the JAX package's float32 fit
    of the same window."""
    from mono_lidar_depth_tpu.core import planefit as jpf
    from mono_lidar_depth_tpu_torch.core import depth_estimator as tde

    jseq, tseq = disk
    cfg = T.DepthEstimatorConfig(**CFG)
    inject_jax_frame_draws(monkeypatch, tseq, cfg)
    want = jeval.eval_depth_sequence(
        jseq, J.DepthEstimatorConfig(**CFG), max_tracks=256, max_length=6,
        verbose=False)
    fits, real = [], tde.mestimator_plane

    def mestimator_plane(points, mask, **kw):
        out = real(points, mask, **kw)
        fits.append((points.numpy(), mask.numpy(),
                     kw["prior_dist"].numpy(), out.normal.numpy()))
        return out

    monkeypatch.setattr(tde, "mestimator_plane", mestimator_plane)
    got = T.eval_depth_sequence(tseq, cfg, **KW)
    print(f"ransac counters: port {got['counters']}, JAX {want['counters']}")
    assert got["frames"] == want["frames"] == 24
    g, w = np.asarray(got["counters"]), np.asarray(want["counters"])
    assert len(g) == 21
    # One lane moves: a local-gate failure in JAX is a SuccessRoad in the
    # port.  Before the float64 rule it was the lane of frame 17 (the
    # previous-frame feature of lane 16) whose road pass fits a plane to
    # three road neighbours, an ill-conditioned float32 fit (ROADMAP
    # Queue 3) that gives 10.2573 m in JAX, 0.168 m above the gate's upper
    # edge (10.0891 m), and gave 2.8007 m in the port, below its lower
    # edge.  Every other counter is equal.
    moved = [int(R.TresholdDepthLocalGreaterMax),
             int(R.TresholdDepthLocalSmallerMin), int(R.SuccessRoad)]
    rest = np.ones(21, bool)
    rest[moved] = False
    np.testing.assert_array_equal(g[rest], w[rest])
    assert g[moved].sum() == w[moved].sum()
    assert np.abs(g[moved] - w[moved]).sum() <= 2
    jfit = jax.jit(lambda p, m, d: jpf.mestimator_plane(p, m, prior_dist=d))
    worst = [0.0, 0.0]
    for pts, mask, dist, normal in fits:
        w64 = np.where(mask, 1.0 / np.maximum(dist.astype(np.float64),
                                              np.float32(1e-9)), 0.0)
        n64, _, kappa = f64_plane_fit(pts, w64)
        jn = np.asarray(jfit(pts, mask, dist).normal)
        errs = assert_on_f64_fit(normal, jn, n64, kappa, mask.sum(-1) >= 3)
        worst = np.maximum(worst, errs)
    print(f"road planes of {len(fits)} frames: largest |JAX - float64| "
          f"{worst[0]:.2e}, |port - float64| {worst[1]:.2e}")


def test_vo_eval_matches_jax(disk, full_vo):
    """The loader's sequence gives the in-memory sequence's poses; against
    JAX (other RANSAC draws): RPE first, then ATE.  The 1.15x ATE and 0.1 m
    position bars of the whole run hold at these 24 frames only;
    tests/test_torch_vo_replay.py holds config 3's 220 frames step by step."""
    jseq, tseq = disk
    want = jeval.eval_vo_sequence(jseq, J.DepthEstimatorConfig(**CFG),
                                  max_tracks=256, max_length=6, verbose=False)
    got = T.eval_vo_sequence(tseq, T.DepthEstimatorConfig(**CFG), **KW)
    # stamps and poses are written with 6 and 9 digits: the metrics move
    # a little, the trajectory does not
    np.testing.assert_allclose(got["poses"], full_vo["poses"], atol=1e-5)
    print(f"VO: port ATE {got['ate_rmse']:.4f} RPE {got['rpe_trans_rmse']:.4f}"
          f" / {got['rpe_rot_rmse_deg']:.4f}; JAX ATE {want['ate_rmse']:.4f} "
          f"RPE {want['rpe_trans_rmse']:.4f} / {want['rpe_rot_rmse_deg']:.4f}")
    assert got["frames"] == want["frames"] == 24
    assert abs(got["rpe_trans_rmse"] - want["rpe_trans_rmse"]) < 0.01
    assert abs(got["rpe_rot_rmse_deg"] - want["rpe_rot_rmse_deg"]) < 0.1
    # the 15% headroom of tests/test_accuracy_envelope.py
    assert got["ate_rmse"] < 1.15 * want["ate_rmse"]
    np.testing.assert_allclose(got["poses"][:, :3, 3],
                               want["poses"][:, :3, 3], atol=0.1)


@pytest.mark.parametrize("mode", ["semantic", "region_growing"])
def test_image_fed_odometry_modes_match_jax(disk, monkeypatch, mode):
    """Five processed frames through the JAX `_frame_inputs` +
    `odometry_step` and through the port's, with the JAX RANSAC draws
    injected and both trackers fed the same f32 image, as
    tests/test_torch_frames.py does for the default configuration."""
    monkeypatch.setattr(teval, "_dev_img", lambda img: torch.from_numpy(
        np.array(jeval._dev_img(jnp.asarray(img.numpy())))))
    jseq, tseq = disk
    kw = dict(CFG)
    sem = mode == "semantic"
    if sem:
        kw["ransac_plane_refinement_treshold"] = 0.3
    else:
        kw["do_use_depth_segmentation"] = True
        jseq, tseq = tsyn.VelodyneOrder(jseq), tsyn.VelodyneOrder(tseq)
    jcfg, tcfg = J.DepthEstimatorConfig(**kw), T.DepthEstimatorConfig(**kw)
    jocfg, tocfg = jvo.OdometryConfig(), T.OdometryConfig()
    jcam, jl2c = jseq.calib.camera, jseq.calib.lidar_to_cam
    tcam, tl2c = tseq.camera, tseq.lidar_to_cam("cpu")

    jprime, tprime = [], []
    jframes = jeval._frame_inputs(jseq, jcfg, max_frames=6, prime=jprime,
                                  use_semantics=sem)
    tframes = teval._frame_inputs(tseq, tcfg, max_frames=6, prime=tprime,
                                  use_semantics=sem, device="cpu")

    def draws(key, cvalid):
        return RansacDraws(*jax_ransac_draws(
            key, np.asarray(cvalid), tcfg.ransac_subsample_points,
            tcfg.ransac_num_hypotheses))

    key0 = jax.random.PRNGKey(1234)
    jstate = jvo.OdometryState.create(jcfg, jocfg, 256, 6)
    tstate = T.OdometryState.create(tcfg, tocfg, 256, 6, "cpu")
    steps = region = 0
    for (jf, jk), (tf, tk) in zip(jframes, tframes):
        if steps == 0:
            jstate = jstate._replace(tracklets=J.tracks.pipeline.prime_state(
                jcfg, jcam, jl2c, jstate.tracklets, jprime[0][0],
                jprime[0][1], key0, semantic=jprime[0][2]))
            tstate = tstate._replace(tracklets=T.prime_state(
                tcfg, tcam, tl2c, tstate.tracklets, tprime[0][0],
                tprime[0][1], draws(key0, jprime[0][1]),
                semantic=tprime[0][2]))
        assert jk == tk == steps + 1
        assert np.array_equal(tf.ids.numpy(), np.asarray(jf.ids))
        assert np.array_equal(tf.ids_valid.numpy(), np.asarray(jf.ids_valid))
        assert np.array_equal(tf.cloud.numpy(), np.asarray(jf.cloud))
        assert (tf.semantic is None) == (jf.semantic is None) == (not sem)
        if sem:
            assert np.array_equal(tf.semantic.numpy(),
                                  np.asarray(jf.semantic))
        jstate, jR, jt, jdiag = jvo.odometry_step(jcfg, jocfg, jcam, jl2c,
                                                  jstate, jf)
        tstate, tR, tt, tdiag = T.odometry_step(
            tcfg, tocfg, tcam, tl2c, tstate,
            tf._replace(rng=draws(jf.rng, jf.cloud_valid)))
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=5e-3)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=5e-3)
        assert np.abs(tdiag.numpy()[:2] - np.asarray(jdiag)[:2]).max() <= 2
        steps += 1
    assert steps == 5
    jc = np.asarray(jstate.tracklets.counters)
    tc = tstate.tracklets.counters.numpy()
    print(f"{mode}: counters port {tc.tolist()}, JAX {jc.tolist()}")
    assert np.abs(tc - jc).sum() <= 0.01 * jc.sum()
    if not sem:
        assert jc[20] > 20 and tc[20] > 20  # SuccessRegionGrowing
    assert np.array_equal(tstate.tracklets.table.track_id.numpy(),
                          np.asarray(jstate.tracklets.table.track_id))
