"""The port's host-side modules against the JAX package's: the KITTI
loader (io/kitti.py, io/native.py) on the committed real-format fixture
and on a written synthetic sequence, field by field; the track records
(io/messages.py); the statistics report (obs/stats.py) and the stage timer
(obs/timing.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.io import kitti as jkitti
from mono_lidar_depth_tpu.io import messages as jmsg
from mono_lidar_depth_tpu.io import native as jnative
from mono_lidar_depth_tpu.io import synthetic_dataset as jsyn
from mono_lidar_depth_tpu.obs import stats as jstats
from mono_lidar_depth_tpu.obs.timing import StageTimer as JStageTimer
from mono_lidar_depth_tpu.tracks import table as jtable
from mono_lidar_depth_tpu_torch.io import kitti as tkitti
from mono_lidar_depth_tpu_torch.io import messages as tmsg
from mono_lidar_depth_tpu_torch.io import native as tnative
from mono_lidar_depth_tpu_torch.obs import stats as tstats
from mono_lidar_depth_tpu_torch.obs.timing import StageTimer, profile_trace

from torch_parity import to_port

FIXTURE = Path(__file__).parent / "fixtures" / "kitti_mini"
W, H = 384, 128


@pytest.fixture(scope="module")
def both():
    return (jkitti.KittiSequence(str(FIXTURE), "04"),
            tkitti.KittiSequence(str(FIXTURE), "04"))


def _assert_sequences_equal(jseq, tseq, max_points):
    """Every field the evaluators read, the port's loader against JAX's."""
    assert len(tseq) == len(jseq) and tseq.scan_paths == jseq.scan_paths
    assert tseq.sequence == jseq.sequence
    assert tuple(tseq.camera) == tuple(jseq.calib.camera)
    assert tseq.calib.camera is tseq.camera
    l2c = tseq.lidar_to_cam("cpu")
    assert l2c.rotation.dtype == torch.float32
    assert np.array_equal(l2c.rotation.numpy(),
                          np.asarray(jseq.calib.lidar_to_cam.rotation))
    assert np.array_equal(l2c.translation.numpy(),
                          np.asarray(jseq.calib.lidar_to_cam.translation))
    assert np.array_equal(tseq.times, jseq.times)
    assert np.array_equal(tseq.gt_poses, jseq.gt_poses)
    for (a, na), (b, nb) in zip(tseq.scans(max_points),
                                jseq.scans(max_points)):
        assert na == nb and a.dtype == np.float32
        assert np.array_equal(a, np.asarray(b))
    for i in range(len(jseq) + 1):
        for get in ("image", "semantic"):
            a, b = getattr(tseq, get)(i), getattr(jseq, get)(i)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == np.uint8 and np.array_equal(a, b)


def test_calib_parsing(both):
    """calib.txt of the real-format fixture: P0 intrinsics, and Tr a
    mount that is not an axis permutation."""
    _, seq = both
    cam = seq.camera
    assert cam.focal_length == pytest.approx(707.0912)
    assert cam.cx == pytest.approx(601.8873)
    assert cam.cy == pytest.approx(183.1104)
    assert cam.width == 1226 and cam.height == 370
    l2c = seq.lidar_to_cam("cpu")
    R, t = l2c.rotation.numpy(), l2c.translation.numpy()
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-5)
    P = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    misalign = np.degrees(np.arccos(np.clip((np.trace(P.T @ R) - 1) / 2,
                                            -1, 1)))
    assert 0.1 < misalign < 2.0, misalign
    assert np.linalg.norm(t) == pytest.approx(
        np.linalg.norm([-0.012, -0.054, -0.292]), rel=1e-4)
    assert seq.calib.Tr.shape == (3, 4) and seq.calib.Tr.dtype == np.float64
    calib = tkitti.KittiCalib.from_file(str(FIXTURE / "sequences" / "04"
                                            / "calib.txt"), 640, 480)
    assert (calib.camera.width, calib.camera.height) == (640, 480)


def test_times_and_poses(both):
    _, seq = both
    assert seq.times is not None and len(seq.times) == 2
    assert seq.times[0] == 0.0 and 0.05 < seq.times[1] < 0.2
    assert seq.gt_poses.shape == (2, 4, 4)
    rel = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses[1]
    assert np.linalg.norm(rel[:3, 3]) == pytest.approx(0.8, abs=1e-4)
    assert abs(rel[2, 3]) == pytest.approx(0.8, abs=0.02)


def test_velodyne_native_vs_numpy(both):
    """The port's copy of the native binding and its numpy reader return
    the same padded scans, and both what the JAX package's return."""
    _, seq = both
    path = seq.scan_paths[0]
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    whole, n = tkitti.read_velodyne(path)
    assert n == len(raw) and np.array_equal(whole, raw)
    cut, n_cut = tkitti.read_velodyne(path, 1000)
    assert n_cut == 1000 and np.array_equal(cut, raw[:1000])
    assert tnative.native_available() == jnative.native_available()
    assert tnative._LIB_PATH == jnative._LIB_PATH
    if not tnative.native_available():
        pytest.skip("native reader unavailable")
    natv, n_nat = tnative.read_velodyne_native(path, 131072)
    assert n_nat == len(raw) and np.array_equal(natv[:n_nat], raw)
    assert not natv[n_nat:].any()
    jnat, jn = jnative.read_velodyne_native(path, 131072)
    assert jn == n_nat and np.array_equal(jnat, natv)
    with pytest.raises(FileNotFoundError):
        tnative.read_velodyne_native(path + ".missing", 16)
    loader = tnative.NativeScanLoader(seq.scan_paths, 4096)
    scans = list(loader)
    loader.close()
    assert [n for _, n in scans] == [4096, 4096]


def test_numpy_reader_when_the_library_is_absent(both, monkeypatch):
    """Without the native library the scans come from numpy: the same
    arrays."""
    _, seq = both
    want = list(seq.scans(131072))
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    got = list(seq.scans(131072))
    assert len(got) == len(want) == 2
    for (a, na), (b, nb) in zip(got, want):
        assert na == nb and np.array_equal(a, b)


def test_fixture_loader_matches_jax(both):
    jseq, tseq = both
    _assert_sequences_equal(jseq, tseq, 131072)
    img = tseq.image(0)
    assert img.shape == (370, 1226) and tseq.semantic(0) is None
    with pytest.raises(FileNotFoundError):
        tkitti.KittiSequence(str(FIXTURE), "77")


def test_loader_roundtrip(tmp_path):
    """tests/test_kitti_synthetic.py::test_loader_roundtrip on the port's
    loader, then field by field against the JAX loader and against the
    in-memory sequence."""
    spec = dict(frames=7, image_width=W, image_height=H, focal=240.0,
                lidar_rows=20, lidar_cols=500, step=0.7)
    jsyn.generate_kitti_sequence(str(tmp_path), "99",
                                 jsyn.SyntheticSpec(**spec))
    seq = tkitti.KittiSequence(str(tmp_path), "99", image_width=W,
                               image_height=H)
    assert len(seq) == 7 and seq.gt_poses.shape == (7, 4, 4)
    assert seq.camera.focal_length == 240.0
    img = seq.image(0)
    assert img.shape == (H, W) and img.std() > 20
    scan, n = next(iter(seq.scans(16384)))
    assert 1000 < n < 16384 and scan.shape == (16384, 4)
    assert seq.times is not None and len(seq.times) == 7
    sem = seq.semantic(0)
    assert sem.shape == (H, W) and sem.dtype == np.uint8
    _assert_sequences_equal(
        jkitti.KittiSequence(str(tmp_path), "99", image_width=W,
                             image_height=H), seq, 16384)
    mem = T.render_sequence(T.SyntheticSpec(**spec))
    assert tuple(mem.camera) == tuple(seq.camera)
    for i in range(7):
        assert np.array_equal(mem.image(i), seq.image(i))
        assert np.array_equal(mem.semantic(i), seq.semantic(i))
    for (a, na), (b, nb) in zip(mem.scans(16384), seq.scans(16384)):
        assert na == nb and np.array_equal(a, b)


def test_depth_pipeline_on_fixture(both):
    """The depth evaluator end to end on the real-format fixture, as
    tests/test_kitti_fixture.py runs the JAX package's."""
    _, seq = both
    cfg = T.DepthEstimatorConfig(
        max_points=131072, max_features=256, radiusSearch_count_min=1,
        ransac_num_hypotheses=256, ransac_subsample_points=1024)
    out = T.eval_depth_sequence(seq, cfg, max_tracks=512, max_length=8,
                                verbose=False, device="cpu")
    assert out["frames"] == 1 and out["total_points"] > 50
    assert out["success_rate_lidar_covered"] > 0.3, out


# ---- io/messages.py -----------------------------------------------------

def _table(rng, slots=48, length=6):
    jt = jtable.TrackTable.create(slots, length)
    for step in range(5):
        M = 32
        ids = rng.choice(64, M, replace=False).astype(np.int32)
        args = (ids, rng.random(M) < 0.85,
                rng.uniform(0, 300, (M, 2)).astype(np.float32),
                rng.uniform(0, 300, (M, 2)).astype(np.float32),
                np.where(rng.random(M) < 0.7, rng.uniform(1, 60, M),
                         -1.0).astype(np.float32),
                np.where(rng.random(M) < 0.7, rng.uniform(1, 60, M),
                         -1.0).astype(np.float32), np.float32(0.1 * step))
        jt, _ = jtable.update_tracks(jt, *map(jnp.asarray, args))
    return jt


def test_tracks_from_table_and_npz_roundtrip(tmp_path, rng):
    jt = _table(rng)
    want = jmsg.tracks_from_table(jt)
    got = tmsg.tracks_from_table(to_port(jt))
    assert want.num_tracks == got.num_tracks > 10
    for name in ("uv", "depth", "length", "track_id", "age", "stamps"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.success_fail_counts() == want.success_fail_counts()
    got.is_outlier = got.depth[:, 0] < 0
    got.label = np.arange(len(got.length), dtype=np.int16)
    p = str(tmp_path / "tracks.npz")
    got.save(p)
    back = tmsg.FeatureTracks.load(p)
    theirs = jmsg.FeatureTracks.load(p)  # the same wire format
    for rec in (back, theirs):
        for name in ("uv", "depth", "length", "track_id", "age", "stamps",
                     "is_outlier", "label"):
            assert np.array_equal(getattr(rec, name), getattr(got, name))
        assert rec.error is None
    empty = tmsg.tracks_from_table(T.tracks.table.TrackTable.create(
        8, 4, "cpu"))
    assert empty.num_tracks == 0 and empty.stamps.shape == (1,)


# ---- obs/stats.py, obs/timing.py -----------------------------------------

@pytest.mark.parametrize("counters", [
    [0, 258, 1279, 268, 2, 0, 181, 26, 285, 0, 0, 0, 0, 0, 0, 0, 584, 0, 0,
     0, 17],
    [0] * 21,
    [5, 0, 7] + [0] * 18,
])
def test_format_stats_report(counters):
    acc = np.asarray(counters, np.int32)
    want = jstats.format_stats_report(jstats.DepthCalcStats.zeros()._replace(
        accumulated=jnp.asarray(acc), frames=jnp.int32(24)))
    got = tstats.format_stats_report(tstats.DepthCalcStats.zeros(
        "cpu")._replace(accumulated=torch.from_numpy(acc),
                        frames=torch.tensor(24, dtype=torch.int32)))
    assert got == want and got.startswith("frames: 24  feature points: ")


def test_stage_timer():
    """A span around a CPU call counts it once; `report()` has the JAX
    package's format."""
    timer, jtimer = StageTimer(), JStageTimer()
    for t, arr in ((timer, torch.ones(8)), (jtimer, jnp.ones(8))):
        for _ in range(3):
            with t.span("depth"):
                t.observe(arr + 1)
        with t.span("pose"):
            t.observe((arr * 2, {"k": [arr]}))
    assert timer._counts == {"depth": 3, "pose": 1}
    assert timer._last_result is None
    assert set(timer.totals()) == {"depth", "pose"}
    assert all(v > 0 for v in timer.totals().values())

    def shape(report):
        # numbers right-aligned in fixed columns: compare the columns' ends
        lines = sorted(report.splitlines())
        return [(re.sub(r"\s+", " ", re.sub(r"[0-9.]+", "N", ln)),
                 [m.end() for m in re.finditer(r"\S+", ln)]) for ln in lines]

    assert shape(timer.report()) == shape(jtimer.report())
    assert timer.report().splitlines()[0] == (
        f"{'stage':32s} {'total s':>10s} {'calls':>7s} {'ms/call':>10s}")
    timer.reset()
    assert timer.totals() == {} and timer.report().count("\n") == 0
    quiet = StageTimer(sync=False)
    with quiet.span("x"):
        quiet.observe(torch.ones(2))
    assert quiet._counts == {"x": 1}


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 100
    assert any("mm" in e.key or "matmul" in e.key
               for e in prof.key_averages())
