"""The benchmark's frozen inputs at a small size on the CPU: the PyTorch
renderer against the port's numpy renderer, tracks that reproject onto
their landmarks, and inputs that follow the seed."""

import numpy as np
import pytest
import torch

from limo_bench import common, scene, tracks
from limo_bench.tests.tiny import tiny_config
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as sd

LAP = 40


def spec_and_cfg():
    """A port renderer spec and the same scene as a configuration."""
    spec = sd.SyntheticSpec(frames=LAP, image_width=160, image_height=64,
                            focal=90.0, lidar_rows=8, lidar_cols=120,
                            loop=True, lap_frames=LAP)
    cfg = {"camera": {"width": 160, "height": 64, "focal": 90.0,
                      "cx": 80.0, "cy": 32.0},
           "lidar": {"rows": 8, "cols": 120,
                     "elev_max_deg": float(np.degrees(spec.elev_max)),
                     "elev_min_deg": float(np.degrees(spec.elev_min)),
                     "azim_span_deg": float(np.degrees(2 * spec.azim_half)),
                     "max_range_m": 120.0, "noise_m": 0.0},
           "motion": {"step_m": spec.step, "lap_frames": LAP}}
    return spec, cfg


def test_trajectory_is_the_ports():
    spec, cfg = spec_and_cfg()
    want = sd._trajectory(spec)
    got = scene.trajectory(LAP, spec.step)
    for (Rw, cw), (Rg, cg) in zip(want, got):
        np.testing.assert_array_equal(Rg, Rw)
        np.testing.assert_array_equal(cg, cw)


@pytest.mark.parametrize("frame", [0, 17, 31])
def test_torch_renderer_matches_numpy(frame):
    spec, cfg = spec_and_cfg()
    seed = 7
    want = list(sd.render_frames(spec, seed))
    got = scene.render_lap(cfg, seed, torch.device("cpu"))
    w, g = want[frame], got[frame]
    np.testing.assert_array_equal(g.label.numpy(), w.label)
    # the shade is floored to 8 bits: a rounding difference of the
    # float64 ray directions may move a pixel by one grey level
    diff = np.abs(g.image.numpy().astype(int) - w.image.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    # the port's renderer adds its range noise from its own generator:
    # take that noise off its points before comparing
    rng = np.random.default_rng(seed)
    R = spec.lidar_rows * spec.lidar_cols
    for k in range(frame + 1):
        noise = rng.normal(size=(R, 3)) * 0.006
        n_hit = len(want[k].scan)
        rng.uniform(0, 1, (n_hit, 1))
    assert g.points.shape[0] == w.scan.shape[0]
    R_wc, c = sd._trajectory(spec)[frame]
    d_lid = scene.lidar_rays(cfg["lidar"], "cpu").numpy()
    o_l = c + R_wc @ sd.T_CL
    t, _, _ = sd._cast(np.broadcast_to(o_l, d_lid.shape),
                       d_lid @ (R_wc @ sd.R_CL).T, LAP * spec.step)
    hit = np.isfinite(t) & (t < 120.0)
    clean = w.scan[:, :3] - noise[hit].astype(np.float32)
    np.testing.assert_allclose(g.points.numpy(), clean, atol=2e-5)


def test_tracks_reproject_onto_their_landmarks():
    cfg = tiny_config("kitti_hdl64_tracklet_depth")
    ts = tracks.TrackStream(cfg, 11)
    noise = cfg["tracks"]["noise_px"]
    prev = None
    emitted = 0
    for _ in range(30):
        k = ts.frame % len(ts.poses)
        X, ids_before = ts.X.copy(), ts.ids.copy()
        out = ts.next()
        v = out.valid
        emitted += int(v.sum())
        assert (out.ids[v] == ids_before[v]).all()
        uv, inside = ts._project(X, k)
        assert inside[v].all()
        err = np.abs(out.uv_new[v] - uv[v])
        assert err.max() < 6 * noise
        # the landmark lies on the scene's ground or on a wall
        on = (np.isclose(X[v, 1], scene.GROUND_Y)
              | np.isclose(np.abs(X[v, 0]), scene.WALL_X)
              | np.isclose(X[v, 2], -20.0)
              | np.isclose(X[v, 2], cfg["motion"]["lap_frames"]
                           * cfg["motion"]["step_m"] + scene.FRONT_Z_OFFSET))
        assert on.all()
        if prev is not None:  # a continuing track starts where it was
            same = {i: j for j, i in enumerate(prev.ids) if prev.valid[j]}
            for j in np.nonzero(v)[0]:
                if out.ids[j] in same:
                    np.testing.assert_array_equal(
                        out.uv_prev[j], prev.uv_new[same[out.ids[j]]])
        prev = out
    assert emitted > 30 * 0.3 * ts.lanes


def test_inputs_follow_the_seed():
    cfg = tiny_config("kitti_hdl64_tracklet_depth")
    cpu = torch.device("cpu")
    a, a2, b = (common.make_lap(cfg, s, cpu) for s in (5, 5, 2 ** 31 + 9))
    assert torch.equal(a.clouds, a2.clouds)
    assert torch.equal(a.sub_idx, a2.sub_idx)
    assert not torch.equal(a.clouds, b.clouds)
    assert not torch.equal(a.sub_idx, b.sub_idx)
    assert not torch.equal(a.picks, b.picks)
    # the same work for every seed: same labels, same number of returns
    assert torch.equal(a.labels, b.labels)
    assert a.returns == b.returns
    ta, tb = tracks.TrackStream(cfg, 5), tracks.TrackStream(cfg, 6)
    fa, fb = ta.next(), tb.next()
    assert not np.array_equal(fa.uv_new, fb.uv_new)


def test_tracks_replay_with_the_lap():
    """A run's frame f takes the lap's tracks of row (f - 1) mod C, each
    pass with ids of its own, so a pass starts with every track new and
    the frame's tracks meet the frame's scan (lap frame f mod C)."""
    cfg = tiny_config("kitti_hdl64_tracklet_depth")
    cyc = tracks.make_cycle(cfg, 5)
    C = cfg["motion"]["lap_frames"]
    assert cyc.ids.shape[0] == C
    ts = tracks.TrackStream(cfg, 5)
    first = [ts.next() for _ in range(C)]
    for f in (1, 7, C, C + 1, 2 * C + 7):
        got, want = cyc.at(f), first[(f - 1) % C]
        np.testing.assert_array_equal(got.uv_new, want.uv_new)
        np.testing.assert_array_equal(got.ids,
                                      want.ids + ((f - 1) // C) * cyc.span)
    start, end = cyc.at(C + 1), cyc.at(C)
    assert not np.isin(start.ids[start.valid], end.ids[end.valid]).any()
    assert not cyc.at(0).valid.any()
