"""Config 3 held against the JAX package one step at a time.

A whole-run comparison over the envelope's 220 frames is chaotic: from
the same inputs (JAX's RANSAC draws and f32 image) the port's positions
come 2.21 m from JAX's at frame 164, and its ATE is 2.386 m against
JAX's 2.073 m, because the blind stretch (frames 62-84, no motion tracks
in either package) and the re-acquisition on a few tracks turn small
differences into metres.  Here JAX runs the envelope's configuration
(`make_parity_record_torch.record_spec(220)`, `record_config()`,
`VO_KW`) once, one frame per chunk, keeping its carry after every frame;
from each of those carries the port runs the next frame once
(`make_parity_record_torch.one_step`: `eval_vo_sequence` resumed at that
frame) on JAX's draws and image, and the two steps are compared: the
motion-track and inlier counts and the pose against POSE_BAR, the
carry's integer leaves to the bit.

193 of the 219 frames hold the bars.  The other 26 are named in EXEMPT
with the outcome counts and lanes that part.  On each of them the test
also runs JAX's own depth association for the frame (track_frame and
process_frame, jitted on their own; they move the same outcome counts as
JAX's run) and feeds it to the port's pose GN and window BA
(`vo/pipeline._odometry_tail`): from there the port lands within
POSE_BAR of JAX's pose, so each departure lies in the depth association,
in lanes of the road pass and of the ground plane, whose closed-form
fits on three-point windows and near-collinear inliers are
ill-conditioned: JAX's in float32 land far from the float64 fit, the
port's, in float64 and rounded once, on it
(test_road_fit_parts_by_rounding).
"""

import dataclasses
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mono_lidar_depth_tpu as J
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.core import geometry as jgeo
from mono_lidar_depth_tpu.eval import kitti_eval as jeval
from mono_lidar_depth_tpu.io.kitti import KittiSequence as JKittiSequence
from mono_lidar_depth_tpu.io.synthetic_dataset import (
    SyntheticSpec as JSpec, generate_kitti_sequence)
from mono_lidar_depth_tpu.tracker.frontend import track_frame as jtrack_frame
from mono_lidar_depth_tpu.tracks import pipeline as jtracks
from mono_lidar_depth_tpu.vo import pipeline as jvo
from mono_lidar_depth_tpu_torch.core import planefit as tpf
from mono_lidar_depth_tpu_torch.io.kitti import KittiSequence
from mono_lidar_depth_tpu_torch.vo import pipeline as tvo

from torch_parity import f64_plane_fit, inject_jax_frame_draws, to_port
from test_torch_parity_record import P, R, ROUNDING_OUTCOMES

FRAMES = 220
# chip_smoke.py phase 6's bar: rotation entries, translation (m).
POSE_BAR = P.POSE_BAR
# The float leaves of the carry held on every frame: the image pyramid to
# one ulp of 1.0 (its levels' blur sums round otherwise), the last frame's
# rasterized cloud and the track stamps to the bit.  The others carry what
# the step computes from the depth association and are not held: the
# tracker's positions (re-detected lanes among near-equal corner responses
# sit up to 5 px apart), track depths, the ground plane, the window poses.
FLOAT_BARS = {**{f"[0].pyramid[{k}]": 2.0 ** -23 for k in range(4)},
              **{f"[1].tracklets.frame_last.{name}": 0.0 for name in (
                  "points_lidar", "points_cam", "uv", "planes")},
              "[1].tracklets.table.stamps": 0.0}
# The frames outside the bars (measured: 26 of 219, all but frame 173 in
# the re-acquisition after the blind stretch, where 3-50 tracks carry the
# pose; 27 before the port's fits ran in float64, with 119, 128, 131 and
# 164 for 101, 130 and 173): frame -> (the outcome counts that the port's
# step moved against JAX's run, {code: port - JAX}; the carry's integer
# leaves that part; the lanes whose outcome parts, (lane, JAX's code, the
# port's code), lanes 0-383 the previous frame's (new tracks), 384-767 the
# current frame's).  Each moved outcome is a road lane and a depth gate of
# ROUNDING_OUTCOMES, or, where the ground plane itself parts (frames 84,
# 87 and 105), HistogramNoLocalMax.
EXEMPT = {
    84: ({3: 1, 16: -1}, ['[1].tracklets.gp_last.ok'],
         [(396, 16, 3)]),
    87: ({3: -4, 16: 4}, [],
         [(391, 3, 16), (402, 3, 16), (406, 3, 16), (407, 3, 16)]),
    92: ({6: -2, 7: -1, 16: 3}, [],
         [(405, 16, 6), (420, 7, 16), (426, 6, 16), (436, 6, 16),
          (448, 6, 16)]),
    93: ({5: -2, 6: 1, 7: -1, 16: 2}, [],
         [(422, 7, 6), (428, 5, 16), (449, 5, 16)]),
    97: ({4: -1, 6: 1}, [],
         [(408, 6, 16), (409, 4, 16), (418, 16, 6), (465, 7, 6),
          (477, 16, 7)]),
    99: ({4: -1, 6: 1, 7: -2, 16: 2}, [],
         [(412, 7, 16), (430, 4, 6), (477, 7, 16)]),
    101: ({7: -4, 16: 4}, [],
         [(406, 7, 16), (470, 7, 16), (492, 7, 16), (494, 7, 16)]),
    102: ({4: -2, 6: -1, 7: -1, 16: 4}, [],
         [(55, 4, 16), (439, 6, 16), (447, 4, 16), (459, 7, 16)]),
    103: ({7: -1, 16: 1}, [],
         [(94, 7, 16)]),
    105: ({3: -2, 6: -2, 7: -3, 16: 7}, [],
         [(397, 3, 16), (439, 7, 16), (461, 6, 16), (464, 5, 16), (469, 7, 16),
          (478, 7, 16), (486, 6, 16), (497, 3, 5)]),
    106: ({4: 1, 6: -3, 7: -2, 16: 4}, [],
         [(62, 5, 16), (405, 6, 16), (418, 6, 16), (420, 7, 16), (461, 7, 16),
          (478, 6, 5), (497, 16, 4)]),
    108: ({6: -2, 7: 1, 16: 1}, [],
         [(461, 6, 7), (477, 6, 16)]),
    109: ({7: -2, 16: 2}, [],
         [(110, 7, 16), (464, 7, 16)]),
    113: ({6: 1, 16: -1}, [],
         [(487, 16, 6)]),
    114: ({7: 1, 16: -1}, [],
         [(449, 16, 7), (480, 16, 7), (487, 7, 16)]),
    115: ({5: -1, 6: 1}, [],
         [(74, 16, 6), (112, 6, 16), (449, 5, 6)]),
    117: ({}, [],
         [(444, 16, 7), (459, 7, 16)]),
    118: ({5: -1, 6: -1, 7: -2, 16: 4}, [],
         [(66, 7, 16), (426, 7, 16), (444, 5, 7), (450, 6, 16),
          (460, 7, 16)]),
    121: ({6: 1, 7: -2, 16: 1}, [],
         [(424, 16, 6), (426, 7, 16), (467, 16, 6), (475, 6, 16),
          (479, 7, 16)]),
    124: ({6: -2, 7: -1, 16: 3}, [],
         [(403, 6, 16), (415, 6, 16), (494, 7, 16)]),
    125: ({6: 1, 7: -1}, [],
         [(426, 16, 6), (481, 7, 16)]),
    127: ({6: -1, 7: 1}, [],
         [(426, 16, 7), (474, 6, 16)]),
    130: ({7: 2, 16: -2}, [],
         [(481, 16, 7), (487, 16, 7)]),
    134: ({5: -2, 16: 2}, [],
         [(481, 5, 16), (484, 5, 16)]),
    139: ({5: -1, 6: 1}, [],
         [(510, 16, 6), (560, 5, 16)]),
    173: ({6: -1, 16: 1}, [],
         [(102, 7, 16), (614, 6, 7)]),
}


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """Every frame of config 3 stepped once by the port from JAX's carry,
    and both whole runs (JAX's and the port's, the port on JAX's draws and
    image)."""
    root = str(tmp_path_factory.mktemp("replay220"))
    generate_kitti_sequence(root, "98", JSpec(**dataclasses.asdict(
        P.record_spec(FRAMES))))
    jseq = JKittiSequence(root, "98", image_width=P.W, image_height=P.H)
    tseq = KittiSequence(root, "98", image_width=P.W, image_height=P.H)
    cfg = P.record_config()
    jcfg = J.DepthEstimatorConfig(**dataclasses.asdict(cfg))
    cam, l2c = jseq.calib.camera, jseq.calib.lidar_to_cam
    jocfg, ocfg = jvo.OdometryConfig(), T.OdometryConfig()

    from mono_lidar_depth_tpu.core import depth_estimator as jdepth

    @jax.jit
    def jax_depth_and_tail(carry, x):
        """JAX's step of one frame, jitted on its own: both frames' codes
        from its depth pair, its depth association, and its pose GN and
        window BA on that association."""
        pairs, real_pair = [], jdepth.estimate_depths_pair

        def pair(*args, **kwargs):
            pairs.append(real_pair(*args, **kwargs))
            return pairs[-1]

        tstate, out = jtrack_frame(carry[0], jeval._dev_img(x["img"]))
        frame = jtracks.FrameInput(
            cloud=x["cloud"], cloud_valid=x["cvalid"], ids=out.ids,
            ids_valid=out.valid, uv_new=out.uv_new, uv_prev=out.uv_prev,
            stamp=x["stamp"], rng=x["key"])
        jdepth.estimate_depths_pair = pair
        try:
            # unjitted, so that this trace runs its Python and calls `pair`
            tl, depths, codes = jtracks.process_frame.__wrapped__(
                jcfg, cam, l2c, carry[1].tracklets, frame)
        finally:
            jdepth.estimate_depths_pair = real_pair
        _, R, t, _ = jvo._odometry_tail(jcfg, jocfg, cam, carry[1], tl,
                                        depths, codes)
        both = jnp.concatenate([pairs[0][0].codes, pairs[0][1].codes])
        return both, (tl, depths, codes), R, t

    rows, extra = {}, {}
    real = jeval._scan_vo_chunk

    def scan_vo_chunk(cfg_, ocfg_, cam_, l2c_, carry, xs):
        new, (R, t, diag) = real(cfg_, ocfg_, cam_, l2c_, carry, xs)
        if len(xs["img"]) == 0:  # frame 0: the tracker and the prime
            return new, (R, t, diag)
        f = len(rows) + 1
        before, after = to_port(carry), to_port(new)
        with P.outcomes_recorded() as outcomes:
            step = P.one_step(tseq, cfg, f, before, "cpu")
        Rt = np.asarray(R).transpose(0, 2, 1)
        pose = np.eye(4)
        pose[:3, :3] = Rt[0]
        pose[:3, 3] = -np.einsum("fij,fj->fi", Rt, np.asarray(t))[0]
        row = P.step_gap(step, outcomes[0][1], pose, np.asarray(diag)[0],
                         None, after)
        moved = (step["carry"][1].tracklets.counters
                 - after[1].tracklets.counters).numpy()
        row["moved"] = {int(k): int(moved[k]) for k in np.nonzero(moved)[0]}
        lanes = after[0].valid  # the tracker's live lanes, equal in both
        row["uv_live"] = float((step["carry"][0].uv - after[0].uv)[lanes]
                               .abs().max()) if lanes.any() else 0.0
        rows[f] = row
        if (row["dR"] > POSE_BAR[0] or row["dt_m"] > POSE_BAR[1]
                or not row["counts_equal"] or row["int_apart"]):
            jcodes, (tl, jdepths, jnew), jR, jt = jax_depth_and_tail(
                carry, jax.tree.map(lambda a: a[0], xs))
            pR, pt = tvo._odometry_tail(
                cfg, ocfg, tseq.camera, before[1], to_port(tl),
                torch.from_numpy(np.array(jdepths)),
                torch.from_numpy(np.array(jnew)))[1:3]
            jcodes, pcodes = np.asarray(jcodes), outcomes[0][1]
            sep = (np.bincount(pcodes, minlength=21)
                   - np.bincount(jcodes, minlength=21))
            extra[f] = {
                "lanes": [(int(i), int(jcodes[i]), int(pcodes[i]))
                          for i in np.nonzero(jcodes != pcodes)[0]],
                "sep_moved": {int(k): int(sep[k]) for k in np.nonzero(sep)[0]},
                "tail_dR": float(np.abs(pR.numpy() - np.asarray(jR)).max()),
                "tail_dt": float(np.abs(pt.numpy() - np.asarray(jt)).max())}
        return new, (R, t, diag)

    t0 = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp:
        inject_jax_frame_draws(mp, tseq, cfg)
        mp.setattr(jeval, "_CHUNK_FRAMES", 1)
        mp.setattr(jeval, "_scan_vo_chunk", scan_vo_chunk)
        want = jeval.eval_vo_sequence(jseq, jcfg, **P.VO_KW)
        got = T.eval_vo_sequence(tseq, cfg, device="cpu", **P.VO_KW)
    print(f"replay: {time.perf_counter() - t0:.1f} s")
    return rows, extra, want, got


def test_one_step_replay_matches_jax(replay):
    """Every frame of config 3, one port step from JAX's carry: the counts
    equal, the pose within POSE_BAR and the carry's integer leaves equal
    to the bit outside EXEMPT; FLOAT_BARS on every frame; on each frame
    outside the bars, the outcome moves, leaves and lanes EXEMPT names,
    and the port's tail from JAX's depth association within POSE_BAR of
    JAX's.  Printed, not held: both whole runs' ATE and RPE and their
    largest position gap."""
    rows, extra, want, got = replay
    assert len(rows) == want["frames"] == got["frames"] == FRAMES - 1
    s = P.summarize_steps(rows)
    outside = {f for f, r in rows.items()
               if r["dR"] > POSE_BAR[0] or r["dt_m"] > POSE_BAR[1]
               or not r["counts_equal"] or r["int_apart"]}
    held = [r for f, r in rows.items() if f not in outside]
    print(f"one-step replay, {len(rows)} frames: largest |dR| "
          f"{s['max_dR']:.3e} (frame {s['max_dR_frame']}), |dt| "
          f"{s['max_dt_m']:.3e} m (frame {s['max_dt_frame']}); outside the "
          f"bars {len(outside)}: {sorted(outside)}; the others' largest |dR| "
          f"{max(r['dR'] for r in held):.3e}, |dt| "
          f"{max(r['dt_m'] for r in held):.3e} m; median |dR| "
          f"{np.median([r['dR'] for r in rows.values()]):.2e}, |dt| "
          f"{np.median([r['dt_m'] for r in rows.values()]):.2e} m; counts "
          f"differ at "
          f"{s['count_frames']}; outcomes moved at "
          f"{[f for f, r in rows.items() if r['moved']]}")
    for f, e in extra.items():
        r = rows[f]
        print(f"  frame {f}: |dR| {r['dR']:.2e} |dt| {r['dt_m']:.2e} counts "
              f"{'equal' if r['counts_equal'] else 'differ'}, leaves apart "
              f"{r['int_apart']}, ground plane "
              f"{r['floats']['[1].tracklets.gp_last.coeffs']:.1e}, moved "
              f"{r['moved']}; JAX's step alone: moved {e['sep_moved']}, "
              f"lanes {e['lanes']}, the port's tail from its depths |dR| "
              f"{e['tail_dR']:.1e} |dt| {e['tail_dt']:.1e}")
    if outside:
        print("the port's tail from JAX's depths on the frames outside: "
              "largest |dR| "
              f"{max(extra[f]['tail_dR'] for f in outside):.2e}, |dt| "
              f"{max(extra[f]['tail_dt'] for f in outside):.2e} m")
    gap = np.abs(got["poses"][:, :3, 3] - want["poses"][:, :3, 3]).max(1)
    for name, vo in (("JAX", want), ("port", got)):
        print(f"whole run, {name}: ATE {vo['ate_rmse']:.3f} m, RPE "
              f"{vo['rpe_trans_rmse']:.4f} m / {vo['rpe_rot_rmse_deg']:.3f} "
              f"deg")
    print(f"whole runs' largest position gap {gap.max():.3f} m at frame "
          f"{int(np.argmax(gap)) + 1}")
    print("float leaves' largest difference", s["float_leaves_max"])
    print("tracker positions of live lanes: largest difference",
          max(r["uv_live"] for r in rows.values()), "px")
    print("EXEMPT frames now within the bars:", sorted(set(EXEMPT) - outside))
    for name, bar in FLOAT_BARS.items():
        assert s["float_leaves_max"][name] <= bar, name
    assert outside <= set(EXEMPT), {
        f: (rows[f]["moved"], rows[f]["int_apart"])
        for f in sorted(outside - set(EXEMPT))}
    for f in sorted(outside):
        moved, apart, lanes = EXEMPT[f]
        assert (rows[f]["moved"], rows[f]["int_apart"]) == (moved, apart), f
        # JAX's step alone moves what its run moved, in the named lanes
        assert extra[f]["sep_moved"] == moved, f
        assert extra[f]["lanes"] == lanes, f
        assert set(moved) <= ROUNDING_OUTCOMES | {R.HistogramNoLocalMax}, f
        if R.HistogramNoLocalMax in moved:  # the ground plane parted
            assert rows[f]["floats"]["[1].tracklets.gp_last.coeffs"] > 1e-3
        assert extra[f]["tail_dR"] <= POSE_BAR[0], f
        assert extra[f]["tail_dt"] <= POSE_BAR[1], f


def _road_window(lane: str):
    """One road window of tests/fixtures/replay_road_windows.json as numpy
    (points [1, K, 3], mask [1, K], distance to the ground plane [1, K])."""
    path = Path(__file__).parent / "fixtures" / "replay_road_windows.json"
    w = json.loads(path.read_text())["lanes"][lane]
    return (np.array(w["points"], np.uint32).view(np.float32).reshape(1, -1, 3),
            np.array(w["mask"], bool)[None],
            np.array(w["prior_dist"], np.uint32).view(np.float32)[None])


@jax.jit
def _jax_mestimator_steps(points, mask, prior_dist):
    """mono_lidar_depth_tpu/core/planefit.py mestimator_plane's statements
    up to the scatter, each kept."""
    w = jnp.where(mask, 1.0 / jnp.maximum(prior_dist, 1e-9), 0.0)
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    center = jnp.sum(w[..., None] * points, axis=-2) / jnp.where(
        wsum == 0, 1.0, wsum)
    centered = (points - center[..., None, :]) * jnp.sqrt(w)[..., None]
    return w, wsum, center, jnp.einsum("nki,nkj->nij", centered, centered)


def _angle_deg(a, b) -> float:
    """The angle between two lines, from float64 copies of a and b."""
    a, b = (np.ravel(x).astype(np.float64) for x in (a, b))
    return float(np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b)),
                                       abs(float(a @ b)))))


@pytest.mark.parametrize("lane", ["20:564", "20:565"])
def test_road_fit_parts_by_rounding(lane):
    """Where road lanes of the replay part: two windows of frame 20 that
    hold the same three road points.  Three points make a near-degenerate
    scatter (kappa = ev2 / (ev1 - ev0) 2.6e3).  The JAX package's float32
    M-estimator statements (core/planefit.py) give the weights and their
    sum as float64 rounds them, and the centroid and the scatter 2 ulp
    off; its closed-form float32 eigensolver turns that into a normal
    2.26 deg from LAPACK's float64 normal.  The port's
    `mestimator_plane` runs in float64 from the same float32 inputs and
    rounds once: its normal lies within 1e-4 deg of the float64 normal
    (measured 8.5e-7 deg)."""
    pts, mask, dist = _road_window(lane)
    assert int(mask.sum()) == 3
    w64 = np.where(mask, 1.0 / np.maximum(dist.astype(np.float64),
                                          np.float32(1e-9)), 0.0)
    n64, c64, kappa = f64_plane_fit(pts, w64)
    q = (pts - c64[:, None]) * np.sqrt(w64)[..., None]
    f64_steps = (w64, w64.sum(-1, keepdims=True), c64,
                 np.einsum("nki,nkj->nij", q, q))
    jsteps = _jax_mestimator_steps(pts, mask, dist)
    ulps = [chip_smoke._ulps(np.asarray(j), f.astype(np.float32))
            for j, f in zip(jsteps, f64_steps)]
    jn = jax.jit(jgeo.smallest_eigenvector_sym3x3)(jsteps[3])
    tn = tpf.mestimator_plane(*map(torch.from_numpy, (pts, mask)),
                              prior_dist=torch.from_numpy(dist)).normal
    print(f"{lane}: kappa {kappa[0]:.3e}; JAX's w, wsum, center, scatter "
          f"{ulps} ulp from float64's; normals from float64's: JAX "
          f"{_angle_deg(jn, n64):.3f} deg, the port "
          f"{_angle_deg(tn.numpy(), n64):.2e} deg")
    assert 1e3 < kappa[0] < 1e4
    assert ulps[:2] == [0, 0] and ulps[2] > 0 and ulps[3] > 0
    assert _angle_deg(tn.numpy(), n64) < 1e-4
    assert _angle_deg(jn, n64) > 2.0


def test_frame_by_frame_resume_is_bit_identical():
    """The replay's method on the port's CPU: 12 frames of the record's
    sequence stepped one frame at a time through `start_frame` /
    `init_carry` (make_parity_record_torch.one_step) give the
    uninterrupted run's poses, diag and final carry to the bit."""
    seq = P.render_sequence(P.record_spec(12))
    cfg = P.record_config()
    whole = T.eval_vo_sequence(seq, cfg, T.OdometryConfig(),
                               return_carry=True, device="cpu", **P.VO_KW)
    first = T.eval_vo_sequence(seq, cfg, T.OdometryConfig(), max_frames=2,
                               return_carry=True, device="cpu", **P.VO_KW)
    poses, diags, carry = [first["poses"]], [first["diag"]], first["carry"]
    for f in range(2, 12):
        step = P.one_step(seq, cfg, f, carry, "cpu")
        assert step["frame_ids"] == [f]
        poses.append(step["poses"])
        diags.append(step["diag"])
        carry = step["carry"]
    assert np.array_equal(np.concatenate(poses), whole["poses"])
    assert np.array_equal(np.concatenate(diags), whole["diag"])
    assert P.carry_gap(carry, whole["carry"]) == ([], {
        path: 0.0 for path, x in P._leaves(carry) if x.is_floating_point()})
