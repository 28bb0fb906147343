"""Scan-row segmentation, region growing and the estimator's region
branch: the port against the JAX functions on the CPU.

Both sides get JAX's FrameCloud (`uv`, `visible`, `points_cam`), so the
bars are:

  * `segment_rows`: every integer field of RowStructure bit-exact, the
    compacted `comp_uv` / `comp_xyz` exact copies;
  * `grow_regions`: distances are f32 norms compared with `<=` to caps,
    and XLA's CPU backend contracts multiply-adds where eager PyTorch does
    not, so a lane exactly at a cap may fall on either side.  A lane is
    *decided* when the port's own result does not change with every cap
    scaled by 1 -+ 2e-5 (twice the 1e-5 relative margin of the bar):
    `status`, `mask` and `raw_indices` are equal to JAX's on every decided
    lane, and fewer than 1% of the lanes are undecided;
  * the estimator with `do_use_depth_segmentation`: at least 99.9% of
    codes agree and depths on agreeing successes within 5e-3 relative, on
    a row-ordered scan with SuccessRegionGrowing lanes on both sides and
    both hard returns of the region branch hit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu as J
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.core import depth_estimator as JDE
from mono_lidar_depth_tpu.core import neighbors as jnb
from mono_lidar_depth_tpu.core import row_segmentation as jrs
from mono_lidar_depth_tpu.core.histogram import nearest_point as jnearest
from mono_lidar_depth_tpu.core.projection import build_frame_cloud
from mono_lidar_depth_tpu.io.kitti import pad_cloud
from mono_lidar_depth_tpu_torch.convert import state_to_numpy
from mono_lidar_depth_tpu_torch.core import row_segmentation as trs
from mono_lidar_depth_tpu_torch.core.result_types import DepthResultType as R
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as tsyn

from torch_parity import assert_trees_equal, to_numpy, to_port

H, W = 384, 512
JCAM = J.PinholeCamera(width=W, height=H, focal_length=600.0, cx=W / 2,
                       cy=H / 2)
TCAM = T.PinholeCamera(width=W, height=H, focal_length=600.0, cx=W / 2,
                       cy=H / 2)
INT_FIELDS = ("comp_raw", "comp_valid", "row_id", "col_id", "row_start",
              "row_len", "num_rows", "rank")


def _padded(pts, pad=4096):
    pts = np.asarray(pts, np.float32)
    cloud = np.zeros((pad, 3), np.float32)
    cloud[:len(pts)] = pts
    valid = np.zeros(pad, bool)
    valid[:len(pts)] = True
    return cloud, valid


def _grid_cloud(z=20.0, nx=40, ny=12, pad=4096):
    """The planar grid of tests/test_row_segmentation.py: ny scan rows,
    image-x decreasing within a row."""
    pts = [((0.5 - ix / (nx - 1)) * 12.0, (iy / (ny - 1) - 0.5) * 6.0, z)
           for iy in range(ny) for ix in range(nx)]
    return (*_padded(pts, pad), len(pts))


def _jframe(cloud, valid):
    return build_frame_cloud(jnp.asarray(cloud), jnp.asarray(valid),
                             J.SE3.identity(), JCAM, H, W)


def _rows_both(jframe, max_rows=128):
    jrows = jrs.segment_rows(jframe, max_rows)
    trows = trs.segment_rows(to_port(jframe), max_rows)
    return jrows, trows


def _assert_rows_equal(trows, jrows):
    got, want = state_to_numpy(trows), to_numpy(jrows)
    assert got._fields == want._fields
    for name in INT_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    for name in ("comp_uv", "comp_xyz"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()


def _grow_both(jrows, trows, seed, seed_valid, uv, **kw):
    want = jrs.grow_regions(jrows, jnp.asarray(seed), jnp.asarray(seed_valid),
                            jnp.asarray(uv, jnp.float32), **kw)
    got = trs.grow_regions(trows, torch.tensor(seed), torch.tensor(seed_valid),
                           torch.tensor(np.asarray(uv, np.float32)), **kw)
    return state_to_numpy(got), to_numpy(want)


# ---- the six scenes of tests/test_row_segmentation.py ------------------

def test_segment_rows_structure():
    cloud, valid, n = _grid_cloud()
    jrows, trows = _rows_both(_jframe(cloud, valid))
    _assert_rows_equal(trows, jrows)
    assert int(trows.num_rows) == 12
    row_len = trows.row_len.numpy()
    assert (row_len[:12] == 40).all() and (row_len[12:] == 0).all()
    assert (trows.row_id.numpy()[:n] == np.repeat(np.arange(12), 40)).all()
    assert (trows.col_id.numpy()[:n] == np.tile(np.arange(40), 12)).all()


def test_segment_rows_respects_visibility():
    cloud, valid, n = _grid_cloud()
    cloud[5, 2] = -5.0  # behind the camera: gone from the rows
    jrows, trows = _rows_both(_jframe(cloud, valid))
    _assert_rows_equal(trows, jrows)
    assert int(trows.comp_valid.sum()) == n - 1


def test_grow_region_on_plane():
    cloud, valid, n = _grid_cloud()
    jframe = _jframe(cloud, valid)
    jrows, trows = _rows_both(jframe)
    uv = np.asarray(jframe.uv)[:n]
    center = np.array([W / 2, H / 2])
    seed = int(np.argmin(((uv - center) ** 2).sum(1)))
    got, want = _grow_both(jrows, trows, [seed], [True], [center],
                           max_pointcount=8, window=16)
    assert_trees_equal(got, want)
    assert int(got.status[0]) == 1 and got.mask[0].sum() == 8
    grown_rows = set((got.raw_indices[0][got.mask[0]] // 40).tolist())
    assert len(grown_rows) == 2


def test_grow_region_depth_discontinuity_stops():
    pts = []
    for iy in range(2):
        for ix in range(40):
            z = 20.0 if ix < 20 else 40.0  # jump at ix = 20
            pts.append(((0.5 - ix / 39) * 12.0 * z / 20.0,
                        (-0.5 + iy) * z / 20.0, z))
    jframe = _jframe(*_padded(pts))
    jrows, trows = _rows_both(jframe)
    got, want = _grow_both(jrows, trows, [18], [True],
                           [np.asarray(jframe.uv)[18]], max_pointcount=-1,
                           window=16)
    assert_trees_equal(got, want)
    raw = got.raw_indices[0][got.mask[0]]
    assert (raw[raw < 40] < 20).all() and int(got.status[0]) == 1


def test_no_adjacent_row():
    pts = [((0.5 - ix / 39) * 12.0, 0.0, 20.0) for ix in range(40)]
    jrows, trows = _rows_both(_jframe(*_padded(pts)))
    _assert_rows_equal(trows, jrows)
    got, want = _grow_both(jrows, trows, [20], [True], [[W / 2.0, H / 2.0]])
    assert_trees_equal(got, want)
    assert int(got.status[0]) == -1


def test_invalid_seed():
    cloud, valid, _ = _grid_cloud()
    jrows, trows = _rows_both(_jframe(cloud, valid))
    got, want = _grow_both(jrows, trows, [0], [False], [[10.0, 10.0]])
    assert_trees_equal(got, want)
    assert int(got.status[0]) == -4


# ---- what the port had to get right -----------------------------------

def test_every_column_of_a_row():
    """A seed at every column of a middle row: the proportional column
    estimate `int32(col / len * adj_len)` lands on an integer for many of
    them and just beside one for others (f32 division, truncation)."""
    cloud, valid, n = _grid_cloud()
    jframe = _jframe(cloud, valid)
    jrows, trows = _rows_both(jframe)
    seeds = np.arange(5 * 40, 6 * 40, dtype=np.int32)
    uv = np.asarray(jframe.uv)[seeds] + np.float32(0.25)
    got, want = _grow_both(jrows, trows, seeds, np.ones(40, bool), uv,
                           max_pointcount=6, window=8)
    assert_trees_equal(got, want)
    assert (got.status == 1).sum() >= 39  # as in JAX: all but column 0
    frac = seeds % 40 / np.float32(40)
    assert ((frac * 40).astype(np.int32) == seeds % 40).sum() > 10


@pytest.mark.parametrize("max_rows", [8, 5])
def test_more_rows_than_capacity(max_rows):
    """12 scan rows into `max_rows` slots: the row ids are clipped, so the
    starts of rows max_rows-1 .. 11 all write the last slot of row_start.
    JAX's CPU backend keeps the last write, the largest position; the port
    takes the maximum, whatever the order of the writes."""
    cloud, valid, n = _grid_cloud()
    jframe = _jframe(cloud, valid)
    jrows, trows = _rows_both(jframe, max_rows)
    _assert_rows_equal(trows, jrows)
    assert int(trows.row_start[max_rows - 1]) == 11 * 40
    assert int(trows.row_len[max_rows - 1]) == (12 - max_rows + 1) * 40
    assert int(trows.num_rows) == max_rows
    # twice more: the same value every time
    for _ in range(2):
        again = jrs.segment_rows(jframe, max_rows)
        assert np.array_equal(np.asarray(again.row_start),
                              np.asarray(jrows.row_start))
    # and region growing on the clipped structure
    seeds = np.arange(0, n, 7, dtype=np.int32)
    uv = np.asarray(jframe.uv)[seeds]
    got, want = _grow_both(jrows, trows, seeds, np.ones(len(seeds), bool), uv)
    assert_trees_equal(got, want)


# ---- rendered, row-ordered scans --------------------------------------

SPEC = dict(frames=2, image_width=384, image_height=128, focal=240.0,
            lidar_rows=20, lidar_cols=500, step=0.7)
SMALL = dict(max_points=16384, max_features=384, image_width=384,
             image_height=128, ransac_num_hypotheses=128,
             ransac_subsample_points=1024)


@pytest.fixture(scope="module")
def rendered():
    """Two rendered frames in Velodyne order, and JAX's FrameCloud of each
    scan (no ground flags).

    The renderer sweeps every beam left to right, so image-x INCREASES
    within a row and never jumps up: `segment_rows` finds one or two rows
    in such a scan (in both packages).  Reversed, the scan has what the
    segmenter expects of a Velodyne: image-x decreasing within a row and
    a jump up of the whole image width between rows."""
    seq = tsyn.VelodyneOrder(tsyn.render_sequence(tsyn.SyntheticSpec(**SPEC),
                                                  seed=2))
    jcfg = J.DepthEstimatorConfig(**SMALL)
    jcam = J.PinholeCamera(*seq.camera)
    jl2c = J.SE3(jnp.asarray(seq.Tr[:, :3], jnp.float32),
                 jnp.asarray(seq.Tr[:, 3], jnp.float32))
    frames = []
    for xyzi, n in seq.scans(jcfg.max_points):
        cloud, valid = pad_cloud(xyzi, n, jcfg.max_points)
        frames.append(build_frame_cloud(
            jnp.asarray(cloud), jnp.asarray(valid), jl2c, jcam,
            jcfg.image_height, jcfg.image_width))
    return seq, jcam, jl2c, frames


def _features(rng, frame, n):
    """Feature positions: most on visible lidar points (with a subpixel
    offset), the rest uniform over the image, sky included."""
    uv_pts = np.asarray(frame.uv)[np.asarray(frame.visible)]
    uv = uv_pts[rng.integers(0, len(uv_pts), n)] + rng.normal(0, 0.7, (n, 2))
    k = n // 4
    uv[:k] = rng.uniform([0, 0], [383, 127], (k, 2))
    return uv.astype(np.float32)


@pytest.mark.parametrize("k", [0, 1])
def test_segment_rows_on_a_rendered_scan(rendered, k):
    _, _, _, frames = rendered
    jrows, trows = _rows_both(frames[k])
    _assert_rows_equal(trows, jrows)
    assert int(trows.num_rows) >= 10  # the 20 beams, less those off-image
    assert int(trows.comp_valid.sum()) > 3000


def _scaled(kw, s):
    return {k: (v * s if k.endswith(("_start", "_gradient")) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("k,max_pointcount,window", [(0, 4, 32), (1, 8, 16),
                                                     (0, -1, 32)])
def test_grow_regions_on_a_rendered_scan(rendered, k, max_pointcount, window):
    _, jcam, _, frames = rendered
    frame = frames[k]
    rng = np.random.default_rng(10 + k)
    N = 384
    uv = _features(rng, frame, N)
    # seeds as the estimator makes them: the nearest neighbor of the
    # primary window, -1 where the window is empty
    nb = jnb.gather_neighbors(frame, jcam, jnp.asarray(uv), 3.0, 4.5, (11, 8),
                              with_indices=True)
    seed_k, has_any = jnearest(nb.z, nb.mask)
    seed_raw = np.asarray(jnp.take_along_axis(nb.indices, seed_k[:, None],
                                              1)[:, 0])
    seed_z = np.asarray(jnp.take_along_axis(nb.z, seed_k[:, None], 1)[:, 0])
    seed_valid = np.asarray(has_any) & (seed_z <= 40.0)
    assert (seed_raw == -1).sum() > 5  # empty windows
    assert (np.asarray(has_any) & ~seed_valid).sum() > 0  # too deep
    kw = dict(max_dist_threshold=10.0, seed_to_seed_start=0.5,
              seed_to_seed_gradient=0.05, neighbor_to_seed_start=0.5,
              neighbor_to_seed_gradient=0.05, neighbor_start=0.2,
              neighbor_gradient=0.02, max_pointcount=max_pointcount,
              window=window)
    jrows, trows = _rows_both(frame)
    got, want = _grow_both(jrows, trows, seed_raw, seed_valid, uv, **kw)

    def port(s):
        return state_to_numpy(trs.grow_regions(
            trows, torch.tensor(seed_raw), torch.tensor(seed_valid),
            torch.tensor(uv), **_scaled(kw, s)))

    lo, hi = port(1 - 2e-5), port(1 + 2e-5)
    decided = np.ones(N, bool)
    for other in (lo, hi):
        decided &= ((other.status == got.status)
                    & (other.mask == got.mask).all(1)
                    & (other.raw_indices == got.raw_indices).all(1))
    undecided = 1.0 - decided.mean()
    print(f"grow_regions frame {k}: {100 * undecided:.2f}% of lanes within "
          f"2e-5 of a cap; status counts "
          f"{dict(zip(*np.unique(want.status, return_counts=True)))}")
    assert undecided < 0.01
    assert np.array_equal(got.status[decided], want.status[decided])
    assert np.array_equal(got.mask[decided], want.mask[decided])
    assert np.array_equal(got.raw_indices[decided],
                          want.raw_indices[decided])
    assert got.mask.dtype == np.bool_ and got.raw_indices.dtype == np.int32
    assert got.raw_indices.shape == (N, 2 * window)
    # every outcome occurs
    assert set(np.unique(want.status)) >= {1, -3, -4}
    assert (want.status == 1).sum() > 30


# ---- the estimator with region growing --------------------------------

@pytest.mark.parametrize("road_pass", [True, False])
def test_index_plane_reaches_the_cascade(rendered, road_pass):
    """`_gather_two_scales` with region growing on asks for the index
    plane, one frame at a time: every field of both scales, `indices`
    included, bit-exact to JAX's at the estimator's windows."""
    from mono_lidar_depth_tpu_torch.core import depth_estimator as TDE

    seq, jcam, _, frames = rendered
    kw = dict(SMALL, do_use_depth_segmentation=True,
              do_use_ransac_plane=road_pass)
    jcfg, tcfg = J.DepthEstimatorConfig(**kw), T.DepthEstimatorConfig(**kw)
    uv = _features(np.random.default_rng(3), frames[0], 384)
    want = JDE._gather_two_scales(jcfg, jcam, frames[0], jnp.asarray(uv))
    got = TDE._gather_two_scales(tcfg, seq.camera, [to_port(frames[0])],
                                 [torch.from_numpy(uv)])
    assert (got[1] is None) == (want[1] is None) == (not road_pass)
    for g, w in zip(got, want):
        if w is None:
            continue
        assert_trees_equal(state_to_numpy(g), to_numpy(w))
        assert g.indices.dtype == torch.int32
        assert bool(((g.indices >= 0) == g.mask).all())
    assert int(got[0].mask.sum()) > 1000
    # off by default: no index plane
    off = TDE._gather_two_scales(T.DepthEstimatorConfig(**SMALL), seq.camera,
                                 [to_port(frames[0])],
                                 [torch.from_numpy(uv)])
    assert off[0].indices is None and torch.equal(off[0].mask, got[0].mask)


def _estimate_both(rendered, k, overrides, seed):
    seq, jcam, jl2c, _ = rendered
    kw = dict(SMALL, do_use_depth_segmentation=True, **overrides)
    jcfg, tcfg = J.DepthEstimatorConfig(**kw), T.DepthEstimatorConfig(**kw)
    xyzi, n = list(seq.scans(jcfg.max_points))[k]
    cloud, valid = pad_cloud(xyzi, n, jcfg.max_points)
    jgp = J.fit_ground_plane_semantic(
        jnp.asarray(cloud), jnp.asarray(valid),
        jnp.asarray(seq.semantic(k).astype(np.int32)), jl2c.rotation,
        jl2c.translation, jcam.intrinsics(), inlier_threshold=0.3)
    jframe = J.rasterize_cloud(jcfg, jcam, jl2c, jnp.asarray(cloud),
                               jnp.asarray(valid), jgp)
    rng = np.random.default_rng(seed)
    uv = _features(rng, jframe, jcfg.max_features)
    fvalid = rng.random(len(uv)) < 0.95
    jest = JDE.estimate_depths_from_frame(jcfg, jcam, jl2c, jframe,
                                          jnp.asarray(uv),
                                          jnp.asarray(fvalid), jgp)
    test = T.estimate_depths_from_frame(
        tcfg, T.PinholeCamera(*seq.camera), seq.lidar_to_cam("cpu"),
        to_port(jframe), torch.from_numpy(uv), torch.from_numpy(fvalid),
        to_port(jgp))
    return jest, test


def _assert_estimates_agree(test, jest):
    tc, jc = test.codes.numpy(), np.asarray(jest.codes)
    td, jd = test.depths.numpy(), np.asarray(jest.depths)
    agree = np.mean(tc == jc)
    assert agree >= 0.999, agree
    both = (tc == jc) & (jd > 0)
    rel = np.abs(td - jd)[both] / jd[both]
    assert rel.max() < 5e-3, rel.max()
    assert np.array_equal(test.depths.numpy() > 0, np.isin(
        tc, [int(R.Success), int(R.SuccessRoad),
             int(R.SuccessRegionGrowing)]))
    return tc, jc


@pytest.mark.parametrize("k,overrides", [
    (0, {"radiusSearch_count_min": 1}),
    (1, {"radiusSearch_count_min": 1, "do_use_ransac_plane": False}),
    (0, {}),
])
def test_estimator_region_growing_matches_jax(rendered, k, overrides):
    jest, test = _estimate_both(rendered, k, overrides, seed=30 + k)
    tc, jc = _assert_estimates_agree(test, jest)
    rg = int(R.SuccessRegionGrowing)
    assert (tc == rg).sum() > 10 and (jc == rg).sum() > 10
    print(f"region growing: {(tc == rg).sum()} / {(jc == rg).sum()} lanes "
          f"(port / JAX), codes agree on {np.mean(tc == jc):.5f}")


def test_estimator_region_hard_returns(rendered):
    """`no_seed` (enough neighbors, none of them... which needs
    radiusSearch_count_min = 0 and an empty window) gives
    HistogramNoLocalMax, and a nearest neighbor beyond treshold_depth_max
    gives TresholdDepthGlobalGreaterMax; both skip the road pass."""
    overrides = {"radiusSearch_count_min": 0, "treshold_depth_max": 30.0,
                 "do_use_histogram_segmentation": False}
    jest, test = _estimate_both(rendered, 0, overrides, seed=40)
    tc, jc = _assert_estimates_agree(test, jest)
    for code in (R.HistogramNoLocalMax, R.TresholdDepthGlobalGreaterMax,
                 R.SuccessRegionGrowing):
        assert (tc == int(code)).sum() > 0, code
        assert (jc == int(code)).sum() > 0, code
    assert np.array_equal(test.counters.numpy(), np.asarray(jest.counters))


def test_estimator_region_growing_integration():
    """The grid scene of tests/test_row_segmentation.py through
    `estimate_depths`, and both frames of a pair as two separate passes."""
    kw = dict(max_points=4096, max_features=8, image_width=W, image_height=H,
              do_use_ransac_plane=False, do_use_depth_segmentation=True,
              radiusSearch_count_min=1, ransac_num_hypotheses=64,
              ransac_subsample_points=256)
    jcfg, tcfg = J.DepthEstimatorConfig(**kw), T.DepthEstimatorConfig(**kw)
    cloud, valid, _ = _grid_cloud(nx=80, ny=24)
    feats = np.zeros((8, 2), np.float32)
    feats[0] = [W / 2, H / 2]
    feats[1] = [W / 2 + 30, H / 2 - 20]
    fvalid = np.zeros(8, bool)
    fvalid[:2] = True
    want = J.estimate_depths(jcfg, JCAM, J.SE3.identity(), jnp.asarray(cloud),
                             jnp.asarray(valid), jnp.asarray(feats),
                             jnp.asarray(fvalid), None)
    args = (torch.from_numpy(cloud), torch.from_numpy(valid),
            torch.from_numpy(feats), torch.from_numpy(fvalid))
    got = T.estimate_depths(tcfg, TCAM, T.SE3.identity("cpu"), *args)
    assert np.array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert (got.codes.numpy()[:2] == int(R.SuccessRegionGrowing)).all()
    np.testing.assert_allclose(got.depths.numpy(), np.asarray(want.depths),
                               rtol=1e-6)
    np.testing.assert_allclose(got.depths.numpy()[:2], 20.0, atol=0.1)

    gp = T.no_ground_plane(4096, "cpu")
    frame = T.rasterize_cloud(tcfg, TCAM, T.SE3.identity("cpu"), args[0],
                              args[1], gp)
    one = T.estimate_depths_from_frame(tcfg, TCAM, T.SE3.identity("cpu"),
                                       frame, args[2], args[3], gp)
    a, b = T.estimate_depths_pair(tcfg, TCAM, T.SE3.identity("cpu"), frame,
                                  args[2], args[3], gp, frame, args[2],
                                  args[3], gp)
    for est in (a, b):
        assert_trees_equal(state_to_numpy(est), state_to_numpy(one))
