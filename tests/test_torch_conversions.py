"""The port's track-record conversions (conversions/convert.py): copies of
tests/test_conversions.py, each also against the JAX package's function
on the same inputs (equal outputs; the numpy functions are the same code,
the label vote is PyTorch)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mono_lidar_depth_tpu import conversions as J
from mono_lidar_depth_tpu.io.messages import FeatureTracks as JFeatureTracks
from mono_lidar_depth_tpu_torch import conversions as T
from mono_lidar_depth_tpu_torch.io.messages import FeatureTracks

import torch_parity  # noqa: F401  (one torch thread per worker)


def _tracks(n=4, L=3, cls=FeatureTracks):
    rng = np.random.default_rng(0)
    return cls(
        uv=rng.uniform(0, 100, (n, L, 2)).astype(np.float32),
        depth=rng.uniform(1, 50, (n, L)).astype(np.float32),
        length=np.array([3, 2, 3, 1]),
        track_id=np.array([10, 11, 12, 13]),
        age=np.array([2, 1, 2, 0]),
        stamps=np.array([2.0, 1.0, 0.0]))


def _same(got, want):
    """Two FeatureTracks (the port's and the JAX package's) field by
    field."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_add_outlier_flags_default_shim():
    t = _tracks()
    out = T.add_outlier_flags(t)
    assert out.is_outlier is not None
    assert not out.is_outlier.any()
    np.testing.assert_array_equal(out.uv, t.uv)
    np.testing.assert_array_equal(out.track_id, t.track_id)
    _same(out, J.add_outlier_flags(_tracks(cls=JFeatureTracks)))
    flags, err = np.array([1, 0, 1, 0], bool), np.array([1.5, 0, 2, 0])
    _same(T.add_outlier_flags(t, flags, err),
          J.add_outlier_flags(_tracks(cls=JFeatureTracks), flags, err))


def test_add_outlier_flags_size_mismatch():
    for fn, cls in ((T.add_outlier_flags, FeatureTracks),
                    (J.add_outlier_flags, JFeatureTracks)):
        with pytest.raises(ValueError):
            fn(_tracks(cls=cls), is_outlier=np.zeros(3, bool))
        with pytest.raises(ValueError):
            fn(_tracks(cls=cls), error=np.zeros(3))


def test_lift_to_depth():
    t = _tracks()
    lifted = T.lift_to_depth(t.uv, t.length, t.track_id, t.age, t.stamps)
    assert (lifted.depth == -1).all()
    np.testing.assert_array_equal(lifted.uv, t.uv)
    _same(lifted, J.lift_to_depth(t.uv, t.length, t.track_id, t.age,
                                  t.stamps))


def _permuted_flags(cls, add):
    flagged = add(_tracks(cls=cls),
                  is_outlier=np.array([True, False, True, False]),
                  error=np.array([1.5, 0.0, 2.5, 0.0]))
    perm = np.array([2, 0, 3, 1])
    return cls(
        uv=flagged.uv[perm], depth=flagged.depth[perm],
        length=flagged.length[perm], track_id=flagged.track_id[perm],
        age=flagged.age[perm], stamps=flagged.stamps,
        is_outlier=flagged.is_outlier[perm], error=flagged.error[perm])


def test_mark_depth_outlier_zips_by_id():
    t = _tracks()
    out = T.mark_depth_outlier(t, _permuted_flags(FeatureTracks,
                                                  T.add_outlier_flags))
    np.testing.assert_array_equal(out.is_outlier, [True, False, True, False])
    np.testing.assert_allclose(out.error, [1.5, 0.0, 2.5, 0.0])
    np.testing.assert_array_equal(out.depth, t.depth)
    _same(out, J.mark_depth_outlier(
        _tracks(cls=JFeatureTracks),
        _permuted_flags(JFeatureTracks, J.add_outlier_flags)))


def test_mark_depth_outlier_missing_track_raises():
    for fn, add, cls in ((T.mark_depth_outlier, T.add_outlier_flags,
                          FeatureTracks),
                         (J.mark_depth_outlier, J.add_outlier_flags,
                          JFeatureTracks)):
        flagged = add(_tracks(cls=cls))
        flagged.track_id[0] = 999
        with pytest.raises(ValueError):
            fn(_tracks(cls=cls), flagged)
        with pytest.raises(ValueError):
            fn(_tracks(cls=cls), _tracks(cls=cls))  # no flags


def _labels(uv, valid, img, **kw):
    got = T.semantic_labels_for_tracks(torch.from_numpy(uv),
                                       torch.from_numpy(valid),
                                       torch.from_numpy(img), **kw)
    want = np.asarray(J.semantic_labels_for_tracks(
        jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(img), **kw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def test_semantic_labels_roi_argmax():
    img = np.zeros((64, 64), np.int32)
    img[10:20, 10:20] = 7  # road patch
    img[15, 15] = 3  # single other label inside the ROI
    uv = np.array([[15.0, 15.0], [50.0, 50.0]], np.float32)
    labels = _labels(uv, np.array([True, True]), img, roi=5)
    assert labels[0] == 7 and labels[1] == 0
    labels2 = _labels(uv, np.array([True, False]), img, roi=5)
    assert labels2[1] == -1


def test_semantic_labels_match_jax_everywhere():
    """Random labels, ties, borders, positions past the image and NaN,
    several ROI sizes and a label histogram smaller than the labels."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 12, (48, 80)).astype(np.int32)
    img[:8, :8] = 3
    uv = np.concatenate([
        rng.uniform(-10, 90, (200, 2)),
        [[0, 0], [79.9, 47.9], [-3.5, 20], [200, 100], [np.nan, 5],
         [4.0, 4.0]]]).astype(np.float32)
    valid = rng.random(len(uv)) < 0.9
    for roi in (1, 3, 5, 7):
        _labels(uv, valid, img, roi=roi)
    _labels(uv, valid, img, roi=5, num_labels=8)


def test_newest_pair_points():
    t = _tracks()
    cur, prev, ids = T.newest_pair_points(t)
    assert set(ids.tolist()) == {10, 11, 12}
    np.testing.assert_array_equal(cur, t.uv[t.length >= 2, 0])
    np.testing.assert_array_equal(prev, t.uv[t.length >= 2, 1])
    for a, b in zip((cur, prev, ids), J.newest_pair_points(
            _tracks(cls=JFeatureTracks))):
        np.testing.assert_array_equal(a, b)


def test_feature_tracks_roundtrip(tmp_path):
    t = T.add_outlier_flags(_tracks(), is_outlier=np.array([1, 0, 0, 1],
                                                           bool))
    p = str(tmp_path / "tracks.npz")
    t.save(p)
    t2 = FeatureTracks.load(p)
    np.testing.assert_array_equal(t2.uv, t.uv)
    np.testing.assert_array_equal(t2.is_outlier, t.is_outlier)
    s, f = t2.success_fail_counts()
    assert s + f == int(t.length.sum())
    _same(JFeatureTracks.load(p), t2)  # the JAX loader reads the file
