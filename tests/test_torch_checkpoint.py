"""Checkpoint / resume of the port's state (io/checkpoint.py): the three
tests of tests/test_checkpoint.py on the port's states, the key paths
against `jax.tree_util.keystr`, and state carried across the packages: a
file that the JAX package wrote after k frames loads into the port's own
fresh carry with every leaf equal to `state_from_numpy` of the JAX carry,
and a file that the port wrote loads into the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu as J
import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu.eval import kitti_eval as jeval
from mono_lidar_depth_tpu.io import checkpoint as jckpt
from mono_lidar_depth_tpu.io import synthetic_dataset as jsyn
from mono_lidar_depth_tpu.io.kitti import KittiSequence as JKittiSequence
from mono_lidar_depth_tpu.tracker import frontend as jfrontend
from mono_lidar_depth_tpu.vo import pipeline as jvo
from mono_lidar_depth_tpu_torch.convert import (state_from_numpy,
                                                state_to_numpy)
from mono_lidar_depth_tpu_torch.io import checkpoint as tckpt
from mono_lidar_depth_tpu_torch.io import synthetic_dataset as tsyn

from torch_parity import assert_trees_equal, to_numpy

CFG = dict(max_points=1024, max_features=32, image_width=128,
           image_height=64, ransac_num_hypotheses=64,
           ransac_subsample_points=256)
TCFG = T.DepthEstimatorConfig(**CFG)
JCFG = J.DepthEstimatorConfig(**CFG)


def _leaves(tree):
    return [leaf for _, leaf in tckpt._flatten(tree)]


def test_roundtrip_odometry_state(tmp_path):
    state = T.OdometryState.create(TCFG, T.OdometryConfig(), 64, 8, "cpu")
    win_t = state.win_t.clone()
    win_t[0] = torch.tensor([1.0, 2.0, 3.0])
    state = state._replace(frame_idx=torch.tensor(17, dtype=torch.int32),
                           win_t=win_t)
    p = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(p, state, {"frame": 17, "seq": "00"})
    like = T.OdometryState.create(TCFG, T.OdometryConfig(), 64, 8, "cpu")
    restored, meta = tckpt.load_checkpoint(p, like)
    assert meta == {"frame": 17, "seq": "00"}
    assert int(restored.frame_idx) == 17 and restored.frame_idx.shape == ()
    assert restored.win_t[0].tolist() == [1.0, 2.0, 3.0]
    assert type(restored) is T.OdometryState
    assert type(restored.tracklets.frame_last) is type(like.tracklets.frame_last)
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert a.device == b.device and torch.equal(a, b)


def test_shape_mismatch_rejected(tmp_path):
    state = T.TrackletDepthState.create(TCFG, 64, 8, "cpu")
    p = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(p, state)
    wrong = T.TrackletDepthState.create(TCFG, 32, 8, "cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(p, wrong)


def test_atomic_overwrite(tmp_path):
    state = T.TrackletDepthState.create(TCFG, 64, 8, "cpu")
    p = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(p, state, {"v": 1})
    tckpt.save_checkpoint(p, state, {"v": 2})
    _, meta = tckpt.load_checkpoint(p, state)
    assert meta["v"] == 2
    assert os.listdir(tmp_path) == ["ckpt.npz"]  # no temporary file left

    class Unsavable:
        def __array__(self, *a, **k):
            raise RuntimeError("no array")

    with pytest.raises(RuntimeError):
        tckpt.save_checkpoint(p, {"x": Unsavable()})
    _, meta = tckpt.load_checkpoint(p, state)
    assert meta["v"] == 2 and os.listdir(tmp_path) == ["ckpt.npz"]


def test_key_paths_are_jax_keystr():
    """NamedTuple fields, tuple and list indices, dict keys (sorted) and
    None, nested: the same paths in the same order as jax.tree_util."""
    jstate = jvo.OdometryState.create(JCFG, jvo.OdometryConfig(), 16, 4)
    tstate = T.OdometryState.create(TCFG, T.OdometryConfig(), 16, 4, "cpu")

    def nest(state, arr):
        return ({"b": [arr(1), (arr(2), None)], "a": state},
                (None, arr(4)), [], arr(5))

    jtree = nest(jstate, lambda v: jnp.full((2,), v))
    ttree = nest(tstate, lambda v: torch.full((2,), v))
    kp, _ = jax.tree_util.tree_flatten_with_path(jtree)
    want = [jax.tree_util.keystr(k) for k, _ in kp]
    got = [p for p, _ in tckpt._flatten(ttree)]
    assert got == want and "[0]['a'].tracklets.table.uv" in got
    assert "[0]['b'][1][0]" in got and got[-2:] == ["[1][1]", "[3]"]
    # the whole carry of the sequence evaluators
    jcarry = (jfrontend.init_tracker(jnp.zeros((64, 128)), 32, levels=4),
              jstate)
    tcarry = (T.init_tracker(torch.zeros((64, 128)), 32, levels=4), tstate)
    kp, _ = jax.tree_util.tree_flatten_with_path(jcarry)
    want = [jax.tree_util.keystr(k) for k, _ in kp]
    assert [p for p, _ in tckpt._flatten(tcarry)] == want
    assert "[0].pyramid[3]" in want and "[1].motion_ok" in want
    # unflatten restores what flatten took apart
    leaves = _leaves(ttree)
    again = tckpt._unflatten(ttree, list(leaves))
    assert type(again) is tuple and type(again[0]["a"]) is T.OdometryState
    assert again[1][0] is None and again[2] == []
    assert all(a is b for a, b in zip(_leaves(again), leaves))


def test_missing_and_extra_fields(tmp_path):
    """A field that `like` has and the file lacks: an error, or the value
    of `like` with allow_missing_trailing; a stored field that `like`
    lacks is ignored; a positional file (no key paths) loads too."""
    p = str(tmp_path / "c.npz")
    tckpt.save_checkpoint(p, {"a": torch.ones(3), "c": torch.zeros(2)})
    like = {"a": torch.zeros(3), "b": torch.full((2,), 7.0)}
    with pytest.raises(ValueError, match="missing leaf"):
        tckpt.load_checkpoint(p, like)
    got, _ = tckpt.load_checkpoint(p, like, allow_missing_trailing=True)
    assert got["a"].tolist() == [1, 1, 1] and got["b"].tolist() == [7, 7]
    assert set(got) == {"a", "b"}
    # dtype follows `like`; numpy leaves stay numpy
    got, _ = tckpt.load_checkpoint(p, {"a": np.zeros(3, np.int64)})
    assert isinstance(got["a"], np.ndarray) and got["a"].dtype == np.int64
    np.savez(p, leaf_0=np.arange(3.0), leaf_1=np.ones(2))
    got, meta = tckpt.load_checkpoint(p, (torch.zeros(3), torch.zeros(2)))
    assert meta == {} and got[0].tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="expected 3"):
        tckpt.load_checkpoint(p, (torch.zeros(3), torch.zeros(2),
                                  torch.zeros(1)))
    got, _ = tckpt.load_checkpoint(
        p, (torch.zeros(3), torch.zeros(2), torch.full((1,), 5.0)),
        allow_missing_trailing=True)
    assert got[2].tolist() == [5.0]


SPEC = dict(frames=5, image_width=256, image_height=96, focal=160.0,
            lidar_rows=16, lidar_cols=300, step=0.55)
SEQ_CFG = dict(max_points=8192, max_features=256, image_width=256,
               image_height=96, radiusSearch_count_min=1,
               ransac_num_hypotheses=128, ransac_subsample_points=512)


@pytest.fixture(scope="module")
def carries(tmp_path_factory):
    """The (tracker, odometry) carry after 4 processed frames of the same
    sequence, from each package's `eval_vo_sequence`."""
    root = str(tmp_path_factory.mktemp("kitti_ckpt"))
    jsyn.generate_kitti_sequence(root, "95", jsyn.SyntheticSpec(**SPEC))
    jseq = JKittiSequence(root, "95", image_width=256, image_height=96)
    jout = jeval.eval_vo_sequence(jseq, J.DepthEstimatorConfig(**SEQ_CFG),
                                  max_tracks=256, max_length=6,
                                  verbose=False, return_carry=True)
    tseq = tsyn.render_sequence(tsyn.SyntheticSpec(**SPEC))
    tout = T.eval_vo_sequence(tseq, T.DepthEstimatorConfig(**SEQ_CFG),
                              max_tracks=256, max_length=6, verbose=False,
                              return_carry=True, device="cpu")
    return jout["carry"], tout["carry"]


def _fresh_port_carry():
    cfg = T.DepthEstimatorConfig(**SEQ_CFG)
    return (T.init_tracker(torch.zeros((96, 256)), 256, levels=4),
            T.OdometryState.create(cfg, T.OdometryConfig(), 256, 6, "cpu"))


def _fresh_jax_carry():
    cfg = J.DepthEstimatorConfig(**SEQ_CFG)
    return (jfrontend.init_tracker(jnp.zeros((96, 256)), 256, levels=4),
            jvo.OdometryState.create(cfg, jvo.OdometryConfig(), 256, 6))


def test_jax_checkpoint_loads_into_the_port(tmp_path, carries):
    jcarry, _ = carries
    p = str(tmp_path / "jax_carry.npz")
    jckpt.save_checkpoint(p, jcarry, {"next_frame": 5, "by": "jax"})
    got, meta = tckpt.load_checkpoint(p, _fresh_port_carry())
    assert meta == {"next_frame": 5, "by": "jax"}
    want = state_from_numpy(to_numpy(jcarry), "cpu")
    assert type(got[0]) is T.TrackerState and type(got[1]) is T.OdometryState
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l) == len(jax.tree.leaves(jcarry))
    for a, b in zip(got_l, want_l):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert int(got[1].frame_idx) == 4 and bool(got[1].motion_ok)


def test_port_checkpoint_loads_into_jax(tmp_path, carries):
    _, tcarry = carries
    p = str(tmp_path / "port_carry.npz")
    tckpt.save_checkpoint(p, tcarry, {"next_frame": 5, "by": "port"})
    got, meta = jckpt.load_checkpoint(p, _fresh_jax_carry())
    assert meta == {"next_frame": 5, "by": "port"}
    assert_trees_equal(state_to_numpy(tcarry), to_numpy(got))
    for a, b in zip(jax.tree.leaves(got), _leaves(tcarry)):
        assert np.asarray(a).dtype == b.numpy().dtype
    # and back into the port through the JAX package's writer
    p2 = str(tmp_path / "back.npz")
    jckpt.save_checkpoint(p2, got)
    back, _ = tckpt.load_checkpoint(p2, _fresh_port_carry())
    for a, b in zip(_leaves(back), _leaves(tcarry)):
        assert torch.equal(a, b)
    size = os.path.getsize(p)
    assert 1e4 < size < 5e6
