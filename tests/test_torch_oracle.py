"""The literal numpy oracle of tests/test_pipeline_oracle.py against the
port's `estimate_depths`.

The oracle is a per-feature-loop transcription of the reference's depth
state machine in plain numpy; it shares no code with the JAX package or
with the port, so this holds the port's gather and cascade to the
reference's semantics without going through JAX.  Scenes, configurations
and bars are that file's: the same margin-respecting scene generator
with the same seeds, all eight `CONFIGS`, at most max(2, 1%) of codes
different, median relative depth error below 1e-5, at most max(1, 0.5%)
of depths beyond 5e-3 and none beyond 0.1.  No configuration of
`CONFIGS` turns on `do_use_depth_segmentation`, which the port still
raises on, so none is left out.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from test_pipeline_oracle import CAM, CONFIGS, _make_scene, oracle_estimate
from torch_parity import to_port
import mono_lidar_depth_tpu_torch as T

TCAM = T.PinholeCamera(width=CAM.width, height=CAM.height,
                       focal_length=CAM.focal_length, cx=CAM.cx, cy=CAM.cy)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_matches_literal_oracle(name):
    jcfg = CONFIGS[name]
    cfg = T.DepthEstimatorConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    total = mismatched = 0
    rels = []
    for _ in range(4):
        cloud, valid, feats, fvalid, gp, _, T_R, T_t = _make_scene(
            rng, jcfg, CAM)
        l2c = T.SE3(torch.from_numpy(T_R.astype(np.float32)),
                    torch.from_numpy(T_t.astype(np.float32)))
        out = T.estimate_depths(
            cfg, TCAM, l2c, torch.from_numpy(cloud), torch.from_numpy(valid),
            torch.from_numpy(feats), torch.from_numpy(fvalid), to_port(gp))
        got_codes, got_depths = out.codes.numpy(), out.depths.numpy()
        want_codes, want_depths = oracle_estimate(
            jcfg, CAM, T_R, T_t, cloud, valid, feats, fvalid, gp)
        agree = got_codes == want_codes
        total += int(fvalid.sum())
        mismatched += int((~agree & fvalid).sum())
        both_ok = agree & fvalid & (want_depths > 0) & (got_depths > 0)
        if both_ok.any():
            err = np.abs(got_depths[both_ok] - want_depths[both_ok])
            rels.append(err / np.maximum(want_depths[both_ok], 1.0))
    assert total > 400
    assert mismatched <= max(2, int(0.01 * total)), (name, mismatched, total)
    rels = np.concatenate(rels)
    assert len(rels) > 20
    assert float(np.median(rels)) < 1e-5, (name, float(np.median(rels)))
    n_big = int((rels > 5e-3).sum())
    assert n_big <= max(1, int(0.005 * len(rels))), (
        name, n_big, len(rels), float(rels.max()))
    assert float(rels.max()) < 0.1, (name, float(rels.max()))
