"""scripts/step_split_torch.py on the CPU: config 3's steps traced stage by
stage, and the op-by-op replay of a stage that parts.

Both devices are the CPU here, so nothing parts by itself: the test
rounds one row of the first run's road-plane normal one ulp away, as a
card would part, and the script must name that stage, that row and
replay the port's float64 fit op by op without finding an op that parts
(the function's own ops agree on one device).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import step_split_torch as S  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per worker)


@pytest.fixture(scope="module")
def small():
    """The record's sequence at 4 frames and the carry after frame 1."""
    seq = S.P.render_sequence(S.P.record_spec(4))
    cfg = S.P.record_config()
    first = S.P.eval_vo_sequence(seq, cfg, S.P.OdometryConfig(),
                                 max_frames=2, return_carry=True,
                                 device="cpu", **S.P.VO_KW)
    return seq, cfg, first["carry"]


def test_equal_steps_part_nowhere(small):
    """The same step twice on the CPU: every stage's inputs and outputs
    equal, every stage of the depth association traced in call order."""
    seq, cfg, carry = small
    r = S.split_frame(seq, cfg, 2, carry, "cpu")
    names = [e["stage"] for e in r["stages"]]
    assert r["first"] is None and r["calls"][0] == r["calls"][1]
    assert all(e["inputs_equal"] and e["outputs_equal"] for e in r["stages"])
    for name in ("track_frame", "_ls_plane", "plane_to_camera",
                 "max_spanning_triangle", "mestimator_plane", "_scatter3",
                 "_road_pass", "process_frame"):
        assert name in names, name
    assert names.index("_scatter3") < names.index("mestimator_plane")


def test_a_parting_fit_is_replayed_op_by_op(small, monkeypatch):
    """One road lane's normal one ulp apart on the first device: the
    split names mestimator_plane and that lane, and its op chain (the
    float64 fit's own ops, on the CPU twice) finds no op that parts."""
    seq, cfg, carry = small
    real, runs = S._traced_step, []

    def traced_step(*args):
        t = real(*args)
        runs.append(t)
        if len(runs) == 1:
            for k, (name, a, out) in enumerate(t.order):
                if name == "mestimator_plane":
                    normal = out.normal.copy()
                    normal[3] = np.nextafter(normal[3], np.float32(2))
                    t.order[k] = (name, a, out._replace(normal=normal))
        return t

    monkeypatch.setattr(S, "_traced_step", traced_step)
    r = S.split_frame(seq, cfg, 2, carry, "cpu")
    entry = next(e for e in r["stages"] if e["stage"] == "mestimator_plane")
    assert r["first"] == {"stage": "mestimator_plane", "row": 3, "op": None}
    assert entry["inputs_equal"] and entry["outputs_ulp"] == 1
    assert entry["ops"] > 20 and entry["parting_ops"] == []
    assert entry["chain"].endswith("ulp (first op to part: none)")
