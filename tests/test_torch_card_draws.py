"""scripts/card_draws_torch.py on the CPU: draws saved from a device and
replayed from the file give that device's own run.

On a card `save` keeps the card generator's draws; here the CPU's
generator stands in for it, at 8 frames of the record's sequence, and
`replay` must give the ATE and RPE of the CPU's own run of those frames.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import card_draws_torch as C  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per worker)


def test_saved_draws_replay_the_run(tmp_path, monkeypatch):
    monkeypatch.setattr(C, "FRAMES", 8)
    path = tmp_path / "draws.npz"
    C.save(path, "cpu")
    z = np.load(path)
    cfg = C.P.record_config()
    assert z["sub_idx"].shape == (8, cfg.ransac_subsample_points)
    assert z["picks"].shape == (8, cfg.ransac_num_hypotheses, 3)
    got = C.replay(path)
    seq = C.P.render_sequence(C.P.record_spec(8))
    own = C.P.vo_metrics(C.P.eval_vo_sequence(
        seq, cfg, C.P.OdometryConfig(), device="cpu", **C.P.VO_KW))
    assert {k: got[k] for k in own} == own
    assert got["draws_torch"] == str(z["torch"])
