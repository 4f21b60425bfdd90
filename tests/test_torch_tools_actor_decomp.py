"""The port's tools run end to end at tiny sizes on the CPU:
``tools/actor_decomp.py`` (the decomposition of the per-step chunk). The
numbers are CPU numbers and mean nothing; the shapes of the results are
checked."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import actor_decomp  # noqa: E402

torch.set_num_threads(1)


def test_actor_decomp_small(monkeypatch):
    monkeypatch.setattr(actor_decomp, "SCAN", 2)
    res = actor_decomp.decompose(
        actor_decomp.parse(["--num-envs", "32", "--batch", "16"]), device="cpu")
    rates = ("env_only", "rollout_kernel", "actor", "actor_replay", "full_u1", "full_u4")
    assert all(res[k] > 0 for k in rates)
    assert set(res["cost_us"]) == {"env", "net_forward+obs", "replay_write",
                                   "replay+learn_u1", "learn_u1", "extra_3_updates"}
    assert res["scan"] == 2 and res["device"] == "cpu"
