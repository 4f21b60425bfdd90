"""Port trainer end to end on the CPU: the fused and per-step chunks, the
checkpoint round trip, evaluation and ``cli train --smoke``.

The fused-chunk counters are those of tests/test_pallas_actor.py's trainer
test (K-step phases, K * updates learner updates per phase, K replay
blocks of num_envs transitions each)."""

import numpy as np
import pytest
import torch

from tetris_piclim_tpu_torch import cli
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
from tetris_piclim_tpu_torch.models.qnet import QNetwork
from tetris_piclim_tpu_torch.utils.checkpoint import restore_bank, save_bank
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _cfg(fusion: int, **kw) -> TrainConfig:
    kw.setdefault("dqn", DQNConfig(batch_size=32))
    return TrainConfig(
        env=EnvConfig(L=1, M=6), actor_fusion=fusion, num_envs=16,
        bank_capacity=16, replay_capacity=512, warmup_steps=4, total_steps=16,
        log_every=8, seed=0, **kw)


def _trainer(fusion: int, **kw) -> DQNTrainer:
    bank = ConfigBank(1, 6, capacity=16, seed=0, device="cpu").fill_device()
    return DQNTrainer(_cfg(fusion, **kw), bank=bank, device="cpu")


@pytest.mark.parametrize("fusion", [0, 4])
def test_trainer_counters(fusion):
    tr = _trainer(fusion)
    out = tr.train(log_fn=None)
    assert tr.state.global_step == 16
    assert tr.state.updates_done > 0
    assert tr.state.replay.size == 16 * 16
    rows = out["history"]
    assert len(rows) == 2
    for r in rows:
        assert r["episodes"] >= 0 and np.isfinite(r["reward"])
        assert np.isfinite(r["loss"]) and np.isfinite(r["q_mean"])
    # a fused phase runs K updates at once: 16 steps = 4 phases, learning
    # from the first phase on (warmup 4 < 4*16 transitions)
    if fusion:
        assert tr.state.updates_done == 16
    ev = tr.evaluate(n_episodes=32)
    assert ev["unfinished"] == 0.0
    assert abs(ev["win_rate"] + ev["loss_rate"] - 1.0) < 1e-9


def test_checkpoint_roundtrip_resumes_identically(tmp_path):
    a = _trainer(4)
    a.train(total_steps=8, log_fn=None)
    path = a.save_checkpoint(str(tmp_path / "ck"))
    save_bank(path, a.bank)
    b = _trainer(4)
    b.restore_checkpoint(path)
    b.bank = restore_bank(path, "cpu")
    assert b.state.global_step == 8 and b.state.updates_done == a.state.updates_done
    ra = a.train(total_steps=8, log_fn=None)["history"][-1]
    rb = b.train(total_steps=8, log_fn=None)["history"][-1]
    for key in ("episodes", "wins", "lines", "reward", "loss"):
        assert ra.get(key) == rb.get(key), key
    for pa, pb in zip(a.state.net.parameters(), b.state.net.parameters()):
        assert torch.equal(pa, pb)


def test_unported_options_raise():
    """The JAX trainer's refusals stay refusals: demonstrations with PER or
    with the fused actor, and the fused actor with any net but the plain
    MLP (tetris_piclim_tpu/dqn/train.py:150-159, 204-218)."""
    with pytest.raises(ValueError, match="PER"):
        _trainer(0, demo_every=2, dqn=DQNConfig(batch_size=32, prioritized=True))
    with pytest.raises(ValueError, match="actor_fusion=0"):
        _trainer(4, demo_every=2)
    bank = ConfigBank(1, 6, capacity=16, seed=0, device="cpu").fill_device()
    for net in (QNetwork(dueling=True), ConvQNetwork(channels=(4, 8))):
        with pytest.raises(ValueError, match="non-dueling"):
            DQNTrainer(_cfg(4), bank=bank, net=net, device="cpu")


def test_cli_train_smoke(capsys):
    assert cli.main(["train", "--smoke", "--device", "cpu", "--device-bank",
                     "--actor-fusion", "4"]) == 0
    out = capsys.readouterr().out
    assert '"train_bank"' in out and '"win_rate"' in out
