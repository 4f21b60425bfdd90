"""The port's trainer with the README's recipe, end to end on the CPU at a
tiny size: the conv dueling joint net with bf16 moments, demonstrations with
the DQfD margin, the adaptive share and the device refresh; n-step returns
with prioritized replay on both chunk paths; ``cli train --smoke`` with the
flagship flags; and checkpoint round trips (conv with bf16 moments, demos
on -> off and off -> on, and a checkpoint written before priorities were
kept)."""

import math

import numpy as np
import pytest
import torch

from tetris_piclim_tpu_torch import cli
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer, adapt_share_v2
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

L, M = 1, 6


def _cfg(**kw) -> TrainConfig:
    base = dict(env=EnvConfig(L=L, M=M), dqn=DQNConfig(batch_size=32),
                num_envs=16, bank_capacity=32, replay_capacity=512,
                warmup_steps=4, total_steps=24, log_every=8, seed=0)
    base.update(kw)
    return TrainConfig(**base)


def _flagship(**kw) -> DQNTrainer:
    """conv (4, 8) + dueling + joint with bf16 moments, 2 updates per step,
    demonstrations (margin 0.8) rebuilt every chunk."""
    cfg = _cfg(dqn=DQNConfig(batch_size=32, opt_state_bf16=True),
               updates_per_step=2, demo_every=1, demo_rows=32, demo_capacity=64,
               demo_margin=0.8, **kw)
    bank = ConfigBank(L, M, capacity=32, seed=0, device="cpu").fill_device(
        forward_fraction=0.25)
    net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                       generator=torch.Generator().manual_seed(0))
    return DQNTrainer(cfg, bank=bank, net=net, device="cpu")


def test_flagship_recipe_trains():
    tr = _flagship()
    out = tr.train(log_fn=None, device_refresh_every=1, device_forward_fraction=0.25,
                   device_height=(8, 4), adaptive_share=True, adapt_every=1,
                   adapt_episodes=32)
    rows = out["history"]
    assert len(rows) == 3 and all(math.isfinite(r["loss"]) for r in rows)
    # learning from the second step on (32 transitions = one batch)
    assert tr.state.updates_done == 2 * (24 - 1)
    # the controller: each logged share is adapt_share_v2 of the logged probes
    share = 0.25
    assert rows[0]["forward_share"] == share and "probe_carve" not in rows[0]
    for r in rows[1:]:
        share = adapt_share_v2(share, r["probe_carve"], r["probe_forward"])
        assert r["forward_share"] == round(share, 4)
    d = tr._demo
    assert d.size == 64 and d.buf["done"].all()
    assert all(m.dtype == torch.bfloat16 for m in tr.state.opt.mu + tr.state.opt.nu_max)
    ev = tr.evaluate(n_episodes=32)
    assert ev["unfinished"] == 0.0


@pytest.mark.parametrize("fusion", [0, 4])
def test_nstep_per_trainer(fusion):
    bank = ConfigBank(L, M, capacity=32, seed=0, device="cpu").fill_device()
    cfg = _cfg(dqn=DQNConfig(batch_size=32, n_step=3, prioritized=True),
               actor_fusion=fusion, total_steps=16)
    tr = DQNTrainer(cfg, bank=bank, device="cpu")
    rows = tr.train(log_fn=None)["history"]
    assert all(math.isfinite(r["loss"]) for r in rows)
    # learning starts at max(warmup, batch) + (n - 1) * num_envs = 64
    # transitions: after the 4th step, or with the fused actor after the
    # first 4-step phase, whose 4 * 4 updates then run at once
    assert tr.state.updates_done == (16 - 3 if fusion == 0 else 16)
    prio = tr.state.replay.priority[:tr.state.replay.size]
    assert tr.state.replay.size == 16 * 16 and (prio > 0).all()
    # sampled slots were rewritten with |td| + eps, off the fresh value 1
    assert int((prio != 1.0).sum()) > 0
    assert float(tr.state.replay.max_prio) >= 1.0


def test_cli_train_smoke_flagship_flags(capsys):
    assert cli.main([
        "train", "--smoke", "--device", "cpu", "--model", "conv", "--dueling",
        "--joint", "--channels", "4,8", "--batch", "16", "--opt-bf16",
        "--device-bank", "--device-refresh", "1", "--device-forward", "0.25",
        "--device-height", "8:4", "--demo-every", "1", "--demo-margin", "0.8",
        "--adaptive-share", "--adapt-every", "2"]) == 0
    out = capsys.readouterr()
    assert '"train_bank"' in out.out and '"win_rate"' in out.out
    assert "probe_c=" in out.err and "share=" in out.err


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_checkpoint_conv_bf16_resumes_identically(tmp_path):
    a = _flagship()
    a.train(total_steps=8, log_fn=None)
    path = a.save_checkpoint(str(tmp_path / "ck"))
    b = _flagship()
    b.restore_checkpoint(path)
    assert b.state.opt.count == a.state.opt.count > 0
    for x, y in zip(a.state.opt.nu_max, b.state.opt.nu_max):
        assert y.dtype == torch.bfloat16 and torch.equal(x, y)
    ra = a.train(total_steps=8, log_fn=None)["history"][-1]
    rb = b.train(total_steps=8, log_fn=None)["history"][-1]
    for key in ("episodes", "win_rate", "lines", "reward", "loss"):
        assert ra[key] == rb[key], key
    assert _params_equal(a.state.net, b.state.net)
    assert _params_equal(a.state.target_net, b.state.target_net)
    assert a.evaluate(32) == b.evaluate(32)


@pytest.mark.parametrize("demos_before,demos_after", [(False, True), (True, False)])
def test_checkpoint_resumes_with_demos_toggled(tmp_path, demos_before, demos_after):
    """The demo buffer lives outside the checkpointed state, so a run
    resumes with demonstrations switched on or off."""
    def trainer(demos):
        kw = dict(demo_every=2, demo_rows=32, demo_capacity=64) if demos else {}
        bank = ConfigBank(L, M, capacity=32, seed=0, device="cpu").fill_device()
        return DQNTrainer(_cfg(**kw), bank=bank, device="cpu")

    a = trainer(demos_before)
    a.train(total_steps=8, log_fn=None)
    path = a.save_checkpoint(str(tmp_path / "ck"))
    b = trainer(demos_after)
    b.restore_checkpoint(path)
    assert _params_equal(a.state.net, b.state.net)
    b.train(total_steps=8, log_fn=None)
    assert b.state.global_step == 16
    assert (b._demo is not None and b._demo.size == 64) == demos_after


def test_checkpoint_without_priorities_still_loads(tmp_path):
    """A checkpoint written before the replay kept priorities (an MLP with
    float32 moments and a replay state of buffers, pos and size) restores;
    a prioritized trainer sees every written slot at priority 1."""
    bank = ConfigBank(L, M, capacity=32, seed=0, device="cpu").fill_device()
    a = DQNTrainer(_cfg(), bank=bank, device="cpu")
    a.train(total_steps=8, log_fn=None)
    path = a.save_checkpoint(str(tmp_path / "ck"))
    sd = torch.load(f"{path}/state.pt", weights_only=True)
    sd["replay"] = {k: sd["replay"][k] for k in ("buf", "pos", "size")}
    torch.save(sd, f"{path}/state.pt")
    for dqn in (DQNConfig(batch_size=32), DQNConfig(batch_size=32, prioritized=True)):
        b = DQNTrainer(_cfg(dqn=dqn), bank=bank, device="cpu")
        b.restore_checkpoint(path)
        assert _params_equal(a.state.net, b.state.net)
        rpl = b.state.replay
        assert rpl.size == 128
        np.testing.assert_array_equal(rpl.priority.numpy()[:128], 1.0)
        assert not rpl.priority[128:].any() and float(rpl.max_prio) == 1.0
        b.train(total_steps=8, log_fn=None)
        assert b.state.global_step == 16
