"""``DQNTrainer.train(continue_run=True)`` (``cli train --continue-run``):
a run stopped at a checkpoint and continued gives the bits of one
unbroken run, where a plain resume replays the bank's refresh seeds from
the start.

A toy conv learner (L=1/M=8, 16 envs, a 32-row device bank refreshed every
5-step chunk with a quarter of forward rows, as the flagship recipe
refreshes its bank) runs 20 steps in one call, and 10 steps, a checkpoint
and 10 more: the logged rows, weights, target weights, moments, replay
ring, env states, generator and bank rows agree word for word."""

import pytest
import torch

from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

torch.set_num_threads(1)

REFRESH = {"device_refresh_every": 1, "device_forward_fraction": 0.25,
           "device_height": (4, 4), "log_fn": None}
# the row's clock readings differ from call to call
TIMED = ("steps_per_s", "learner_share")


def toy(**cfg_kw) -> DQNTrainer:
    cfg = TrainConfig(env=EnvConfig(L=1, M=8), num_envs=16, bank_capacity=32,
                      replay_capacity=1024, warmup_steps=32, updates_per_step=2,
                      log_every=5, total_steps=20, seed=0, **cfg_kw)
    bank = ConfigBank(1, 8, capacity=32, seed=0, device="cpu").fill_device(
        forward_fraction=0.25)
    net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                       generator=torch.Generator().manual_seed(0))
    return DQNTrainer(cfg, bank=bank, net=net, device="cpu")


def rows(history: list, offset: int = 0) -> list:
    return [{k: v + offset * 16 if k == "env_steps" else v + offset if k == "step"
             else v for k, v in r.items() if k not in TIMED} for r in history]


def words(tr: DQNTrainer) -> dict:
    ts = tr.state
    out = {f"net.{k}": v for k, v in ts.net.state_dict().items()}
    out.update({f"target.{k}": v for k, v in ts.target_net.state_dict().items()})
    for name in ("mu", "nu", "nu_max"):
        out.update({f"{name}.{i}": v for i, v in enumerate(getattr(ts.opt, name))})
    out.update({f"replay.{k}": v for k, v in ts.replay.buf.items()})
    out.update({f"env.{i}": v for i, v in enumerate(ts.env)})
    out["gen"] = ts.gen.get_state()
    out["bank.cols"], out["bank.pieces"] = tr.bank.rows
    return out


@pytest.fixture(scope="module")
def unbroken():
    tr = toy()
    return tr, tr.train(20, **REFRESH)["history"]


def _stopped(tmp_path) -> str:
    first = toy()
    first.train(10, **REFRESH)
    path = str(tmp_path / "step_10")
    first.save_checkpoint(path)
    return path


def test_continued_run_is_the_unbroken_run(unbroken, tmp_path):
    whole, history = unbroken
    path = _stopped(tmp_path)
    cont = toy()
    cont.restore_checkpoint(path)
    got = cont.train(10, continue_run=True, **REFRESH)["history"]
    assert rows(got, offset=10) == rows(history[2:])
    a, b = words(whole), words(cont)
    assert sorted(a) == sorted(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    ra, rb = whole.state.replay, cont.state.replay
    assert (ra.pos, ra.size) == (rb.pos, rb.size)
    assert (whole.state.global_step, whole.state.updates_done, whole.state.opt.count) == (
        cont.state.global_step, cont.state.updates_done, cont.state.opt.count)
    assert (whole.bank.family == cont.bank.family).all()


def test_plain_resume_replays_the_refresh_seeds(unbroken, tmp_path):
    """Without ``continue_run`` the resumed call's refreshes start the seed
    stream again, so its bank, and then its rows, are another run's."""
    whole, history = unbroken
    resumed = toy()
    resumed.restore_checkpoint(_stopped(tmp_path))
    got = resumed.train(10, **REFRESH)["history"]
    assert rows(got, offset=10) != rows(history[2:])
    assert not torch.equal(resumed.bank.rows[0], whole.bank.rows[0])


@pytest.mark.parametrize("case", ["adaptive", "demos", "producers", "height",
                                  "off-boundary", "off-refresh"])
def test_continue_run_refuses_what_a_checkpoint_does_not_carry(case):
    tr = toy(demo_every=1) if case == "demos" else toy()
    tr.state.global_step = 12 if case == "off-boundary" else 15
    kw = dict(REFRESH)
    if case == "adaptive":
        kw["adaptive_share"] = True
    elif case == "producers":
        kw["refresh_bank"] = True
    elif case == "height":
        kw["device_height"] = (8, 4)
    elif case == "off-refresh":
        kw["device_refresh_every"] = 2  # chunk 3 would read chunk 2's bank
    with pytest.raises(ValueError):
        tr.train(5, continue_run=True, **kw)
