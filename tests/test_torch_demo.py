"""Port demonstrations and adaptive share against the JAX trainer: the demo
rollout of one prover batch fills the same buffer, word for word; the
adaptive-share controllers give the same shares; the host's seeds for the
probes, the bank refresh and the demo refresh come from the JAX trainer's
stream in its order (``tetris_piclim_tpu/dqn/train.py:711-747``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.dqn import train as jtrain
from tetris_piclim_tpu.gen.bank import ConfigBank as JConfigBank
from tetris_piclim_tpu.utils.config import (DQNConfig as JDQNConfig,
                                            EnvConfig as JEnvConfig,
                                            TrainConfig as JTrainConfig)
from tetris_piclim_tpu_torch.dqn import train as ttrain
from tetris_piclim_tpu_torch.dqn.train import ChunkMetrics, DQNTrainer
from tetris_piclim_tpu_torch.gen import device_forward as tf
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

L, M = 1, 8


def _cfg_kw(demo_capacity):
    return dict(num_envs=16, bank_capacity=32, replay_capacity=512,
                warmup_steps=16, total_steps=32, log_every=8, seed=0,
                demo_every=2, demo_rows=64, demo_capacity=demo_capacity)


@pytest.fixture(scope="module")
def prover_batch():
    """One batch of 64 forward candidates with the beam prover's recorded
    solutions (most are proven; the rest have ``n_moves == 0``)."""
    fb = tf.generate_batch_device(64, L, M, 4, 8,
                                  generator=torch.Generator().manual_seed(5),
                                  device="cpu")
    assert fb.winnable.any() and not fb.winnable.all()
    return fb


@pytest.mark.parametrize("demo_capacity", [256, 2048], ids=["strided", "cycled"])
def test_demo_rollout_matches_jax(prover_batch, demo_capacity):
    fb = prover_batch
    jbank = JConfigBank(L, M, capacity=32, seed=0).fill_device(jax.random.PRNGKey(0))
    jtr = jtrain.DQNTrainer(JTrainConfig(env=JEnvConfig(L=L, M=M),
                                         dqn=JDQNConfig(batch_size=32),
                                         **_cfg_kw(demo_capacity)), bank=jbank)
    want = jtr._demo_rollout(
        jnp.asarray(fb.boards.numpy().astype(np.uint32)), jnp.asarray(fb.pieces.numpy()),
        jnp.asarray(fb.rotations.numpy()), jnp.asarray(fb.locations.numpy()),
        jnp.asarray(fb.n_moves.numpy()), jtr._demo)
    bank = ConfigBank(L, M, capacity=32, seed=0, device="cpu").fill_device()
    ttr = DQNTrainer(TrainConfig(env=EnvConfig(L=L, M=M), dqn=DQNConfig(batch_size=32),
                                 **_cfg_kw(demo_capacity)), bank=bank, device="cpu")
    ttr._demo_rollout(fb.boards, fb.pieces, fb.rotations, fb.locations, fb.n_moves)
    d = ttr._demo
    assert (d.pos, d.size) == (int(want.pos), int(want.size)) == (0, demo_capacity)
    for name, buf in d.buf.items():
        w = np.asarray(getattr(want, name))
        if name == "reward":
            np.testing.assert_allclose(buf.numpy(), w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(buf.numpy().astype(np.int64),
                                          w.astype(np.int64), err_msg=name)
    assert d.buf["done"].all()
    # the even stride reaches the winning (terminal-reward) transitions
    assert float(d.buf["reward"].max()) >= ttr.cfg.env.win_reward


def test_demo_rollout_without_proven_rows_keeps_the_buffer(prover_batch):
    fb = prover_batch
    bank = ConfigBank(L, M, capacity=32, seed=0, device="cpu").fill_device()
    ttr = DQNTrainer(TrainConfig(env=EnvConfig(L=L, M=M), dqn=DQNConfig(batch_size=32),
                                 **_cfg_kw(256)), bank=bank, device="cpu")
    ttr._demo_rollout(fb.boards, fb.pieces, fb.rotations, fb.locations, fb.n_moves)
    before = {k: v.clone() for k, v in ttr._demo.buf.items()}
    ttr._demo_rollout(fb.boards, fb.pieces, fb.rotations, fb.locations,
                      torch.zeros_like(fb.n_moves))
    for k, v in ttr._demo.buf.items():
        assert torch.equal(v, before[k]), k


def test_adaptive_controllers_match_jax():
    rates = np.linspace(0.0, 1.0, 11)
    for share in (0.1, 0.25, 0.5, 0.9):
        for wc in rates:
            for wf in rates:
                wc_, wf_ = float(wc), float(wf)
                assert ttrain.adapt_share(share, wc_, wf_) == jtrain.adapt_share(share, wc_, wf_)
                assert (ttrain.adapt_share_v2(share, wc_, wf_)
                        == jtrain.adapt_share_v2(share, wc_, wf_))


def test_host_seed_order_matches_jax():
    """Probes (two ints), then the bank refresh (one), then the demo refresh
    (one), each when its cadence is due, from
    ``np.random.default_rng(seed + 0xBA4E)``."""
    adapt_every, refresh_every, demo_every, n_chunks = 2, 1, 3, 7
    cfg = TrainConfig(env=EnvConfig(L=L, M=M), dqn=DQNConfig(batch_size=32),
                      num_envs=16, bank_capacity=32, replay_capacity=512,
                      total_steps=8 * n_chunks, log_every=8, seed=3,
                      demo_every=demo_every, demo_rows=8, demo_capacity=64)
    bank = ConfigBank(L, M, capacity=32, seed=0, device="cpu").fill_device()
    tr = DQNTrainer(cfg, bank=bank, device="cpu")
    seen = []
    tr.evaluate = lambda n, seed=None, bank=None: seen.append(("probe", seed)) or {
        "win_rate": 0.5}
    tr.bank.refresh_device = lambda seed=None, **kw: seen.append(("refresh", seed))
    tr._refresh_demo = lambda seed, *a: seen.append(("demo", seed))
    z = torch.zeros((), dtype=torch.int64)
    tr.run_chunk = lambda n, rows=None: ChunkMetrics(z, z, z, z.float(), z.float(), 0, z.float())
    tr.train(log_fn=None, device_refresh_every=refresh_every,
             device_forward_fraction=0.25, adaptive_share=True,
             adapt_every=adapt_every, adapt_episodes=8)
    rng = np.random.default_rng(cfg.seed + 0xBA4E)
    want = []
    for i in range(n_chunks):
        if i and i % adapt_every == 0:
            want += [("probe", int(rng.integers(2**31 - 1))) for _ in range(2)]
        if i and i % refresh_every == 0:
            want.append(("refresh", int(rng.integers(2**31 - 1))))
        if i % demo_every == 0:
            want.append(("demo", int(rng.integers(2**31 - 1))))
    assert seen == want
