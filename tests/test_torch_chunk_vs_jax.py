"""The port's per-step training chunk against the JAX package's, whole, at
full width: ``DQNTrainer._chunk_plain`` and JAX's ``_chunk_impl`` from the
same state, on the same bank rows, with JAX's own draws (explore, random
actions, reset rows, replay samples) fed to the port in the order it draws
them. 40 steps of 4096 envs fill the 131072-row ring and wrap it.

Tolerances: env states, the replay ring, the chunk's counts and reward
equal word for word; the weights within 1e-5 absolute after the chunk's
updates (an AMSGrad update moves a weight by up to lr = 1e-4; float32 sum
order moved none by more than 1.01e-6 over the chunk); the loss sum within
1e-5 relative. ``fresh``
starts from JAX's initial weights, ``tpu`` from the TPU-trained weights of
``results/tpu_L2M20_v2_params.npz`` (trained Q magnitudes), ``trained``
from JAX's whole train state after 2000 steps (weights, optimizer moments
at count 2000, a full ring half way round, envs mid-episode), for 5 steps:
further on, float32 sum order flips a near-tie now and then and the two
runs part, as two runs of one package on two machines would."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.dqn.train import DQNTrainer as JTrainer
from tetris_piclim_tpu.gen.bank import ConfigBank as JBank
from tetris_piclim_tpu.utils.config import EnvConfig as JEnv, TrainConfig as JConfig
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.models.qnet import params_from_flax
from tetris_piclim_tpu_torch.utils.checkpoint import read_flax_npz
from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

from torch_port_helpers import assert_states_equal, port_state_from_jax

PARAMS = Path(__file__).resolve().parents[1] / "results" / "tpu_L2M20_v2_params.npz"
BANK = 4096
BATCH = 128
PRETRAIN = 2000


def jax_draws(key, n_envs: int, capacity: int, warmup: int, steps: int, size: int):
    """JAX's per-step draws in the port's order: explore uniforms, random
    rotations, random columns, reset rows, then the learner's offsets
    (``size``: the ring's size before the first step)."""
    out = []
    for _ in range(steps):
        key, k_act, k_step, k_sample = jax.random.split(key, 4)
        k_expl, k_rot, k_col = jax.random.split(k_act, 3)
        out.append((None, np.asarray(jax.random.uniform(k_expl, (n_envs,)))))
        out.append((4, np.asarray(jax.random.randint(k_rot, (n_envs,), 0, 4))))
        out.append((10, np.asarray(jax.random.randint(k_col, (n_envs,), 0, 10))))
        out.append((BANK, np.asarray(jax.random.randint(k_step, (n_envs,), 0, BANK))))
        size = min(size + n_envs, capacity)
        if size >= max(warmup, BATCH):
            k_i = jax.random.fold_in(k_sample, 0)
            out.append((size, np.asarray(jax.random.randint(k_i, (BATCH,), 0, size))))
    return out


@pytest.mark.parametrize("n_envs,capacity,start,steps", [
    (256, 8192, "fresh", 40), (4096, 131072, "fresh", 40),
    (4096, 131072, "tpu", 40), (4096, 131072, "trained", 5)])
def test_per_step_chunk_matches_jax(monkeypatch, n_envs, capacity, start, steps):
    jcfg = JConfig(env=JEnv(L=2, M=20), num_envs=n_envs, bank_capacity=BANK,
                   replay_capacity=capacity, seed=0)
    jbank = JBank(2, 20, capacity=BANK, seed=0).fill_device()
    jt = JTrainer(jcfg, bank=jbank)
    ts0 = jt.state
    if start == "tpu":
        tree = jax.tree.map(jnp.asarray, read_flax_npz(str(PARAMS)))
        ts0 = ts0._replace(params=tree["params"], target_params=tree["target_params"])
    if start == "trained":
        ts0, _ = jt._chunk(ts0, jt._bank_boards(), jbank.pieces, n_steps=PRETRAIN)
    ts1, jm = jt._chunk(ts0, jt._bank_boards(), jbank.pieces, n_steps=steps)
    draws = jax_draws(ts0.key, n_envs, capacity, jcfg.warmup_steps, steps,
                      int(ts0.replay.size))

    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=n_envs, bank_capacity=BANK,
                      replay_capacity=capacity, seed=0)
    cols = torch.from_numpy(np.array(jt._bank_boards()).astype(np.int32))
    bank = ConfigBank.from_rows(2, 20, cols, torch.from_numpy(np.array(jbank.pieces)))
    tr = DQNTrainer(cfg, bank=bank, device="cpu")
    st = tr.state
    port_state_from_jax(st, ts0)

    rand, randint = torch.rand, torch.randint
    queue = list(draws)

    def fed_rand(*size, generator=None, **kw):
        if generator is not st.gen:
            return rand(*size, generator=generator, **kw)
        high, v = queue.pop(0)
        assert high is None and tuple(size[0]) == v.shape
        return torch.from_numpy(v)

    def fed_randint(low, high, size, generator=None, **kw):
        if generator is not st.gen:
            return randint(low, high, size, generator=generator, **kw)
        want, v = queue.pop(0)
        assert (low, high, tuple(size)) == (0, want, v.shape)
        return torch.from_numpy(v.astype(np.int64))

    monkeypatch.setattr(torch, "rand", fed_rand)
    monkeypatch.setattr(torch, "randint", fed_randint)
    tm = tr.run_chunk(steps)
    monkeypatch.undo()
    assert queue == []

    assert_states_equal(st.env, ts1.env, "env after the chunk")
    jr = ts1.replay
    assert (st.replay.pos, st.replay.size) == (int(jr.pos), int(jr.size))
    assert st.replay.size == min(int(ts0.replay.size) + steps * n_envs, capacity)
    for name in ("cols", "rot", "col", "reward", "done", "n_cols", "n_status"):
        np.testing.assert_array_equal(
            st.replay.buf[name].numpy().astype(np.float64),
            np.asarray(getattr(jr, name)).astype(np.float64), err_msg=name)
    assert (int(tm.episodes), int(tm.wins), int(tm.lines)) == (
        int(jm.episodes), int(jm.wins), int(jm.lines))
    assert float(tm.reward) == float(jm.reward)
    assert tm.loss_count == int(jm.loss_count) > 0
    np.testing.assert_allclose(float(tm.loss_sum), float(jm.loss_sum), rtol=1e-5)
    for got, want in ((st.net, ts1.params), (st.target_net, ts1.target_params)):
        want = params_from_flax(jax.device_get(want))
        for k, v in got.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
    if start == "trained":
        assert st.opt.count == int(ts1.opt_state[0].count) == PRETRAIN + steps
        want = params_from_flax(jax.device_get(ts1.opt_state[0].nu_max))
        names = [k for k, _ in st.net.named_parameters()]
        for k, v in zip(names, st.opt.nu_max):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-12,
                                       err_msg=k)
    moved = params_from_flax(jax.device_get(ts0.params))["dense.0.weight"]
    assert not torch.equal(st.net.state_dict()["dense.0.weight"], moved)
