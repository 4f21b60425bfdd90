"""The port's curriculum chunk against the JAX package's, whole:
``CurriculumTrainer.run_chunk`` and JAX's ``_chunk_impl`` from the same
state, on the same level banks (JAX's rows) and level array, with JAX's own
draws (explore uniforms, random rotations and columns, reset rows, then each
update's replay sample) fed to the port in the order it draws them.

Cases, all on the recorded recipe's four levels (1:10, 2:15, 3:20, 5:25):
``fresh`` starts from JAX's initial state at 256 envs; ``full`` at the
recipe's width (4096 envs, 1024 bank rows per level, a 131072-row ring,
batch 128) with a third of the envs promoted to level 1 and 64 to level 2
mid-episode, for 30 steps (32 fill the ring); ``trained`` from JAX's whole
state after 2000 steps at 256 envs (weights moved, AMSGrad moments at
count 4000, a 524288-row ring part full, envs mid-episode) for 5 steps, two updates a step;
``per`` with 3-step returns and prioritized replay over a 40-step chunk that
wraps the ring, PER's beta annealed over 200 steps (the sample's slots are
JAX's categorical draws, read back from its chunk).

Tolerances: env states, the replay ring (but its priorities), ``pos`` and
``size``, and the per-level episode and win tallies equal word for word;
the weights and the target within 1e-5 absolute (an AMSGrad step moves a
weight by up to lr = 1e-4; float32 sum order moves it by about 1e-6); the
chunk's loss within 1e-5 relative; the ring's priorities (``|td| + eps``,
from those weights) within 1e-4 relative."""

import jax
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.dqn.curriculum_train import CurriculumTrainer as JTrainer
from tetris_piclim_tpu.utils.config import DQNConfig as JDQN
from tetris_piclim_tpu.utils.config import EnvConfig as JEnv
from tetris_piclim_tpu.utils.config import TrainConfig as JConfig
from tetris_piclim_tpu_torch.dqn import curriculum_train
from tetris_piclim_tpu_torch.dqn.curriculum_train import CurriculumTrainer
from tetris_piclim_tpu_torch.gen import curriculum as cur
from tetris_piclim_tpu_torch.models.qnet import params_from_flax
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

from torch_port_helpers import assert_states_equal, port_state_from_jax

torch.set_num_threads(1)
LEVELS = [(1, 10), (2, 15), (3, 20), (5, 25)]
BANK, BATCH, PRETRAIN = 1024, 128, 2000
FIELDS = ("cols", "cur", "nxt", "lines_left", "moves_left", "rot", "col", "reward",
          "done", "n_cols", "n_cur", "n_nxt", "n_lines_left", "n_moves_left", "n_status")


def jax_draws(key, n_envs: int, steps: int, size: int, *, capacity: int,
              min_size: int, chain: int, updates: int, slots: list):
    """JAX's per-step draws in the port's order: explore uniforms, random
    rotations, random columns, reset rows, then each update's sample
    offsets (``size``: the ring's size before the first step; ``chain``:
    the newest transitions without a whole n-step chain). Under PER each
    update takes the next of ``slots``, JAX's categorical draws."""
    out = []
    for _ in range(steps):
        key, k_act, k_step, k_sample = jax.random.split(key, 4)
        k_expl, k_rot, k_col = jax.random.split(k_act, 3)
        out.append((None, np.asarray(jax.random.uniform(k_expl, (n_envs,)))))
        out.append((4, np.asarray(jax.random.randint(k_rot, (n_envs,), 0, 4))))
        out.append((10, np.asarray(jax.random.randint(k_col, (n_envs,), 0, 10))))
        out.append((BANK, np.asarray(jax.random.randint(k_step, (n_envs,), 0, BANK))))
        size = min(size + n_envs, capacity)
        if size < min_size:
            continue
        for kk in jax.random.split(k_sample, updates):
            if slots:
                out.append(("slots", slots.pop(0)))
                continue
            valid = max(size - chain, 1)
            out.append((valid, np.asarray(jax.random.randint(kk, (BATCH,), 0, valid))))
    return out


def recorded_categorical(monkeypatch) -> list:
    """JAX's categorical draws (the PER sample's slots), appended in order
    as its chunk runs them."""
    seen, categorical = [], jax.random.categorical

    def rec(key, logits, axis=-1, shape=None, **kw):
        out = categorical(key, logits, axis=axis, shape=shape, **kw)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), out, ordered=True)
        return out

    monkeypatch.setattr(jax.random, "categorical", rec)
    return seen


def mixed_levels(n: int) -> np.ndarray:
    """A third of the envs at level 1 and 64 at level 2, the rest at 0."""
    level = np.zeros(n, np.int64)
    level[np.random.default_rng(5).permutation(n)[:n // 3]] = 1
    level[np.arange(0, n, max(1, n // 64))[:64]] = 2
    return level


CASES = {  # n_envs, capacity, steps, updates, n_step, PER, mixed levels
    "fresh": (256, 8192, 40, 1, 1, False, False),
    "full": (4096, 131072, 30, 1, 1, False, True),
    "trained": (256, 524288, 5, 2, 1, False, True),
    "per": (256, 8192, 40, 1, 3, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_curriculum_chunk_matches_jax(monkeypatch, case):
    n_envs, capacity, steps, updates, n_step, per, mixed = CASES[case]
    total = 200 if per else 100_000
    jcfg = JConfig(env=JEnv(L=1, M=10), dqn=JDQN(n_step=n_step, prioritized=per),
                   num_envs=n_envs, bank_capacity=BANK, replay_capacity=capacity,
                   updates_per_step=updates, total_steps=total, seed=0)
    jt = JTrainer(LEVELS, cfg=jcfg, seed=0)
    level = mixed_levels(n_envs) if mixed else np.zeros(n_envs, np.int64)
    jlevel = jax.numpy.asarray(level, jax.numpy.int32)
    ts0 = jt.state
    if case == "trained":
        ts0, *_ = jt._chunk(ts0, jt.bank, jlevel, n_steps=PRETRAIN)
    slots = recorded_categorical(monkeypatch) if per else []
    ts1, j_eps, j_wins, j_loss = jt._chunk(ts0, jt.bank, jlevel, n_steps=steps)
    jax.block_until_ready(ts1)
    monkeypatch.undo()
    min_size = max(jcfg.warmup_steps, BATCH) + (n_step - 1) * n_envs
    draws = jax_draws(ts0.key, n_envs, steps, int(ts0.replay.size), capacity=capacity,
                      min_size=min_size, chain=(n_step - 1) * n_envs,
                      updates=updates, slots=list(slots))

    bank = cur.CurriculumBank(*(torch.from_numpy(np.array(x).astype(d)) for x, d in zip(
        jt.bank, (np.int32, np.int8, np.int32, np.int32))))
    monkeypatch.setattr(curriculum_train.cur_lib, "build_curriculum_bank",
                        lambda *a, **k: bank)
    cfg = TrainConfig(env=EnvConfig(L=1, M=10),
                      dqn=DQNConfig(n_step=n_step, prioritized=per),
                      num_envs=n_envs, bank_capacity=BANK, replay_capacity=capacity,
                      updates_per_step=updates, total_steps=total, seed=0)
    tr = CurriculumTrainer(LEVELS, cfg=cfg, seed=0, device="cpu")
    tr.level = level
    st = tr.state
    port_state_from_jax(st, ts0)

    rand, randint, multinomial = torch.rand, torch.randint, torch.multinomial
    queue = list(draws)

    def fed_rand(*size, generator=None, **kw):
        if generator is not st.gen:
            return rand(*size, generator=generator, **kw)
        high, v = queue.pop(0)
        assert high is None and tuple(size[0]) == v.shape
        return torch.from_numpy(v.copy())

    def fed_randint(low, high, size, generator=None, **kw):
        if generator is not st.gen:
            return randint(low, high, size, generator=generator, **kw)
        want, v = queue.pop(0)
        assert (low, high, tuple(size)) == (0, want, v.shape)
        return torch.from_numpy(v.astype(np.int64))

    def fed_multinomial(probs, n, replacement=False, generator=None):
        if generator is not st.gen:
            return multinomial(probs, n, replacement, generator=generator)
        want, v = queue.pop(0)
        assert want == "slots" and replacement and v.shape == (n,)
        assert bool((probs[torch.from_numpy(v.astype(np.int64))] > 0).all())
        return torch.from_numpy(v.astype(np.int64))

    monkeypatch.setattr(torch, "rand", fed_rand)
    monkeypatch.setattr(torch, "randint", fed_randint)
    monkeypatch.setattr(torch, "multinomial", fed_multinomial)
    t_eps, t_wins, t_loss = tr.run_chunk(steps)
    monkeypatch.undo()
    assert queue == []

    assert_states_equal(st.env, ts1.env, "env after the chunk")
    jr = ts1.replay
    assert (st.replay.pos, st.replay.size) == (int(jr.pos), int(jr.size))
    assert st.replay.size == min(int(ts0.replay.size) + steps * n_envs, capacity)
    for name in FIELDS:
        np.testing.assert_array_equal(
            st.replay.buf[name].numpy().astype(np.float64),
            np.asarray(getattr(jr, name)).astype(np.float64), err_msg=name)
    np.testing.assert_allclose(st.replay.priority.numpy(), np.asarray(jr.priority),
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(float(st.replay.max_prio), float(jr.max_prio), rtol=1e-4)
    np.testing.assert_array_equal(t_eps.numpy(), np.asarray(j_eps))
    np.testing.assert_array_equal(t_wins.numpy(), np.asarray(j_wins))
    # every level present ended episodes (the 5-step chunk: some level did)
    assert (t_eps[np.unique(level)] > 0).all() if steps >= 30 else t_eps.sum() > 0
    assert float(j_loss) > 0
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert st.global_step == int(ts1.global_step)
    for got, want in ((st.net, ts1.params), (st.target_net, ts1.target_params)):
        want = params_from_flax(jax.device_get(want))
        for k, v in got.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
    assert st.opt.count == int(ts1.opt_state[0].count)
    moved = params_from_flax(jax.device_get(ts0.params))["dense.0.weight"]
    assert not torch.equal(st.net.state_dict()["dense.0.weight"], moved)
