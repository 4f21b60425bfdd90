"""Port curriculum against the JAX package.

A curriculum bank built by JAX is carried across as numpy; ``make_states``
and ``step_autoreset_curriculum`` are given the rows JAX draws from its
keys and must give JAX's states exactly. ``promote_levels`` is the same
numpy ``Generator`` code (exact). The port's own bank is held by invariant
(every row's recorded solution replays to WIN at its level's (L, M)), the
trainer's per-level tallies and chunk loss against a recount of what the
chunk did, ``evaluate_levels`` against JAX on the same parameters, bank and
start rows, promotion at threshold 0, and ``cli curriculum``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.dqn.curriculum_train import CurriculumTrainer as JTrainer
from tetris_piclim_tpu.gen import curriculum as jcur
from tetris_piclim_tpu.utils.config import DQNConfig as JDQNConfig
from tetris_piclim_tpu.utils.config import EnvConfig as JEnvConfig
from tetris_piclim_tpu.utils.config import TrainConfig as JTrainConfig
from tetris_piclim_tpu_torch import cli
from tetris_piclim_tpu_torch.dqn import curriculum_train
from tetris_piclim_tpu_torch.dqn.curriculum_train import CurriculumTrainer
from tetris_piclim_tpu_torch.gen import curriculum as cur
from tetris_piclim_tpu_torch.gen.device_carver import generate_batch_device
from tetris_piclim_tpu_torch.models.qnet import params_from_flax
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

torch.set_num_threads(1)
LEVELS = [(1, 8), (2, 12), (3, 15)]


def port_bank(jb) -> cur.CurriculumBank:
    """A JAX CurriculumBank as the port's (numpy in between)."""
    return cur.CurriculumBank(*(torch.as_tensor(np.array(x).astype(d)) for x, d in zip(
        jb, (np.int32, np.int8, np.int32, np.int32))))


@pytest.fixture(scope="module")
def jax_bank():
    return jcur.build_curriculum_bank(jax.random.PRNGKey(0), LEVELS, capacity=16)


def assert_packed_equal(got, want, msg=""):
    for f in tbb.PackedState._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f"{msg} {f}")


def test_make_states_and_step_match_jax(jax_bank):
    bank = port_bank(jax_bank)
    n, B = 96, 16
    level_np = (np.arange(n) % 3).astype(np.int32)
    level = torch.as_tensor(level_np)
    key = jax.random.PRNGKey(1)
    js = jcur.make_states(jax_bank, jnp.asarray(level_np), key)
    ts = cur.make_states(bank, level, torch.as_tensor(np.array(
        jax.random.randint(key, (n,), 0, B))))
    assert_packed_equal(ts, js, "make_states")
    np.testing.assert_array_equal(ts.lines_goal.numpy(), [1, 2, 3] * 32)
    step = jax.jit(jcur.step_autoreset_curriculum)
    rng = np.random.default_rng(0)
    dones = 0
    for k in range(24):
        rot = rng.integers(0, 4, n).astype(np.int32)
        loc = rng.integers(0, 10, n).astype(np.int32)
        kk = jax.random.PRNGKey(100 + k)
        if k == 12:  # promote some envs between steps: resets pick it up
            level_np = np.minimum(level_np + (np.arange(n) % 2), 2).astype(np.int32)
            level = torch.as_tensor(level_np)
        js, jr = step(js, jnp.asarray(rot), jnp.asarray(loc), jax_bank,
                      jnp.asarray(level_np), kk)
        idx = torch.as_tensor(np.array(jax.random.randint(kk, (n,), 0, B)))
        ts, tr = cur.step_autoreset_curriculum(ts, torch.as_tensor(rot),
                                               torch.as_tensor(loc), bank, level, idx)
        assert_packed_equal(ts, js, f"step {k}")
        dones += int(tr.done.sum())
    assert dones > n


def test_promote_levels_word_for_word():
    rng = np.random.default_rng(3)
    for trial in range(20):
        n_levels = int(rng.integers(2, 5))
        level = rng.integers(0, n_levels, 200)
        win = rng.random(n_levels)
        for thr, frac in ((0.5, 0.5), (0.0, 0.3), (0.9, 1.0)):
            got = cur.promote_levels(level, win, n_levels, threshold=thr, fraction=frac,
                                     rng=np.random.default_rng(trial))
            want = jcur.promote_levels(level, win, n_levels, threshold=thr,
                                       fraction=frac, rng=np.random.default_rng(trial))
            np.testing.assert_array_equal(got, want)
    # the default generator, and no promotion below the threshold
    level = np.zeros(100, np.int64)
    np.testing.assert_array_equal(
        cur.promote_levels(level, np.array([0.9, 0.0]), 2),
        jcur.promote_levels(level, np.array([0.9, 0.0]), 2))
    assert (cur.promote_levels(level, np.array([0.1, 0.0]), 2) == 0).all()


def test_port_bank_rows_replay_to_win_at_their_level():
    bank = cur.build_curriculum_bank(LEVELS, 32, seed=4, device="cpu")
    assert bank.boards.shape == (3, 32, 10) and bank.pieces.shape == (3, 32, 16)
    for k, ((L, M), level_seed) in enumerate(zip(LEVELS, cur.level_seeds(4, 3))):
        # the carve the bank made, with its recorded solution
        batch = generate_batch_device(
            32, L, M, generator=torch.Generator().manual_seed(level_seed), device="cpu")
        assert torch.equal(bank.boards[k], batch.boards)
        assert torch.equal(bank.pieces[k, :, :M + 1], batch.pieces)
        assert int(bank.pieces[k].min()) >= 0 and int(bank.pieces[k].max()) <= 6
        st = cur.make_states(bank, torch.full((32,), k), torch.arange(32))
        for t in range(M):
            res = tbb.step(st, batch.rotations[:, t].long(), batch.locations[:, t].long())
            st = tbb.state_where(st.status != 0, st, res.state)
        assert bool((st.status == 1).all()), (L, M)
        assert torch.equal(st.moves_used, batch.n_moves)
    assert bank.lines.tolist() == [1, 2, 3] and bank.moves.tolist() == [8, 12, 15]


def _cfg(**kw) -> TrainConfig:
    return TrainConfig(env=EnvConfig(L=1, M=8), dqn=DQNConfig(batch_size=32),
                       num_envs=48, bank_capacity=16, replay_capacity=1536,
                       warmup_steps=96, seed=0, **kw)


def test_chunk_tallies_and_loss(monkeypatch):
    """Per-level episodes and wins are the bincounts of what each step
    ended; the chunk loss is the mean over steps of each step's mean update
    loss, steps before learning counting 0."""
    tr = CurriculumTrainer(LEVELS, cfg=_cfg(updates_per_step=2), device="cpu")
    tr.level = np.arange(48) % 3
    ends, losses = [], []
    step, update = cur.step_autoreset_curriculum, curriculum_train.agent_lib.learner_update

    def rec_step(*a):
        nxt, res = step(*a)
        ends.append((res.done.clone(), res.won.clone()))
        return nxt, res

    def rec_update(*a, **k):
        aux = update(*a, **k)
        losses.append((len(ends), float(aux["loss"])))
        return aux

    monkeypatch.setattr(curriculum_train.cur_lib, "step_autoreset_curriculum", rec_step)
    monkeypatch.setattr(curriculum_train.agent_lib, "learner_update", rec_update)
    episodes, wins, loss = tr.run_chunk(6)
    lvl = np.arange(48) % 3
    want_e = sum(np.bincount(lvl, weights=d.numpy(), minlength=3) for d, _ in ends)
    want_w = sum(np.bincount(lvl, weights=w.numpy(), minlength=3) for _, w in ends)
    np.testing.assert_array_equal(episodes.numpy(), want_e)
    np.testing.assert_array_equal(wins.numpy(), want_w)
    assert want_e.sum() > 0
    # learning starts at the replay's 96th transition: the 2nd step of 48 envs
    assert [s for s, _ in losses] == [2, 2, 3, 3, 4, 4, 5, 5, 6, 6]
    per_step = [np.mean([v for s, v in losses if s == i]) for i in range(2, 7)]
    assert float(loss) == pytest.approx(sum(per_step) / 6, rel=1e-6)


def test_evaluate_levels_matches_jax(jax_bank):
    jcfg = JTrainConfig(env=JEnvConfig(L=1, M=8), dqn=JDQNConfig(batch_size=32),
                        num_envs=16, bank_capacity=16, replay_capacity=256, seed=0)
    jtr = JTrainer(LEVELS, cfg=jcfg)
    jtr.bank = jax_bank
    key = jax.random.PRNGKey(9)
    want = jtr.evaluate_levels(episodes_per_level=64, key=key)
    rows = []
    for _ in LEVELS:  # the rows JAX's evaluate_levels draws, level by level
        key, k_env = jax.random.split(key)
        rows.append(np.array(jax.random.randint(k_env, (64,), 0, 16)))
    tr = CurriculumTrainer(LEVELS, cfg=_cfg(), device="cpu")
    tr.bank = port_bank(jax_bank)
    tr.state.net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.state.params)))
    got = tr.evaluate_levels(episodes_per_level=64, rows=torch.as_tensor(np.stack(rows)))
    assert got == want
    assert any(r["win_rate"] > 0 for r in got) or any(r["loss_rate"] > 0 for r in got)


def test_promotion_at_threshold_zero():
    tr = CurriculumTrainer([(1, 8), (2, 12)], cfg=_cfg(), device="cpu")
    hist = tr.train(total_steps=40, chunk=20, threshold=0.0, fraction=0.5, log_fn=None)
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)
    # the host promotion is promote_levels under np.random.default_rng(seed)
    rng, level = np.random.default_rng(0), np.zeros(48, np.int64)
    for r in hist:
        level = jcur.promote_levels(level, np.array(r["win_rate_per_level"]), 2,
                                    threshold=0.0, fraction=0.5, rng=rng)
        assert r["level_distribution"] == np.bincount(level, minlength=2).tolist()
    np.testing.assert_array_equal(tr.level, level)
    assert hist[-1]["level_distribution"] == [12, 36]


def test_cli_curriculum(capsys):
    import json

    assert cli.main(["curriculum", "--device", "cpu", "--levels", "1:8,2:12",
                     "--num-envs", "32", "--bank", "16", "--replay", "2048",
                     "--warmup", "64", "--steps", "20", "--chunk", "10",
                     "--threshold", "0", "--eval-episodes", "16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["train"]["step"] == 20 and len(out["eval_per_level"]) == 2
    assert out["train"]["level_distribution"] == [8, 24]
