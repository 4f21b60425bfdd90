"""Port array engine against the JAX engine and the port's bitboard.

Adversarial boards (sparse, deep wells that clear several rows, tall stacks
that top out) and garbage actions (rotations far past 3, locations off both
edges), stepped past the end of the piece sequence: every field of every
state, the lines cleared and the observation are equal exactly. Then the
trainer on ``backend="array"``, which must train exactly as on the bitboard
(same draws, same packed replay rows), the JAX package's refusals, and
``cli train --backend array --refresh-bank`` on the default host bank."""

import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import adversarial_boards, bank_rows

from tetris_piclim_tpu import engine as jengine
from tetris_piclim_tpu_torch import engine
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.carver import CarvingGenerator
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def assert_env_equal(got: engine.EnvState, want, msg=""):
    for f in engine.EnvState._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f"{msg} {f}")


@pytest.mark.parametrize("L,M", [(2, 8), (4, 20)])
def test_array_engine_matches_jax_and_bitboard(L, M):
    """The last third of the envs start on host carves and play their
    recorded solutions (wins, multi-line clears), then garbage."""
    rng = np.random.default_rng(L)
    n, n_carve = 240, 80
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    sol = np.zeros((M + 4, n_carve, 2), np.int32)
    sol[..., 0] = rng.integers(-3, 1000, (M + 4, n_carve))
    sol[..., 1] = rng.integers(-6, 16, (M + 4, n_carve))
    for i in range(n_carve):
        b, p, moves = CarvingGenerator(L, M, rng=random.Random(i),
                                       record_solution=True).generate()
        boards[n - n_carve + i], pieces[n - n_carve + i] = b, p
        sol[:len(moves), i] = moves
    js = jengine.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces), L, M)
    ts = engine.make_state_batch(torch.as_tensor(boards), torch.as_tensor(pieces), L, M)
    bs = tbb.make_state_batch(torch.as_tensor(boards), torch.as_tensor(pieces), L, M)
    step = jax.jit(jengine.step_batch)
    wins = multi = 0
    for k in range(M + 4):  # past the sequence's end: the cursor clamps
        rot = rng.integers(-3, 1000, n).astype(np.int32)
        loc = rng.integers(-6, 16, n).astype(np.int32)
        rot[n - n_carve:], loc[n - n_carve:] = sol[k, :, 0], sol[k, :, 1]
        np.testing.assert_array_equal(engine.observe(ts).numpy(),
                                      np.asarray(jengine.observe_batch(js)))
        np.testing.assert_array_equal(engine.observe(ts).numpy(), tbb.observe(bs).numpy())
        jr = step(js, jnp.asarray(rot), jnp.asarray(loc))
        tr = engine.step(ts, torch.as_tensor(rot), torch.as_tensor(loc))
        br = tbb.step(bs, torch.as_tensor(rot), torch.as_tensor(loc))
        assert_env_equal(tr.state, jr.state, f"step {k}")
        for a, b in ((tr.lines_delta, jr.lines_delta), (tr.done, jr.done), (tr.won, jr.won)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        packed = tbb.from_env_state(tr.state)
        assert all(torch.equal(x, y) for x, y in zip(packed, br.state)), k
        assert torch.equal(tr.lines_delta, br.lines_delta)
        wins += int(tr.won.sum())
        multi += int((tr.lines_delta > 1).sum())
        js, ts, bs = jr.state, tr.state, br.state
    assert wins >= n_carve and multi > 0 and int((ts.status == 2).sum()) > 0


def test_array_autoreset_matches_jax():
    """``step_autoreset_batch`` given the reset rows JAX draws from its key."""
    rng = np.random.default_rng(7)
    n, L, M, B = 96, 2, 8, 16
    bank_b, bank_p = (np.array(a) for a in bank_rows(rng, B, M + 1))
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    js = jengine.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces), L, M)
    ts = engine.make_state_batch(torch.as_tensor(boards), torch.as_tensor(pieces), L, M)
    auto = jax.jit(jengine.step_autoreset_batch)
    resets = 0
    for k in range(12):
        key = jax.random.PRNGKey(k)
        idx = np.array(jax.random.randint(key, (n,), 0, B))
        rot = rng.integers(0, 4, n).astype(np.int32)
        loc = rng.integers(0, 10, n).astype(np.int32)
        js, jr = auto(js, jnp.asarray(rot), jnp.asarray(loc), jnp.asarray(bank_b),
                      jnp.asarray(bank_p), key)
        ts, tr = engine.step_autoreset_batch(
            ts, torch.as_tensor(rot), torch.as_tensor(loc), torch.as_tensor(bank_b),
            torch.as_tensor(bank_p), torch.as_tensor(idx))
        assert_env_equal(ts, js, f"step {k}")
        resets += int(tr.done.sum())
    assert resets > n // 4


def test_make_state_copies_and_single_env():
    board = np.zeros((20, 10), bool)
    pieces = np.zeros(9, np.int8)
    s = engine.make_state(board, pieces, 1, 8)
    board[:] = True
    pieces[:] = 6
    assert not s.board.any() and not s.pieces.any()
    assert s.board.shape == (1, 20, 10) and s.lines_goal.tolist() == [1]
    bank = engine.reset_from_bank(torch.ones((3, 20, 10), dtype=torch.bool),
                                  torch.full((3, 9), 2), torch.tensor([2, 0]), 2, 8)
    assert bank.board.shape == (2, 20, 10) and bank.move_limit.tolist() == [8, 8]


def _cfg(**kw) -> TrainConfig:
    return TrainConfig(env=EnvConfig(L=1, M=6), dqn=DQNConfig(batch_size=32),
                       num_envs=16, bank_capacity=16, replay_capacity=512,
                       warmup_steps=4, total_steps=16, log_every=8, seed=0, **kw)


def test_trainer_array_backend_trains_as_bitboard():
    """The array backend draws, steps and writes the replay exactly as the
    bitboard backend, so the two trainers end identical."""
    out = {}
    for backend in ("bitboard", "array"):
        bank = ConfigBank(1, 6, capacity=16, seed=0, device="cpu").fill_device()
        tr = DQNTrainer(_cfg(), bank=bank, device="cpu", backend=backend)
        hist = tr.train(log_fn=None)["history"]
        ev = tr.evaluate(n_episodes=32)
        out[backend] = (tr, hist, ev)
    (a, ha, ea), (b, hb, eb) = out["bitboard"], out["array"]
    assert isinstance(b.state.env, engine.EnvState)
    keys = ("episodes", "win_rate", "lines", "reward", "loss", "q_mean", "updates")
    assert [[r[k] for k in keys] for r in ha] == [[r[k] for k in keys] for r in hb]
    assert ea == eb and eb["unfinished"] == 0.0
    assert all(torch.equal(x, y) for x, y in zip(a.state.net.parameters(),
                                                  b.state.net.parameters()))
    assert all(torch.equal(x, y) for x, y in zip(
        a.state.env, tbb.from_env_state(b.state.env)))
    for k, v in a.state.replay.buf.items():
        assert torch.equal(v, b.state.replay.buf[k]), k


def test_array_backend_refusals():
    bank = ConfigBank(1, 6, capacity=16, seed=0, device="cpu").fill_device()
    with pytest.raises(ValueError, match="bitboard backend"):
        DQNTrainer(_cfg(actor_fusion=4), bank=bank, device="cpu", backend="array")
    with pytest.raises(ValueError, match="bitboard backend"):
        DQNTrainer(_cfg(demo_every=2), bank=bank, device="cpu", backend="array")
    with pytest.raises(ValueError, match="backend"):
        DQNTrainer(_cfg(), bank=bank, device="cpu", backend="grid")


_CLI_REFRESH = ["-m", "tetris_piclim_tpu_torch", "train", "--device", "cpu", "-L", "1",
                "-M", "8", "--num-envs", "64", "--bank", "64", "--replay", "8192",
                "--warmup", "256", "--steps", "400", "--log-every", "100",
                "--eval-episodes", "64", "--refresh-bank", "--backend", "array"]


def test_cli_train_refresh_bank_and_array_backend():
    """``train --refresh-bank --backend array`` on the default (host) bank:
    the producers write rows while training. In a subprocess with one
    intra-op thread (torch's spinning worker threads and the consumer
    thread would otherwise fight for the cores and the GIL)."""
    out = subprocess.run([sys.executable, *_CLI_REFRESH], capture_output=True,
                         text=True, timeout=150, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [ln for ln in out.stderr.splitlines() if "bank_writes=" in ln]
    assert len(rows) == 4, out.stderr[-2000:]
    assert "'forward': 16" in rows[0]  # the default bank: 25% of 64 rows
    writes = int(rows[-1].split("bank_writes=")[1].split()[0])
    assert writes > 0, rows
    assert '"train_bank"' in out.stdout
