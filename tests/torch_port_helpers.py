"""Shared inputs for the torch-port tests: numpy-made boards, banks and
streams that go through both the JAX package and its PyTorch port."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def adversarial_boards(rng: np.random.Generator, n: int) -> np.ndarray:
    """bool[n, 20, 10]: 1/3 sparse random, 1/3 deep wells (bottom rows full
    but one column, clearing 2-4 lines at once), 1/3 tall stacks that top
    out. No initial full rows."""
    boards = np.zeros((n, 20, 10), bool)
    third = n // 3
    rnd = rng.random((third, 20, 10)) < 0.25
    rnd[:, :6] = False
    boards[:third] = rnd
    depth = rng.integers(1, 4, third)
    well = rng.integers(0, 10, third)
    for i in range(third):
        boards[third + i, 20 - depth[i]:, :] = True
        boards[third + i, 20 - depth[i]:, well[i]] = False
    tall = rng.random((n - 2 * third, 20, 10)) < 0.55
    tall[:, :2] = False
    boards[2 * third:] = tall
    boards[boards.all(axis=2)] = False
    return boards


def bank_rows(rng: np.random.Generator, bank: int, pieces_len: int):
    """(bool[bank, 20, 10] boards with sparse bottom rows, int8 pieces)."""
    boards = np.zeros((bank, 20, 10), bool)
    boards[:, 14:] = rng.random((bank, 6, 10)) < 0.2
    boards[boards.all(axis=2)] = False
    pieces = rng.integers(0, 7, (bank, pieces_len)).astype(np.int8)
    return boards, pieces


def pack_np(boards: np.ndarray) -> np.ndarray:
    """bool[..., 20, 10] -> int32[..., 10] column bitmasks."""
    w = (1 << np.arange(20, dtype=np.int64))[:, None]
    return (boards.astype(np.int64) * w).sum(axis=-2).astype(np.int32)


def jax_state_np(state) -> dict:
    """A JAX PackedState as int numpy arrays keyed by field."""
    return {k: np.asarray(v).astype(np.int64) for k, v in state._asdict().items()}


def torch_state_np(state) -> dict:
    return {k: v.cpu().numpy().astype(np.int64) for k, v in state._asdict().items()}


def assert_states_equal(got, want, msg=""):
    got, want = torch_state_np(got), jax_state_np(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")


def t(x, dtype=None):
    """numpy -> CPU tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def transitions(rng: np.random.Generator, n: int) -> dict:
    """One step's worth of packed transition fields (numpy), in the order
    of ``replay_add_fields``; about one in five is terminal."""
    return dict(
        cols=pack_np(adversarial_boards(rng, n)),
        cur=rng.integers(0, 7, n).astype(np.int8),
        nxt=rng.integers(0, 7, n).astype(np.int8),
        ll=rng.integers(0, 4, n).astype(np.int32),
        ml=rng.integers(0, 21, n).astype(np.int32),
        rot=rng.integers(0, 4, n).astype(np.int32),
        col=rng.integers(0, 10, n).astype(np.int32),
        reward=rng.choice([-10.0, 0.0, 1.0, 10.0], n).astype(np.float32),
        done=rng.random(n) < 0.2,
        n_cols=pack_np(adversarial_boards(rng, n)),
        n_cur=rng.integers(0, 7, n).astype(np.int8),
        n_nxt=rng.integers(0, 7, n).astype(np.int8),
        n_ll=rng.integers(0, 4, n).astype(np.int32),
        n_ml=rng.integers(0, 21, n).astype(np.int32),
        n_st=rng.integers(0, 3, n).astype(np.int8),
    )


def filled_replays(cap: int, n: int, writes: int, seed: int = 0):
    """A JAX replay state and a port ``ReplayBuffer`` of capacity ``cap``
    after the same ``writes`` blocks of ``n`` transitions."""
    import jax
    import jax.numpy as jnp

    from tetris_piclim_tpu.dqn import replay as jreplay
    from tetris_piclim_tpu_torch.dqn.replay import ReplayBuffer

    add = jax.jit(jreplay.replay_add_fields)
    rng = np.random.default_rng(seed)
    jr = jreplay.replay_init(cap)
    tr = ReplayBuffer(cap, "cpu")
    for _ in range(writes):
        f = transitions(rng, n)
        jr = add(jr, *[jnp.asarray(v) for v in f.values()])
        tr.add_fields(*[t(v) for v in f.values()])
    return jr, tr


def port_state_from_jax(st, ts) -> None:
    """Load a JAX trainer's whole state ``ts`` into the port's ``st``
    (a ``DQNTrainer`` or ``CurriculumTrainer`` state): weights, target,
    AMSGrad moments, the replay ring with its priorities, the envs, the
    step and, where the state keeps it, the update count."""
    import jax

    from tetris_piclim_tpu_torch.models.qnet import params_from_flax
    from tetris_piclim_tpu_torch.ops import bitboard as tbb

    flax = lambda tree: params_from_flax(jax.device_get(tree))  # noqa: E731
    st.net.load_state_dict(flax(ts.params))
    st.target_net.load_state_dict(flax(ts.target_params))
    ams, names = ts.opt_state[0], [k for k, _ in st.net.named_parameters()]
    st.opt.load_state_dict({"count": int(ams.count),
                            **{m: [flax(getattr(ams, m))[k] for k in names]
                               for m in ("mu", "nu", "nu_max")}})
    r = ts.replay
    st.replay.load_state_dict({
        "buf": {k: torch.from_numpy(np.array(getattr(r, k))).to(v.dtype)
                for k, v in st.replay.buf.items()},
        "pos": int(r.pos), "size": int(r.size),
        "priority": torch.from_numpy(np.array(r.priority)),
        "max_prio": torch.tensor(float(r.max_prio))})
    st.env = tbb.PackedState(*[
        torch.from_numpy(np.array(f).astype(np.int8 if name in ("pieces", "status")
                                            else np.int32))
        for name, f in zip(tbb.PackedState._fields, ts.env)])
    st.global_step = int(ts.global_step)
    if hasattr(ts, "updates_done"):
        st.updates_done = int(ts.updates_done)


# -- the tools' tests (tests/test_torch_tools_*.py) ---------------------------


def run_tool(args: list, timeout: int) -> subprocess.CompletedProcess:
    # one thread, as in this process: on a busy machine torch's default of
    # one thread per core makes a tiny run wait on the others for minutes
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def tiny_run(tmp_path, forward_fraction: float = 0.5):
    """A checkpoint of the toy conv learner with its 16-row training bank,
    and a 16-row held-out bank of forward rows over carves (saved as
    ``cli eval --save-holdout`` saves it)."""
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.utils.checkpoint import save_bank
    from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=1, M=8), num_envs=8, bank_capacity=16,
                      replay_capacity=64, seed=0)
    bank = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device(
        forward_fraction=0.25)
    net = ConvQNetwork(dueling=True, joint=True, generator=torch.Generator().manual_seed(3))
    trainer = DQNTrainer(cfg, bank=bank, net=net, device="cpu")
    ckpt = str(tmp_path / "ckpt" / "final")
    trainer.save_checkpoint(ckpt)
    save_bank(ckpt, trainer.bank)
    hold = ConfigBank(1, 8, capacity=16, seed=9, device="cpu").fill_device(
        forward_fraction=forward_fraction)
    save_bank(str(tmp_path / "holdout"), hold)
    return trainer, ckpt, hold


def held_out_reading(step, holdout, carve, forward, train_bank, key="bank"):
    ev = {"holdout": {"win_rate": holdout, "episodes": 8192,
                      "families": {"carve": 1024, "forward": 1024},
                      "build": {"host_forward": 700, "device_forward": 324}},
          "holdout_carve": {"win_rate": carve}, "holdout_forward": {"win_rate": forward},
          key: {"win_rate": train_bank}}
    return {"step": step, "source": "eval", "eval": ev}
