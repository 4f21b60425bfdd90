"""Two faults of the port against the JAX package, held as tests.

* ``make_state_batch`` (array engine and bitboard) takes ``lines_goal`` and
  ``move_limit`` as scalars or per-env [N] arrays, as JAX broadcasts them;
  Python ints, numpy arrays and tensors all work, and a few steps of
  identical actions end each env as JAX's does.
* A device refresh holds the bank's lock across its generation, as JAX's
  ``refresh_device`` does: host rows that a producer swaps in meanwhile wait
  and land in the new rows, and ``refresh_writes`` counts what landed. The
  probe is deterministic: the patched generator fires a 4-row
  ``_swap_rows`` from another thread and returns once that swap has either
  landed or is waiting on the lock."""

import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import adversarial_boards, assert_states_equal

from tetris_piclim_tpu import engine as jengine
from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu_torch import engine
from tetris_piclim_tpu_torch.gen import device_carver, device_forward
from tetris_piclim_tpu_torch.gen.bank import (
    FAMILY_CARVE, FAMILY_FORWARD, ConfigBank, _row_key, pack_host_rows,
)
from tetris_piclim_tpu_torch.gen.carver import CarvingGenerator
from tetris_piclim_tpu_torch.ops import bitboard as tbb

torch.set_num_threads(1)

N, M = 48, 8
GOALS = np.arange(N) % 3 + 1             # 1, 2, 3, ...
LIMITS = np.arange(N) % 4 + 2            # 2..5: some envs run out of moves


def _as(kind: str, x: np.ndarray):
    return {"int": int(x[0]), "numpy": x, "tensor": torch.as_tensor(x)}[kind]


def _assert_env_equal(got: engine.EnvState, want, msg: str) -> None:
    for f in engine.EnvState._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f"{msg} {f}")


@pytest.mark.parametrize("kind", ["int", "numpy", "tensor"])
@pytest.mark.parametrize("module", ["bitboard", "engine"])
def test_make_state_batch_per_env_goals_match_jax(module, kind):
    rng = np.random.default_rng(7)
    boards = adversarial_boards(rng, N)
    pieces = rng.integers(0, 7, (N, M + 1)).astype(np.int8)
    goals = GOALS if kind != "int" else np.full(N, 2)
    limits = LIMITS if kind != "int" else np.full(N, 3)
    if module == "bitboard":
        js = jbb.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces),
                                  jnp.asarray(goals), jnp.asarray(limits))
        ts = tbb.make_state_batch(torch.as_tensor(boards), torch.as_tensor(pieces),
                                  _as(kind, goals), _as(kind, limits))
        jstep, tstep, same = jax.jit(jbb.step), tbb.step, assert_states_equal
    else:
        js = jengine.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces),
                                      jnp.asarray(goals), jnp.asarray(limits))
        ts = engine.make_state_batch(torch.as_tensor(boards), torch.as_tensor(pieces),
                                     _as(kind, goals), _as(kind, limits))
        jstep, tstep, same = jax.jit(jengine.step_batch), engine.step, _assert_env_equal
    assert ts.lines_goal.dtype == torch.int32 and ts.move_limit.dtype == torch.int32
    np.testing.assert_array_equal(ts.lines_goal.numpy(), goals)
    np.testing.assert_array_equal(ts.move_limit.numpy(), limits)
    same(ts, js, "fresh")
    for k in range(6):
        rot = rng.integers(0, 4, N).astype(np.int32)
        loc = rng.integers(0, 10, N).astype(np.int32)
        jr = jstep(js, jnp.asarray(rot), jnp.asarray(loc))
        tr = tstep(ts, torch.as_tensor(rot), torch.as_tensor(loc))
        same(tr.state, jr.state, f"step {k}")
        js, ts = jr.state, tr.state
    status = ts.status.numpy()
    if kind != "int":  # per-env limits of 2..5 end envs by the move limit
        assert (status != engine.RUNNING).sum() >= N // 4, status


class _ProbeLock:
    """The bank's lock, reporting on ``contended`` when an acquire has to
    wait (the swap thread finds it held)."""

    def __init__(self, inner, contended: threading.Event):
        self.inner, self.contended = inner, contended

    def __enter__(self):
        if not self.inner.acquire(blocking=False):
            self.contended.set()
            self.inner.acquire()
        return self

    def __exit__(self, *exc):
        self.inner.release()


def _fresh_rows(L: int, M: int, n: int) -> list:
    return [CarvingGenerator(L, M, rng=random.Random(1000 + k)).generate()
            for k in range(n)]


@pytest.mark.parametrize("forward_fraction", [0.0, 0.5])
def test_refresh_keeps_rows_swapped_in_during_generation(monkeypatch, forward_fraction):
    L, M = 1, 8
    bank = ConfigBank(L, M, capacity=16, seed=3, device="cpu").fill_device()
    fresh = _fresh_rows(L, M, 4)
    family = FAMILY_FORWARD if forward_fraction > 0 else FAMILY_CARVE
    ready = threading.Event()   # the swap has landed or waits on the lock
    bank._lock = _ProbeLock(bank._lock, ready)
    threads = []

    def swap():
        bank._swap_rows(fresh, family)
        ready.set()

    def firing(original):
        def generate(*args, **kwargs):
            out = original(*args, **kwargs)
            if not threads:
                th = threading.Thread(target=swap, daemon=True)
                threads.append(th)
                th.start()
                assert ready.wait(timeout=60), "the swap neither landed nor waited"
            return out
        return generate

    # the carve-only refresh fires from the carver, the forward one from
    # the prover (which runs after the carver inside fill_device)
    target = device_forward if forward_fraction > 0 else device_carver
    monkeypatch.setattr(target, "generate_batch_device",
                        firing(target.generate_batch_device))
    before = bank.row_keys()
    bank.refresh_device(seed=11, forward_fraction=forward_fraction)
    assert len(threads) == 1
    threads[0].join(timeout=60)
    assert not threads[0].is_alive(), "the swap thread deadlocked"

    cols, pieces = pack_host_rows(fresh, bank.P)
    boards = tbb.unpack_board(cols).numpy()
    fresh_keys = {_row_key(b, p) for b, p in zip(boards, pieces.numpy())}
    after = bank.row_keys()
    landed = fresh_keys & after
    assert landed == fresh_keys, f"{len(landed)} of 4 swapped rows survived"
    assert bank.refresh_writes == len(landed) == 4
    assert len(after - before - fresh_keys) >= 8  # the refresh made new rows
    assert int((bank.family == family).sum()) >= 4
