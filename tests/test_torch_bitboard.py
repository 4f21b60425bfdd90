"""Port tables and bitboard step vs the JAX package, on identical inputs.

The same numpy-made boards, pieces and (rot, loc, reset idx) streams go
through ``tetris_piclim_tpu.ops.bitboard`` and its PyTorch port; states must
agree word for word and observations float for float."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu import tables as jtables
from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu_torch import tables as ttables
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from torch_port_helpers import (
    adversarial_boards, assert_states_equal, bank_rows, pack_np, t,
)

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def test_tables_equal():
    for name in ("MASKS", "WIDTH", "HEIGHT", "RTOPO", "NROT"):
        np.testing.assert_array_equal(
            getattr(ttables, name), getattr(jtables, name), err_msg=name
        )
    for name in ("BOARD_H", "BOARD_W", "NUM_PIECES"):
        assert getattr(ttables, name) == getattr(jtables, name)
    np.testing.assert_array_equal(
        tbb.COLMASK10, np.asarray(jbb._COLMASK10).astype(np.int64)
    )
    np.testing.assert_array_equal(tbb.RTOPO10, np.asarray(jbb._RTOPO10))


def test_ctz20_and_popcount_exhaustive():
    x = torch.arange(1 << 20, dtype=torch.int32)
    ctz = tbb._ctz20(x).numpy()
    xs = np.arange(1 << 20)
    want = np.where(xs == 0, 20, np.log2(xs & -xs, where=xs > 0,
                                         out=np.zeros(1 << 20)).astype(int))
    np.testing.assert_array_equal(ctz, want)
    pc = tbb._popcount(x).numpy()
    np.testing.assert_array_equal(
        pc, np.unpackbits(xs.astype(">u4").view(np.uint8)).reshape(-1, 32).sum(1)
    )


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    boards = rng.random((16, 20, 10)) < 0.4
    cols = tbb.pack_board(t(boards))
    np.testing.assert_array_equal(cols.numpy(), pack_np(boards))
    np.testing.assert_array_equal(
        cols.numpy(), np.asarray(jbb.pack_board(jnp.asarray(boards))).astype(np.int64)
    )
    np.testing.assert_array_equal(tbb.unpack_board(cols).numpy(), boards)


@pytest.mark.parametrize("L,M,n_steps,seed", [
    (2, 20, 40, 0),   # long horizon, many resets
    (4, 6, 20, 1),    # loss/win boundary every 6 steps
    (1, 30, 12, 2),   # wins on first clear
])
def test_step_autoreset_matches_jax(L, M, n_steps, seed):
    """Scripted streams with rot in 0..7, loc in -3..12 (both sides out of
    range) and per-env reset rows, over adversarial boards: the state after
    every step is word-identical, observations float-identical."""
    rng = np.random.default_rng(seed)
    n, bank = 126, 16
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    bank_boards, bank_pieces = bank_rows(rng, bank, M + 1)
    rots = rng.integers(0, 8, (n_steps, n)).astype(np.int32)
    locs = rng.integers(-3, 13, (n_steps, n)).astype(np.int32)
    idxs = rng.integers(0, bank, (n_steps, n)).astype(np.int32)

    js = jbb.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces), L, M)
    ts = tbb.make_state_batch(t(boards), t(pieces), L, M)
    assert_states_equal(ts, js, "init")
    jbank = jbb.pack_board(jnp.asarray(bank_boards))
    tbank = tbb.pack_board(t(bank_boards))

    @jax.jit
    def jstep(state, rot, loc, idx):
        res = jbb.step(state, rot, loc)
        fresh = state._replace(
            cols=jbank[idx], pieces=jnp.asarray(bank_pieces)[idx],
            cursor=jnp.zeros_like(state.cursor),
            lines_cleared=jnp.zeros_like(state.cursor),
            moves_used=jnp.zeros_like(state.cursor),
            status=jnp.zeros_like(state.status),
        )
        nxt = jax.tree.map(
            lambda f, s: jnp.where(res.done.reshape((-1,) + (1,) * (f.ndim - 1)), f, s),
            fresh, res.state,
        )
        return nxt, res, jbb.observe(state)

    seen = {"lines": 0, "topout": 0, "win": 0}
    for k in range(n_steps):
        js_next, jres, jobs = jstep(js, rots[k], locs[k], idxs[k])
        np.testing.assert_array_equal(
            tbb.observe(ts).numpy(), np.asarray(jobs), err_msg=f"obs {k}"
        )
        ts_next, tres = tbb.step_autoreset_batch(
            ts, t(rots[k]), t(locs[k]), tbank, t(bank_pieces), t(idxs[k])
        )
        assert_states_equal(tres.state, jres.state, f"step {k}")
        for f in ("lines_delta", "done", "won"):
            np.testing.assert_array_equal(
                getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                err_msg=f"{f} {k}",
            )
        assert_states_equal(ts_next, js_next, f"reset {k}")
        seen["lines"] += int(np.asarray(jres.lines_delta).sum())
        seen["win"] += int(np.asarray(jres.won).sum())
        seen["topout"] += int(
            (np.asarray(jres.state.status) == 2).sum()
        )
        js, ts = js_next, ts_next
    # the streams really reach the interesting branches
    assert seen["topout"] > 0
    assert seen["lines"] > 0 and (L > 1 or seen["win"] > 0)
