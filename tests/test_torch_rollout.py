"""Port random-policy rollout (plain version) vs a scan of the JAX package's
``bitboard.step``, and its random mode.

Scripted streams (the ``actions=`` path of the Pallas kernel's own test,
tests/test_pallas_rollout.py) must give the identical final state, episode
and win counts; the random mode must spread its resets over the bank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from tetris_piclim_tpu_torch.ops import rollout as trollout
from torch_port_helpers import (
    adversarial_boards, assert_states_equal, bank_rows, t,
)

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _jax_scan(state, bank_cols, bank_pieces, rots, locs, idxs):
    """bitboard.step + bank-row auto-reset, as tests/test_pallas_rollout.py."""
    n = state.cols.shape[0]
    zeros = jnp.zeros((n,), jnp.int32)

    def body(carry, xs):
        state, episodes, wins = carry
        rot, loc, idx = xs
        res = jbb.step(state, rot, loc)
        fresh = jbb.PackedState(
            cols=bank_cols[idx], pieces=bank_pieces[idx], cursor=zeros,
            lines_cleared=zeros, moves_used=zeros,
            lines_goal=state.lines_goal, move_limit=state.move_limit,
            status=jnp.zeros((n,), jnp.int8))
        nxt = jax.tree.map(
            lambda f, s: jnp.where(res.done.reshape((-1,) + (1,) * (f.ndim - 1)), f, s),
            fresh, res.state)
        return (nxt, episodes + res.done.sum(dtype=jnp.int32),
                wins + res.won.sum(dtype=jnp.int32)), None

    (state, episodes, wins), _ = jax.lax.scan(
        body, (state, jnp.int32(0), jnp.int32(0)), (rots, locs, idxs))
    return state, int(episodes), int(wins)


@pytest.mark.parametrize("L,M,n_steps,seed", [(2, 20, 48, 0), (4, 6, 25, 1), (1, 30, 17, 2)])
def test_rollout_reference_matches_jax_scan(L, M, n_steps, seed):
    rng = np.random.default_rng(seed)
    n, bank = 126, 16
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    bank_boards, bank_pieces = bank_rows(rng, bank, M + 1)
    rots = rng.integers(0, 8, (n_steps, n)).astype(np.int32)
    locs = rng.integers(0, 10, (n_steps, n)).astype(np.int32)
    idxs = rng.integers(0, bank, (n_steps, n)).astype(np.int32)

    js, jeps, jwins = _jax_scan(
        jbb.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces), L, M),
        jbb.pack_board(jnp.asarray(bank_boards)), jnp.asarray(bank_pieces),
        jnp.asarray(rots), jnp.asarray(locs), jnp.asarray(idxs))
    ts, teps, twins = trollout.rollout_fused(
        tbb.make_state_batch(t(boards), t(pieces), L, M),
        tbb.pack_board(t(bank_boards)), t(bank_pieces), n_steps,
        actions=(t(rots), t(locs), t(idxs)))
    assert_states_equal(ts, js)
    assert (int(teps), int(twins)) == (jeps, jwins)
    assert jeps > 0


def test_rollout_random_mode_spreads_over_the_bank():
    rng = np.random.default_rng(0)
    n, K, bank, M = 512, 60, 16, 20
    bank_boards, bank_pieces = bank_rows(rng, bank, M + 1)
    bank_cols = tbb.pack_board(t(bank_boards))
    idx = torch.arange(n) % bank
    state = tbb.make_state_batch(bank_cols[idx], t(bank_pieces)[idx], 2, M)
    out, episodes, _ = trollout.rollout_fused(state, bank_cols, t(bank_pieces), K, seed=3)
    assert int(episodes) > n
    rows = {r.tobytes(): i for i, r in enumerate(bank_pieces)}
    hits = np.bincount([rows[r.tobytes()] for r in out.pieces.numpy()], minlength=bank)
    assert hits.sum() == n and hits.min() > 0.5 * n / bank and hits.max() < 1.5 * n / bank
    assert len(np.unique(out.moves_used.numpy())) > 3
    # the seed decides the draws
    again = trollout.rollout_fused(state, bank_cols, t(bank_pieces), K, seed=3)
    other = trollout.rollout_fused(state, bank_cols, t(bank_pieces), K, seed=4)
    assert torch.equal(out.cols, again[0].cols)
    assert not torch.equal(out.cols, other[0].cols)
