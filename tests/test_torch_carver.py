"""Port device carver and bank: every carved configuration's recorded
solution replays to a WIN clearing >= L lines, through the port's step and
through the JAX package's ``bitboard.step`` alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.gen.device_carver import generate_batch_device
from tetris_piclim_tpu_torch.ops import bitboard as tbb

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _replay_jax(boards, pieces, rots, locs, L, M):
    state = jbb.make_state_batch(jnp.asarray(boards, jnp.uint32),
                                 jnp.asarray(pieces), L, M)
    step = jax.jit(jbb.step)
    for i in range(rots.shape[1]):
        res = step(state, jnp.asarray(rots[:, i], jnp.int32),
                   jnp.asarray(locs[:, i], jnp.int32))
        frozen = state.status != 0
        state = jax.tree.map(
            lambda a, b: jnp.where(frozen.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
            state, res.state)
    return np.asarray(state.status), np.asarray(state.lines_cleared)


def _replay_torch(boards, pieces, rots, locs, L, M):
    state = tbb.make_state_batch(boards, pieces, L, M)
    for i in range(rots.shape[1]):
        res = tbb.step(state, rots[:, i], locs[:, i])
        state = tbb.state_where(state.status != 0, state, res.state)
    return state.status.numpy(), state.lines_cleared.numpy()


@pytest.mark.parametrize("L,M", [(1, 8), (2, 20), (4, 12)])
def test_carved_solutions_replay_to_win(L, M):
    gen = torch.Generator().manual_seed(L * 100 + M)
    b = generate_batch_device(128, L, M, generator=gen, device="cpu")
    n_mv = b.n_moves.numpy()
    assert (n_mv > 0).all() and (n_mv <= M).all()
    # a row wins at its n_moves-th step and is frozen from then on
    rots = b.rotations.numpy().astype(np.int32)
    locs = b.locations.numpy().astype(np.int32)
    steps = int(n_mv.max())
    st_t, lines_t = _replay_torch(b.boards, b.pieces, torch.as_tensor(rots[:, :steps]),
                                  torch.as_tensor(locs[:, :steps]), L, M)
    st_j, lines_j = _replay_jax(b.boards.numpy().astype(np.uint32), b.pieces.numpy(),
                                rots[:, :steps], locs[:, :steps], L, M)
    np.testing.assert_array_equal(st_t, st_j)
    np.testing.assert_array_equal(lines_t, lines_j)
    assert (st_t == 1).all(), f"{(st_t != 1).sum()} carved configs did not win"
    assert (lines_t >= L).all()
    # no initial full rows survive in the carved boards
    assert not tbb.unpack_board(b.boards).all(dim=-1).any()


def test_bank_fill_and_refresh():
    bank = ConfigBank(2, 20, capacity=64, seed=0, device="cpu").fill_device()
    assert bank.cols.shape == (64, 10) and bank.cols.dtype == torch.int32
    assert bank.pieces.shape == (64, 21) and bank.pieces.dtype == torch.int8
    before = bank.cols.clone()
    bank.refresh_device(seed=5)
    assert not torch.equal(before, bank.cols)
    assert bank.family_counts == {"carve": 64, "forward": 0}
    # the forward share is ported (tests/test_torch_holdout.py)
    assert bank.fill_device(forward_fraction=0.25).family_counts["forward"] == 16
