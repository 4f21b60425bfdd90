"""Port device forward generator and beam prover against
``tetris_piclim_tpu/gen/jax_forward.py``: the prefill fed JAX's own draws,
the placement scorer (successor hashes included) and both provers give the
JAX package's integers exactly on identical inputs; every winner of the
port's generator replays to WIN; the device bags are true 7-bags."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.gen import jax_forward as jf
from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu_torch.gen import device_forward as tf
from tetris_piclim_tpu.gen.bag import SevenBag as JSevenBag
from tetris_piclim_tpu_torch.gen.bag import SevenBag, bag_sequences_device
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from torch_port_helpers import adversarial_boards, pack_np

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


@jax.jit
def _jax_candidates_jit(key, n_like, p_like):
    k_pre, k_seq = jax.random.split(key)
    cols = jf.prefill_boards_device(k_pre, n_like.shape[0])
    return cols, jf.bag_sequences_device(k_seq, n_like.shape[0], p_like.shape[0])


def _jax_candidates(seed: int, n: int, M: int):
    """(uint32 boards, int8 pieces) from JAX's own prefill (height 4) and
    bags."""
    cols, pieces = _jax_candidates_jit(jax.random.PRNGKey(seed),
                                       jnp.zeros(n), jnp.zeros(M + 1))
    return np.asarray(cols), np.array(pieces)


def _heights(cols: np.ndarray) -> np.ndarray:
    boards = np.asarray(tbb.unpack_board(torch.as_tensor(cols.astype(np.int32))))
    padded = np.concatenate([boards, np.ones(boards.shape[:1] + (1, 10), bool)], 1)
    return 20 - np.argmax(padded, axis=1)


@pytest.mark.parametrize("cap", [4, 7])
def test_prefill_matches_jax_on_jax_draws(cap):
    n, iters = 64, 96
    key = jax.random.PRNGKey(cap)
    want = np.asarray(jax.jit(jf.prefill_boards_device,
                              static_argnames=("n", "max_iters"))(
        key, n=n, initial_height_max=cap, max_iters=iters))
    # the fori_loop body's draws, rebuilt key split by key split
    # (gen/jax_forward.py:105-110)
    draws = ([], [], [])
    k = key
    for _ in range(iters):
        k, k_p, k_r, k_l = jax.random.split(k, 4)
        draws[0].append(np.asarray(jax.random.randint(k_p, (n,), 0, 7)))
        draws[1].append(np.asarray(jax.random.randint(k_r, (n,), 0, 4)))
        draws[2].append(np.asarray(jax.random.uniform(k_l, (n,))))
    got = tf.prefill_boards_device(
        n, cap, draws=tuple(torch.as_tensor(np.stack(d)) for d in draws))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert _heights(want).max() <= cap and (want != 0).any(axis=1).all()


def _states(kind: str):
    """A JAX and a port PackedState from identical numpy fields, with
    cursors and line counts spread so every score term is exercised."""
    rng = np.random.default_rng(7)
    L, M = 2, 12
    if kind == "jax_candidates":
        cols, pieces = _jax_candidates(11, 96, M)
        cols = cols.astype(np.int32)
    else:
        cols = pack_np(adversarial_boards(rng, 96))
        pieces = rng.integers(0, 7, (96, M + 1)).astype(np.int8)
    n = cols.shape[0]
    cursor = rng.integers(0, M, n).astype(np.int32)
    lines = rng.integers(0, L, n).astype(np.int32)
    js = jbb.make_state_batch(jnp.asarray(cols.astype(np.uint32)),
                              jnp.asarray(pieces), L, M)
    js = js._replace(cursor=jnp.asarray(cursor), lines_cleared=jnp.asarray(lines))
    ts = tbb.make_state_batch(torch.as_tensor(cols), torch.as_tensor(pieces), L, M)
    ts = ts._replace(cursor=torch.as_tensor(cursor),
                     lines_cleared=torch.as_tensor(lines))
    return js, ts


@pytest.mark.parametrize("kind", ["jax_candidates", "adversarial"])
def test_score_placements_matches_jax(kind):
    js, ts = _states(kind)
    want = jax.jit(jf._score_placements)(js)
    got = tf._score_placements(ts)
    for name, w, g in zip(("score", "win_now", "topout", "succ_hash"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype),
                                      err_msg=name)
    assert np.asarray(want[1]).any()
    assert np.asarray(want[2]).any() == (kind == "adversarial")
    w_rot, w_loc = jax.jit(jf._greedy_actions)(js)
    g_rot, g_loc = tf._greedy_actions(ts)
    np.testing.assert_array_equal(g_rot.numpy(), np.asarray(w_rot))
    np.testing.assert_array_equal(g_loc.numpy(), np.asarray(w_loc))


def _replay(boards, pieces, rots, locs, L, M):
    """Final (status, lines, moves) of recorded solutions through the port's
    step, finished envs frozen."""
    state = tbb.make_state_batch(boards, pieces, L, M)
    for i in range(M):
        res = tbb.step(state, rots[:, i], locs[:, i])
        state = tbb.state_where(state.status != 0, state, res.state)
    return state.status.numpy(), state.lines_cleared.numpy(), state.moves_used.numpy()


@pytest.mark.parametrize("n,L,M,beam", [(64, 2, 12, 1), (64, 2, 12, 8),
                                        (32, 10, 30, 1), (32, 10, 30, 8)])
def test_prove_matches_jax(n, L, M, beam):
    cols, pieces = _jax_candidates(100 * L + beam, n, M)
    want = jax.jit(jf.prove_batch_device, static_argnames=("L", "M", "beam_width"))(
        jnp.asarray(cols), jnp.asarray(pieces), L=L, M=M, beam_width=beam)
    got = tf.prove_batch_device(torch.as_tensor(cols.astype(np.int32)),
                                torch.as_tensor(pieces), L, M, beam_width=beam)
    for name, w, g in zip(("winnable", "rotations", "locations", "n_moves"),
                          want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    win = got[0].numpy()
    assert win.any() and (beam == 1 or win.mean() > 0.8)
    # the recorded solutions win, in exactly n_moves moves
    idx = torch.as_tensor(np.flatnonzero(win))
    status, lines, moves = _replay(torch.as_tensor(cols.astype(np.int32))[idx],
                                   torch.as_tensor(pieces)[idx],
                                   got[1][idx], got[2][idx], L, M)
    assert (status == 1).all() and (lines >= L).all()
    np.testing.assert_array_equal(moves, got[3].numpy()[win])


@pytest.mark.parametrize("beam", [1, 8])
def test_port_generator_winners_replay_to_win(beam):
    L, M, cap = 2, 20, 4
    gen = torch.Generator().manual_seed(beam)
    fb = tf.generate_batch_device(96, L, M, cap, beam, generator=gen, device="cpu")
    assert fb.boards.dtype == torch.int32 and fb.pieces.shape == (96, M + 1)
    assert _heights(fb.boards.numpy()).max() <= cap
    win = fb.winnable.numpy()
    assert win.mean() > (0.3 if beam == 1 else 0.9)
    assert (fb.n_moves.numpy()[~win] == 0).all()
    n_moves = fb.n_moves.numpy()[win]
    assert (n_moves >= 1).all() and (n_moves <= M).all()
    idx = torch.as_tensor(np.flatnonzero(win))
    status, lines, moves = _replay(fb.boards[idx], fb.pieces[idx],
                                   fb.rotations[idx], fb.locations[idx], L, M)
    assert (status == 1).all() and (lines >= L).all()
    np.testing.assert_array_equal(moves, n_moves)


def test_bag_sequences_are_seven_bags():
    gen = torch.Generator().manual_seed(0)
    seqs = bag_sequences_device(256, 31, generator=gen, device="cpu").numpy()
    assert seqs.shape == (256, 31) and seqs.dtype == np.int8
    for row in seqs:
        for k in range(31 // 7):
            assert sorted(row[7 * k:7 * (k + 1)].tolist()) == list(range(7))
        assert len(set(row[28:].tolist())) == 3  # the cut last bag
    # every piece is equally likely in every slot
    counts = np.stack([np.bincount(seqs[:, j], minlength=7) for j in range(31)])
    assert counts.min() > 0.5 * 256 / 7


def test_seven_bag_matches_jax():
    bag, jbag = SevenBag(random.Random(3)), JSevenBag(random.Random(3))
    for _ in range(40):
        got, want = bag.draw(), jbag.draw()
        assert got == want
        if got[1] % 2 == 0:  # a consumer that keeps odd-index draws in the bag
            bag.remove(got[1])
            jbag.remove(want[1])
        assert bag.pieces == jbag.pieces
    assert bag.sequence(23) == jbag.sequence(23) and len(bag) == 0
