"""The plain version of the CUDA kernels' Philox draw stream.

``ops/rollout.py::philox4x32_10`` is held against a numpy Philox written
here independently (uint64 products) and against the Random123 known
answers; ``philox_draws`` against the documented mapping from words to
draws (x: explore u, y: rotation, z: column, w: bank row) and against the
contract that a stream depends on (seed, env, step) only. Everything is
integer arithmetic, so every comparison is exact."""

import numpy as np
import pytest
import torch

from tetris_piclim_tpu_torch.ops import actor as tactor
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from tetris_piclim_tpu_torch.ops import rollout as trollout
from tetris_piclim_tpu_torch.models.qnet import QNetwork
from tetris_piclim_tpu_torch import tables

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _np_philox(counter: np.ndarray, key) -> np.ndarray:
    """Philox-4x32-10 on uint32[..., 4] counters, from the paper's round
    function: uint64 products, the key bumped by the Weyl constants."""
    c = counter.astype(np.uint64)
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    mask = np.uint64(0xFFFFFFFF)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[..., 0]
        p1 = np.uint64(0xCD9E8D57) * c[..., 2]
        c = np.stack([(p1 >> np.uint64(32)) ^ c[..., 1] ^ k0, p1 & mask,
                      (p0 >> np.uint64(32)) ^ c[..., 3] ^ k1, p0 & mask], axis=-1)
        k0 = (k0 + np.uint64(0x9E3779B9)) & mask
        k1 = (k1 + np.uint64(0xBB67AE85)) & mask
    return c.astype(np.uint32)


def _torch_philox(counter: np.ndarray, key) -> np.ndarray:
    words = [torch.as_tensor(counter[..., i].astype(np.int64)) for i in range(4)]
    out = trollout.philox4x32_10(words, key)
    assert all(o.dtype == torch.int64 for o in out)
    return np.stack([o.numpy() for o in out], axis=-1).astype(np.uint32)


# Random123's kat_vectors for philox4x32-10: counter, key, output
KNOWN = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KNOWN)
def test_philox_known_answers(counter, key, want):
    c = np.array(counter, dtype=np.uint32)
    assert tuple(int(v) for v in _np_philox(c, key)) == want
    assert tuple(int(v) for v in _torch_philox(c, key)) == want


def test_philox_matches_numpy_on_random_counters():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2**32, (2048, 4), dtype=np.uint64).astype(np.uint32)
    c[:8] = 0xFFFFFFFF  # carries in every limb
    c[8:16, 0] = np.arange(8)
    for key in ((0, 0), (12345, 0), (0xFFFFFFFF, 0xDEADBEEF)):
        np.testing.assert_array_equal(_torch_philox(c, key), _np_philox(c, key))


def test_philox_draws_word_mapping():
    seed, n, K, bank = 0x9E3779B9 + 5, 50, 7, 37
    d = trollout.philox_draws(seed, n, K, bank)
    for x, dtype in zip(d, (torch.float32, torch.int32, torch.int32, torch.int32)):
        assert tuple(x.shape) == (K, n) and x.dtype == dtype
    env, step = np.meshgrid(np.arange(n), np.arange(K))
    c = np.stack([env, step, np.zeros_like(env), np.zeros_like(env)],
                 axis=-1).astype(np.uint32)
    w = _np_philox(c, (seed & 0xFFFFFFFF, 0)).astype(np.uint64)
    np.testing.assert_array_equal(d.rot.numpy(), (w[..., 1] * 4) >> 32)
    np.testing.assert_array_equal(d.col.numpy(), (w[..., 2] * 10) >> 32)
    np.testing.assert_array_equal(d.reset_idx.numpy(), (w[..., 3] * bank) >> 32)
    u = d.explore_u.numpy()
    np.testing.assert_array_equal(
        u, (w[..., 0] >> 8).astype(np.float32) * np.float32(2.0 ** -24))
    # 24 bits in [0, 1): u * 2^24 is a whole number below 2^24
    scaled = u.astype(np.float64) * 2 ** 24
    assert (scaled == np.floor(scaled)).all() and u.min() >= 0 and u.max() < 1
    assert d.actions == (d.rot, d.col, d.reset_idx) and len(d.draws) == 4


def test_philox_draws_ranges_and_spread():
    d = trollout.philox_draws(3, 512, 64, 256)
    for x, hi in ((d.rot, 4), (d.col, 10), (d.reset_idx, 256)):
        counts = np.bincount(x.numpy().ravel(), minlength=hi)
        assert len(counts) == hi and counts.min() > 0
        assert counts.max() < 1.5 * counts.mean()
    assert 0.45 < float(d.explore_u.mean()) < 0.55


def test_philox_draws_depend_on_seed_env_step_only():
    a = trollout.philox_draws(11, 8, 5, 64)
    b = trollout.philox_draws(11, 64, 9, 64)
    for x, y in zip(a, b):
        assert torch.equal(x, y[:5, :8])     # env 5 the same at N=8 and N=64
    c = trollout.philox_draws(12, 8, 5, 64)
    assert not torch.equal(a.rot, c.rot)
    # distinct (env, step) give distinct blocks: no stream is a shift of another
    assert not torch.equal(b.reset_idx[0], b.reset_idx[1])
    assert not torch.equal(b.reset_idx[:, 0], b.reset_idx[:, 1])


def test_plain_versions_run_on_philox_draws():
    """The plain rollout and actor accept philox_draws' streams as their
    scripted inputs (the form the kernels' random mode is compared in)."""
    n, K, M, bank = 24, 6, 8, 5
    rng = np.random.default_rng(1)
    pieces = torch.as_tensor(rng.integers(0, 7, (n, M + 1)), dtype=torch.int8)
    state = tbb.make_state_batch(torch.zeros((n, 20, 10), dtype=torch.bool), pieces, 1, M)
    bank_cols = torch.zeros((bank, 10), dtype=torch.int32)
    bank_pieces = torch.as_tensor(rng.integers(0, 7, (bank, M + 1)), dtype=torch.int8)
    d = trollout.philox_draws(9, n, K, bank)
    out, episodes, _ = trollout.rollout_fused(state, bank_cols, bank_pieces, K,
                                              actions=d.actions)
    assert int(out.moves_used.max()) <= M and int(episodes) >= 0
    _, trans, _, _ = tactor.actor_rollout_fused(
        state, QNetwork(), bank_cols, bank_pieces, 0, 0, eps_start=1.0,
        eps_end=1.0, eps_decay=1.0, n_steps=K, draws=d.draws)
    assert torch.equal(trans.rot, d.rot) and torch.equal(trans.col, d.col)


def test_kernel_tables_pack_every_rotation():
    """The kernels' packed piece table against tables.py: entry
    piece * 4 + q describes rotation q mod nrot."""
    t = tbb.kernel_tables(torch.device("cpu")).numpy().astype(np.int64).reshape(28, 2)
    for p in range(7):
        for q in range(4):
            r = q % int(tables.NROT[p])
            x, y = t[p * 4 + q]
            w, h = int(tables.WIDTH[p, r]), int(tables.HEIGHT[p, r])
            assert y & 7 == w and (y >> 4) & 15 == (1 << h) - 1
            for c in range(4):
                mask = sum(1 << row for row in range(4)
                           if c < w and tables.MASKS[p, r, row, c])
                assert (x >> (4 * c)) & 15 == mask
                assert (x >> (16 + 4 * c)) & 15 == (tables.RTOPO[p, r, c] if c < w else 0)
            assert x >> 32 == 0
