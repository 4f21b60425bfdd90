"""CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; they skip where there is no GPU (the kernels have no CPU
mode). On the GPU host: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
The full-size checks and timings are in ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.models.qnet import QNetwork
from tetris_piclim_tpu_torch.ops import actor as actor_ops
from tetris_piclim_tpu_torch.ops import bitboard as bb
from tetris_piclim_tpu_torch.ops import rollout as rollout_ops

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state(rng, n, L, M, dev):
    boards = torch.as_tensor(rng.random((n, 20, 10)) < 0.3, device=dev)
    boards[:, :8] = False
    boards[boards.all(dim=2)] = False
    pieces = torch.as_tensor(rng.integers(0, 7, (n, M + 1)), device=dev)
    return bb.make_state_batch(boards, pieces, L, M)


@pytest.mark.parametrize("n", [100, 1024, 1023])
def test_rollout_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    L, M, K = 2, 12, 37
    bank = ConfigBank(L, M, capacity=32, seed=0, device=dev).fill_device()
    state = _state(rng, n, L, M, dev)
    acts = tuple(torch.as_tensor(rng.integers(lo, hi, (K, n)), dtype=torch.int32,
                                 device=dev) for lo, hi in ((0, 8), (-3, 13), (0, 32)))
    ker = rollout_ops.rollout_fused(state, bank.cols, bank.pieces, K, actions=acts)
    ref = rollout_ops.rollout_reference(state, bank.cols, bank.pieces, K, actions=acts)
    assert all(torch.equal(a, b) for a, b in zip(ker[0], ref[0]))
    assert int(ker[1]) == int(ref[1]) and int(ker[2]) == int(ref[2])


@pytest.mark.parametrize("joint", [False, True])
def test_actor_kernel_matches_plain(dev, joint):
    rng = np.random.default_rng(int(joint))
    n, L, M, K = 100, 2, 12, 5
    bank = ConfigBank(L, M, capacity=16, seed=0, device=dev).fill_device()
    state = _state(rng, n, L, M, dev)
    u = torch.as_tensor(rng.random((K, n)), dtype=torch.float32, device=dev)
    f = lambda hi: torch.as_tensor(rng.integers(0, hi, (K, n)), dtype=torch.int32,  # noqa: E731
                                   device=dev)
    draws = (u, f(4), f(10), f(16))
    net = QNetwork(joint=joint, generator=torch.Generator().manual_seed(0)).to(dev)
    kw = dict(eps_start=0.3, eps_end=0.3, eps_decay=100.0, n_steps=K, draws=draws,
              return_q=True)
    ker = actor_ops.actor_rollout_fused(state, net, bank.cols, bank.pieces, 0, 0, **kw)
    ref = actor_ops.actor_reference(state, net, bank.cols, bank.pieces, 0, **kw)
    torch.testing.assert_close(ker[4], ref[4], rtol=1e-5, atol=1e-5)
    assert torch.equal(ker[1].rot, ref[1].rot) and torch.equal(ker[1].col, ref[1].col)
    assert all(torch.equal(a, b) for a, b in zip(ker[0], ref[0]))


@pytest.mark.parametrize("n", [1024, 1001])
def test_rollout_kernel_philox_mode_matches_plain(dev, n):
    """Random mode word for word: the plain version scripted with
    philox_draws. K is not a multiple of the lane split."""
    rng = np.random.default_rng(n)
    L, M, K, seed = 2, 12, 37, 99
    bank = ConfigBank(L, M, capacity=32, seed=0, device=dev).fill_device()
    state = _state(rng, n, L, M, dev)
    ker = rollout_ops.rollout_fused(state, bank.cols, bank.pieces, K, seed=seed)
    ref = rollout_ops.rollout_reference(
        state, bank.cols, bank.pieces, K,
        actions=rollout_ops.philox_draws(seed, n, K, 32, dev).actions)
    assert all(torch.equal(a, b) for a, b in zip(ker[0], ref[0]))
    assert int(ker[1]) == int(ref[1]) and int(ker[2]) == int(ref[2])


@pytest.mark.parametrize("joint,n", [(False, 100), (True, 100), (False, 77)])
def test_actor_kernel_philox_mode_matches_plain(dev, joint, n):
    """Random mode: same states, transitions and actions as the plain
    version scripted with philox_draws (K > 8: two rounds of draws)."""
    rng = np.random.default_rng(int(joint))
    L, M, K, seed = 2, 12, 11, 5
    bank = ConfigBank(L, M, capacity=16, seed=0, device=dev).fill_device()
    state = _state(rng, n, L, M, dev)
    net = QNetwork(joint=joint, generator=torch.Generator().manual_seed(0)).to(dev)
    kw = dict(eps_start=0.3, eps_end=0.3, eps_decay=100.0, n_steps=K, return_q=True)
    ker = actor_ops.actor_rollout_fused(state, net, bank.cols, bank.pieces, 0, seed, **kw)
    ref = actor_ops.actor_reference(
        state, net, bank.cols, bank.pieces, 0, **kw,
        draws=rollout_ops.philox_draws(seed, n, K, 16, dev).draws)
    torch.testing.assert_close(ker[4], ref[4], rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(ker[1], ref[1]))
    assert all(torch.equal(a, b) for a, b in zip(ker[0], ref[0]))
