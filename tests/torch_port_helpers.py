"""Shared inputs for the torch-port tests: numpy-made boards, banks and
streams that go through both the JAX package and its PyTorch port."""

from __future__ import annotations

import numpy as np
import torch


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
