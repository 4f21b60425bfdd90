"""Curriculum over (L, M) levels, with a level per env.

Counterpart of ``tetris_piclim_tpu/gen/curriculum.py``. The packed state
carries ``lines_goal`` / ``move_limit`` per env, so one step serves a
population of difficulties. This module gives each level a bank of winnable
configurations (:func:`build_curriculum_bank`, the device carver once per
level), an auto-reset that draws each finished env's fresh configuration
from the bank of its own level, and the host promotion between chunks.

Every random draw can be an input (``idx``, the bank rows), so the tests
hold :func:`make_states` and :func:`step_autoreset_curriculum` against the
JAX functions given the rows JAX drew; :func:`promote_levels` is numpy
``Generator`` code, word for word the JAX package's.
"""

from __future__ import annotations

import random
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops import bitboard
from .device_carver import generate_batch_device


class CurriculumBank(NamedTuple):
    """Stacked per-level banks; level k holds configurations carved for
    (L=lines[k], M=moves[k])."""

    boards: torch.Tensor   # int32[K, B, 10] packed
    pieces: torch.Tensor   # int8[K, B, P], P = max(M) + 1
    lines: torch.Tensor    # int32[K]
    moves: torch.Tensor    # int32[K]


def level_seeds(seed: int, n_levels: int) -> list[int]:
    """The seeds of the levels' bank generators: one
    ``random.Random(seed).randint(0, 2**31 - 1)`` per level, in level order,
    as the device bank seeds an unseeded fill (``ConfigBank._generator``).
    The curriculum trainer seeds its generator on the same device with
    ``seed`` itself, so its draws are not the words that carved a bank (JAX
    splits one key into bank, env and init keys)."""
    rng = random.Random(seed)
    return [rng.randint(0, 2**31 - 1) for _ in range(n_levels)]


def build_curriculum_bank(levels: Sequence[tuple[int, int]], capacity: int, *,
                          seed: int = 0, device="cuda") -> CurriculumBank:
    """Carve ``capacity`` winnable configurations per (L, M) level on the
    device, level k from a generator seeded ``level_seeds(seed, K)[k]``.
    All levels share one piece length P = max(M) + 1; a shorter level's
    sequences are padded with uniform random pieces from its generator (the
    step reads only the entries its cursor reaches)."""
    dev = torch.device(device)
    P = max(m for _, m in levels) + 1
    boards, pieces = [], []
    for (L, M), level_seed in zip(levels, level_seeds(seed, len(levels))):
        gen = torch.Generator(device=dev).manual_seed(level_seed)
        batch = generate_batch_device(capacity, L, M, generator=gen, device=dev)
        seq = batch.pieces
        if seq.shape[1] < P:
            pad = torch.randint(0, 7, (capacity, P - seq.shape[1]), generator=gen,
                                device=dev).to(torch.int8)
            seq = torch.cat([seq, pad], dim=1)
        boards.append(batch.boards)
        pieces.append(seq)
    return CurriculumBank(
        boards=torch.stack(boards),
        pieces=torch.stack(pieces),
        lines=torch.tensor([L for L, _ in levels], dtype=torch.int32, device=dev),
        moves=torch.tensor([M for _, M in levels], dtype=torch.int32, device=dev),
    )


def make_states(bank: CurriculumBank, level: torch.Tensor,
                idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> bitboard.PackedState:
    """Fresh states at per-env levels ``level`` (int[N]) from bank rows
    ``idx`` (int[N]; drawn uniformly from ``generator`` when not given)."""
    n, dev = level.shape[0], bank.boards.device
    level = level.long()
    if idx is None:
        idx = torch.randint(0, bank.boards.shape[1], (n,), generator=generator,
                            device=dev)
    idx = idx.long()
    z = torch.zeros((n,), dtype=torch.int32, device=dev)
    return bitboard.PackedState(
        cols=bank.boards[level, idx],
        pieces=bank.pieces[level, idx],
        cursor=z,
        lines_cleared=z,
        moves_used=z,
        lines_goal=bank.lines[level],
        move_limit=bank.moves[level],
        status=torch.zeros((n,), dtype=torch.int8, device=dev),
    )


def step_autoreset_curriculum(
    states: bitboard.PackedState,
    rotations: torch.Tensor,
    locations: torch.Tensor,
    bank: CurriculumBank,
    level: torch.Tensor,       # int[N] each env's current level
    reset_idx: torch.Tensor,   # int[N] bank rows for envs that finish
):
    """Step; terminal envs reset from the bank of their level at rows
    ``reset_idx`` and take that level's L/M (so a level changed between
    steps applies at the next reset)."""
    res = bitboard.step(states, rotations, locations)
    fresh = make_states(bank, level, reset_idx)
    return bitboard.state_where(res.done, fresh, res.state), res


def promote_levels(
    level: np.ndarray,
    win_rate_per_level: np.ndarray,
    n_levels: int,
    threshold: float = 0.8,
    fraction: float = 0.5,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Host promotion between chunks: where a level's recent win rate
    reaches ``threshold``, move ``fraction`` of its envs up one level."""
    rng = rng or np.random.default_rng(0)
    level = level.copy()
    for k in range(n_levels - 1):
        if win_rate_per_level[k] >= threshold:
            members = np.flatnonzero(level == k)
            n_up = int(len(members) * fraction)
            if n_up:
                level[rng.choice(members, n_up, replace=False)] = k + 1
    return level
