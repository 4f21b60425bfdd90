"""Seeded forward initial-configuration generator (host-side).

A copy of ``tetris_piclim_tpu/gen/forward.py`` (pure Python and numpy; the
JAX package's module is not imported because that package imports JAX).
Behavioral re-implementation of the reference's ``TetrisGameGenerator``
(reference: game/tetris_algo_main/TetrisGameGenerator.py): drop uniformly
random tetrominoes onto an empty board until the next placement would push the
stack above ``initial_height_max``, then emit a 7-bag piece-letter sequence of
length ``num_pieces``.

**Seed determinism is part of the contract** (reference seeds the global
``random`` per seed at TetrisGameGenerator.py:24, and the warm-reset pipeline
regenerates the same 100 boards forever — SURVEY.md §3.5). This module makes
the *identical sequence of calls* into a ``random.Random`` so that for any
seed it produces bit-identical boards and sequences to the reference; parity
is enforced by tests/test_generators.py, and tests/test_torch_holdout.py
holds this copy to the JAX package's.

Consciously dropped dead code: the reference's S/Z-adjacency reshuffle
(TetrisGameGenerator.py:99) uses a chained comparison that can never be true
inside a duplicate-free bag, so it never fires; we omit it rather than carry
dead logic (quirk policy, SURVEY.md §7).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from ..tables import BOARD_H, BOARD_W, GEN_NAME_ORDER, GEN_SHAPES


class ForwardGenerator:
    """Generate one (board, sequence) candidate from a seed.

    Parameters mirror the reference ctor (TetrisGameGenerator.py:14):
    ``goal`` = L (lines to clear), ``num_pieces`` = M (move budget, length of
    the emitted sequence), ``initial_height_max`` = stack-height cap for the
    prefill (the warm-reset pipeline uses 4 — reference
    game/tetris_algo_main/main.py:38).
    """

    def __init__(
        self,
        seed: Optional[int] = None,
        goal: int = 15,
        num_pieces: int = 40,
        initial_height_max: int = 7,
        height: int = BOARD_H,
        width: int = BOARD_W,
    ) -> None:
        self.seed = seed
        self.goal = goal
        self.num_pieces = num_pieces
        self.initial_height_max = initial_height_max
        self.height = height
        self.width = width
        self.board = np.zeros((height, width), dtype=np.int64)

        self._rng = random.Random()
        # Matches the reference's `random.seed(self.seed)` draw stream.
        self._rng.seed(seed)
        self._prefill()
        self.sequence = self._bag_sequence(num_pieces)

    # -- prefill ------------------------------------------------------------

    def _fits(self, shape: np.ndarray, row: int, col: int) -> bool:
        h, w = shape.shape
        if row + h > self.height or col < 0 or col + w > self.width:
            return False
        return not np.any(self.board[row : row + h, col : col + w] + shape > 1)

    def _descend(self, shape: np.ndarray, col: int) -> int:
        """Number of rows the piece can descend from row 0 (reference
        ``calculate_placement_height``, TetrisGameGenerator.py:61-69)."""
        h, w = shape.shape
        row = 0
        while row + h <= self.height and not np.any(
            self.board[row : row + h, col : col + w] + shape > 1
        ):
            row += 1
        return row

    def _prefill(self) -> None:
        """Reference ``fill_grid`` (TetrisGameGenerator.py:72-85): random
        pieces drop until the next one would exceed the height cap. A piece
        that collides at row 0 is skipped (continue, not break)."""
        while True:
            name = self._rng.choice(list(GEN_NAME_ORDER))
            rots = GEN_SHAPES[name]
            rot = self._rng.randint(0, len(rots) - 1)
            shape = rots[rot]
            col = self._rng.randint(0, self.width - shape.shape[1])
            if not self._fits(shape, 0, col):
                continue
            depth = self._descend(shape, col)
            if self.height + 1 - depth > self.initial_height_max:
                break
            h, w = shape.shape
            self.board[depth - 1 : depth - 1 + h, col : col + w] += shape
            full = np.all(self.board, axis=1)
            if full.any():
                self.board = np.vstack(
                    [
                        np.zeros((int(full.sum()), self.width), dtype=np.int64),
                        self.board[~full],
                    ]
                )

    # -- sequence -----------------------------------------------------------

    def _bag_sequence(self, length: int) -> list[str]:
        """7-bag letter sequence (reference
        ``generate_tetromino_sequence``, TetrisGameGenerator.py:90-106)."""
        out: list[str] = []
        while len(out) < length:
            bag = list(GEN_NAME_ORDER)
            self._rng.shuffle(bag)
            out.extend(bag)
        return out[:length]


def generate_board_and_sequence(
    seed: int, num_pieces: int, initial_height_max: int, goal: int = 0
) -> tuple[np.ndarray, list[str]]:
    """Reference-compatible helper (TetrisGameGenerator.py:115-117)."""
    g = ForwardGenerator(
        seed=seed,
        goal=goal,
        num_pieces=num_pieces,
        initial_height_max=initial_height_max,
    )
    return g.board, g.sequence
