"""Batch generation and winnability proving of forward-family games (host).

Counterpart of ``tetris_piclim_tpu/gen/pipeline.py``, pure Python and numpy:
generate candidate games from a seed range, prove each winnable with the
greedy DFS solver, keep the winnable ones (reference
game/tetris_algo_main/main.py:26-95, a process pool there, a thread pool
here). The held-out bank's forward rows come from here, so the calls into
``random.Random`` are the JAX package's, one for one.

The reference's ``translate`` (game/tetris.py:19-20) PREPENDS one random
piece to every proven sequence, which shifts the proven sequence by one.
Here the piece is appended, so the proven sequence stays intact and still
has the M+1 length of the env.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..tables import PIECE_IDS
from .forward import ForwardGenerator
from .solver import GreedyDFSSolver

DEFAULT_INITIAL_HEIGHT_MAX = 4  # reference game/tetris_algo_main/main.py:38
DEFAULT_MAX_ATTEMPTS = 1000     # reference game/tetris_algo_main/main.py:41
DEFAULT_BATCH = 100             # reference seeds range(0, 100), main.py:39-40


def _prove_one(args):
    seed, L, M = args
    game = ForwardGenerator(
        seed=seed, goal=L, num_pieces=M,
        initial_height_max=DEFAULT_INITIAL_HEIGHT_MAX,
    )
    solver = GreedyDFSSolver(
        game.board, game.sequence, L, max_attempts=DEFAULT_MAX_ATTEMPTS
    )
    solvable, _, _ = solver.solve()
    return game if solvable else None


def generate_batch(
    L: int,
    M: int,
    seed_start: int = 0,
    seed_end: int = DEFAULT_BATCH,
) -> list[ForwardGenerator]:
    """Generate and prove seeds [seed_start, seed_end); return the winnable
    games in seed order (reference ``generate_batch``)."""
    jobs = [(s, L, M) for s in range(seed_start, seed_end)]
    with ThreadPoolExecutor() as pool:
        results = list(pool.map(_prove_one, jobs))
    return [g for g in results if g is not None]


def translate_batch(
    games: list[ForwardGenerator],
    M: int,
    rng: Optional[random.Random] = None,
) -> list[tuple[np.ndarray, list[int]]]:
    """Letter sequences -> engine piece ids, plus one random piece appended."""
    rng = rng or random
    out = []
    for g in games:
        ids = [PIECE_IDS[letter] for letter in g.sequence]
        extra = rng.randint(0, 6)
        seq = ids + [extra]
        out.append((g.board.astype(bool), seq))
    return out
