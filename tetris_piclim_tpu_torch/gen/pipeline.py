"""Batch generation and winnability proving of forward-family games (host).

Counterpart of ``tetris_piclim_tpu/gen/pipeline.py``, pure Python and numpy:
generate candidate games from a seed range, prove each winnable with the
greedy DFS solver, keep the winnable ones (reference
game/tetris_algo_main/main.py:26-95: a process pool there, a thread pool
here by default and a spawn-context process pool on request, as in JAX;
the workers import no torch). The host bank fill, its forward producer
and the held-out bank's forward rows come from here, so the calls into
``random.Random`` are the JAX package's, one for one.

Quirk policy (SURVEY.md §3.5, §7): the reference's ``translate``
(game/tetris.py:19-20) PREPENDS one random piece to every proven sequence,
which shifts the proven sequence by one; ``translate_batch(parity=True)``
(the default, as in JAX) does the same, ``parity=False`` appends the piece
instead, so the proven sequence stays intact at the env's M+1 length.
"""

from __future__ import annotations

import multiprocessing
import random
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..tables import PIECE_IDS
from .forward import ForwardGenerator
from .solver import GreedyDFSSolver

DEFAULT_INITIAL_HEIGHT_MAX = 4  # reference game/tetris_algo_main/main.py:38
DEFAULT_MAX_ATTEMPTS = 1000     # reference game/tetris_algo_main/main.py:41
DEFAULT_BATCH = 100             # reference seeds range(0, 100), main.py:39-40


def _prove_one(args):
    seed, L, M, initial_height_max, max_attempts = args
    game = ForwardGenerator(
        seed=seed, goal=L, num_pieces=M, initial_height_max=initial_height_max
    )
    solver = GreedyDFSSolver(game.board, game.sequence, L,
                             max_attempts=max_attempts)
    solvable, _, _ = solver.solve()
    return game if solvable else None


def generate_batch(
    L: int,
    M: int,
    seed_start: int = 0,
    seed_end: int = DEFAULT_BATCH,
    initial_height_max: int = DEFAULT_INITIAL_HEIGHT_MAX,
    max_attempts: int = DEFAULT_MAX_ATTEMPTS,
    workers: Optional[int] = None,
    executor: str = "thread",
) -> list[ForwardGenerator]:
    """Generate and prove seeds [seed_start, seed_end); return the winnable
    games in seed order (reference ``generate_batch``).

    ``executor="process"`` proves on a spawn-context process pool of
    ``workers`` processes (the reference's design, main.py:31) instead of
    threads. A spawned worker re-imports the caller's ``__main__`` module,
    so a script that calls this needs its ``if __name__ == "__main__"``
    guard."""
    jobs = [(s, L, M, initial_height_max, max_attempts)
            for s in range(seed_start, seed_end)]
    if executor == "process":
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            results = list(pool.map(_prove_one, jobs, chunksize=8))
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(_prove_one, jobs))
    return [g for g in results if g is not None]


def translate_batch(
    games: list[ForwardGenerator],
    M: int,
    rng: Optional[random.Random] = None,
    parity: bool = True,
) -> list[tuple[np.ndarray, list[int]]]:
    """Letter sequences -> engine piece ids, with one random piece
    prepended (``parity=True``, the reference's ``translate``) or appended
    (``parity=False``)."""
    rng = rng or random
    out = []
    for g in games:
        ids = [PIECE_IDS[letter] for letter in g.sequence]
        extra = rng.randint(0, 6)
        seq = [extra] + ids if parity else ids + [extra]
        out.append((g.board.astype(bool), seq))
    return out
