"""Offline tuner of the DFS solver's ``max_attempts`` cutoff.

A copy of ``tetris_piclim_tpu/gen/minimize.py``: the reference's
``minimize_max_attempts`` (game/tetris_algo_main/minimization.py:1-30)
picks, from ``{"solvable", "failed_attempts"}`` probe stats, the give-up
cutoff that maximises solved games per unit of work; ``probe_and_tune``
runs the probe batch the reference left commented out (main.py:46-58).

The work model is the reference's: for a cutoff ``A`` (each observed
``failed_attempts + 1`` of a solvable game) the work is ``A * n_games``
minus the attempts saved by games solved before the cutoff; a game counts
once, at exactly its observed attempt count; the first best ratio wins.
"""

from __future__ import annotations

from typing import Sequence


def minimize_max_attempts(attempts: Sequence[dict]) -> int:
    """The cutoff with the best solved/work ratio (the reference's candidate
    set, work model and tie rule)."""
    size = len(attempts)
    best_cutoff = 0
    best_ratio = 0.0
    seen: set[tuple] = set()

    for rec in attempts:
        key = tuple(rec.items())
        if key in seen or not rec["solvable"]:
            continue
        seen.add(key)

        cutoff = rec["failed_attempts"] + 1
        solved = 0
        work = cutoff * size
        for j in range(cutoff * size):
            attempt_no = j // size + 1
            r = attempts[j % size]
            if r["solvable"] and r["failed_attempts"] + 1 == attempt_no:
                solved += 1
                work -= cutoff - attempt_no

        ratio = solved / work
        if ratio > best_ratio:
            best_ratio = ratio
            best_cutoff = cutoff

    return best_cutoff


def probe_and_tune(
    L: int,
    M: int,
    probe_seeds: int = 50,
    initial_height_max: int = 4,
    probe_max_attempts: int = 1000,
    workers=None,
) -> int:
    """Prove seeds 0..probe_seeds-1 with the DFS solver and return the tuned
    cutoff of their stats."""
    from concurrent.futures import ThreadPoolExecutor

    from .forward import ForwardGenerator
    from .solver import GreedyDFSSolver

    def probe(seed):
        g = ForwardGenerator(seed=seed, goal=L, num_pieces=M,
                             initial_height_max=initial_height_max)
        solver = GreedyDFSSolver(g.board, g.sequence, L,
                                 max_attempts=probe_max_attempts)
        ok, _, failed = solver.solve()
        return {"solvable": ok, "failed_attempts": failed}

    with ThreadPoolExecutor(max_workers=workers) as pool:
        stats = list(pool.map(probe, range(probe_seeds)))
    return minimize_max_attempts(stats)
