"""Greedy-DFS winnability prover (host-side).

A copy of ``tetris_piclim_tpu/gen/solver.py`` (pure Python and numpy);
tests/test_torch_holdout.py holds its verdicts to the JAX package's.
Behavioral re-implementation of the reference ``TetrisSolver``
(reference: game/tetris_algo_main/TetrisSolver.py): for each rotation of the
current piece, try ONLY the single column with the deepest placement; place,
recurse on the rest of the sequence, undo on failure; succeed when
``lines_cleared >= goal``; give up after ``max_attempts`` failed placements.

Parity notes (these affect which games count as winnable, so they are
reproduced exactly — enforced by tests/test_generators.py):

* the column ranking is a stable sort by descending placement depth, so ties
  pick the leftmost column (TetrisSolver.py:97-99);
* the reference's ``np.any(tetromino[0] == 1)`` early-out
  (TetrisSolver.py:93) compares a list to an int and is always False — dead
  code, omitted here (quirk policy, SURVEY.md §7);
* the reference's trailing bookkeeping condition (TetrisSolver.py:158) uses
  ``len(current)`` — the length of a ONE-CHARACTER piece name — so it fires
  when ``rotation == 0`` and the tried column is the rightmost legal one,
  adding an extra failed attempt and a redundant board restore. Reproduced
  bit-for-bit because it shifts ``failed_attempts`` and therefore the
  max_attempts cutoff.

Recursion depth is bounded by the sequence length (one frame per piece), same
as the reference.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..tables import GEN_SHAPES


class GreedyDFSSolver:
    def __init__(self, board, sequence, goal: int, max_attempts: int = 100_000):
        self.initial_board = np.array(board)
        self.board = np.array(board)
        self.height = len(board)
        self.width = len(board[0])
        self.sequence = deque(sequence)
        self.goal = goal
        self.max_attempts = max_attempts
        self.lines_cleared = 0
        self.failed_attempts = 0
        self.stack: list[tuple[str, int, int]] = []

    def reset(self) -> None:
        self.board = np.copy(self.initial_board)
        self.lines_cleared = 0
        self.failed_attempts = 0
        self.stack = []

    # -- board mechanics ----------------------------------------------------

    def _fits(self, shape: np.ndarray, row: int, col: int) -> bool:
        h, w = shape.shape
        if row + h > self.height or col < 0 or col + w > self.width:
            return False
        return not np.any((shape == 1) & (self.board[row : row + h, col : col + w] == 1))

    def _depth(self, shape: np.ndarray, col: int) -> int:
        h, w = shape.shape
        row = 0
        while row + h <= self.height and not np.any(
            self.board[row : row + h, col : col + w] + shape > 1
        ):
            row += 1
        return row

    def _place(self, shape: np.ndarray, col: int) -> None:
        h, w = shape.shape
        row = self._depth(shape, col)
        self.board[row - 1 : row - 1 + h, col : col + w] += shape
        full = np.all(self.board, axis=1)
        n_full = int(full.sum())
        self.lines_cleared += n_full
        self.board = np.vstack(
            [np.zeros((n_full, self.width), dtype=self.board.dtype), self.board[~full]]
        )

    def _topped_out(self) -> bool:
        return bool(np.any(self.board[0] == 1))

    def _best_column(self, shape: np.ndarray) -> int:
        """Single deepest column; stable ties → leftmost
        (reference evaluate_columns + the [:1] at TetrisSolver.py:117)."""
        cols = list(range(self.width - shape.shape[1] + 1))
        cols.sort(key=lambda c: -self._depth(shape, c))
        return cols[0]

    # -- search -------------------------------------------------------------

    def solve(self):
        """Returns (solvable, move_stack, failed_attempts) — the reference
        ``solve`` contract (TetrisSolver.py:112-163)."""
        result = self._solve_frame(self.sequence.popleft())
        return result, self.stack, self.failed_attempts

    def _solve_frame(self, current: str) -> bool:
        rotations = GEN_SHAPES[current]
        for rotation, shape in enumerate(rotations):
            col = self._best_column(shape)
            if self.failed_attempts >= self.max_attempts:
                return False
            board_snapshot = np.copy(self.board)
            lines_snapshot = self.lines_cleared

            if self._fits(shape, 0, col):
                self._place(shape, col)
            else:
                self.failed_attempts += 1
                continue

            if self._topped_out():
                self.board = np.copy(board_snapshot)
                self.lines_cleared = lines_snapshot
                self.failed_attempts += 1
                continue
            elif self.lines_cleared >= self.goal:
                self.stack.append((current, rotation, col))
                return True
            elif self.sequence:
                self.stack.append((current, rotation, col))
                nxt = self.sequence.popleft()
                if self._solve_frame(nxt):
                    return True
                self.sequence.appendleft(nxt)
                self.stack.pop()
                self.lines_cleared = lines_snapshot
                self.board = np.copy(board_snapshot)
            else:
                self.board = np.copy(board_snapshot)
                self.lines_cleared = lines_snapshot
                self.failed_attempts += 1

            # Reference TetrisSolver.py:158: `len(current)` is the length of
            # the 1-char piece NAME, so this fires iff rotation == 0 and the
            # chosen column is the rightmost legal one for that rotation.
            if rotation == len(current) - 1 and col == self.width - shape.shape[1]:
                self.failed_attempts += 1
                self.board = np.copy(board_snapshot)
                self.lines_cleared = lines_snapshot

        return False

    def replay(self, stack) -> int:
        """Replay a solution stack from the initial board; returns the lines
        cleared (``visualize_moves`` without the printing)."""
        self.reset()
        for name, rotation, col in stack:
            self._place(GEN_SHAPES[name][rotation], col)
        return self.lines_cleared

    # -- display --------------------------------------------------------------

    def visualize(self, board=None) -> str:
        """Board as a printable grid (reference TetrisSolver.py:81-85)."""
        if board is None:
            board = self.board
        return "\n".join(
            " ".join(str(int(c)) for c in row) for row in board
        )

    def visualize_moves(self, stack, print_fn=print) -> int:
        """Replay a solution stack from the initial board, printing each
        placement and the board after it (reference TetrisSolver.py:165-172).
        Returns the lines cleared in all."""
        self.reset()
        for name, rotation, col in stack:
            before = self.lines_cleared
            self._place(GEN_SHAPES[name][rotation], col)
            print_fn(f"Tetromino: {name}  Rotation: {rotation}  Column: {col}")
            print_fn(f"Lines cleared: {self.lines_cleared - before}")
            print_fn(self.visualize())
        return self.lines_cleared
