"""Reverse "carving" generator of winnable initial configurations (host).

A seed-exact copy of ``tetris_piclim_tpu/gen/carver.py`` (pure Python
``random`` and numpy): the same ``random.Random(seed)`` gives the same
board, pieces and recorded solution word for word. The construction is the
reference's in-env carver (game/tetris.py:226-352, helpers at :64-137):
fill the bottom L rows solid, then carve tetromino-shaped holes such that
replaying the carved pieces forward, each as a hard drop, lands every piece
in its hole and clears >= L lines. A carve is accepted only if a fresh
forward drop after it lands exactly where the hole was (game/tetris.py:
341-349), which makes the configuration forward-playable.

The calls into ``rng`` are the reference's, in its order. The default bank
(``ConfigBank.fill``), its refresh producers and ``env_api.Tetris`` use it;
the device carver (:mod:`.device_carver`) is the lockstep version.
"""

from __future__ import annotations

import random as _random_module

import numpy as np

from ..tables import BOARD_H, BOARD_W, get_tetromino
from .bag import SevenBag


class _Backtracker:
    """Bounded-retry checkpoint stack of the reference ``CheckpointManager``
    (game/tetris.py:111-137): a carve site fails after 40 attempts; a
    checkpoint is discarded after 10 reuses, but never the last one."""

    MAX_ATTEMPTS = 40
    MAX_USES = 10

    def __init__(self) -> None:
        self.checkpoints: list = []
        self.attempts = 0
        self.uses = 0

    def note_failure(self) -> bool:
        self.attempts += 1
        return self.attempts > self.MAX_ATTEMPTS

    def push(self, cp) -> None:
        self.checkpoints.append(cp)

    def pop_latest(self):
        self.attempts = 0
        if len(self.checkpoints) > 1 and self.uses > self.MAX_USES:
            del self.checkpoints[-1]
            self.uses = 0
        else:
            self.uses += 1
        return self.checkpoints[-1]


class CarvingGenerator:
    """One-shot generator: ``generate()`` returns (board, pieces) and, with
    ``record_solution``, the (rotations, location) moves whose replay wins.

    ``rng`` defaults to the global ``random`` module, as the reference uses
    it; pass ``random.Random(seed)`` for a stream of its own. ``render_fn``
    is called with the board after each accepted carve (the reference
    renders its carve loop, game/tetris.py:264-265)."""

    def __init__(self, L: int, M: int, rng=None, record_solution: bool = False,
                 render_fn=None):
        self.L = L
        self.M = M
        self.rng = rng if rng is not None else _random_module
        self.record_solution = record_solution
        self.render_fn = render_fn

    @staticmethod
    def _drop_deltas(board, location, rtopo, width):
        topo = []
        for col in board.T[location : location + width, :]:
            nz = np.where(col)[0]
            topo.append(nz[0] if len(nz) else BOARD_H)
        return np.array(topo) - np.array(rtopo)

    def _try_carve(self, board, piece, rotations, location, allow_partial) -> bool:
        mask, rtopo = get_tetromino(piece, rotations)
        h, w = mask.shape
        deltas = self._drop_deltas(board, location, rtopo, w)
        drop = int(np.min(deltas)) - 1
        # push the piece fully under the surface (game/tetris.py:298-301)
        drop += int(rtopo[int(np.argmin(deltas))]) + 1
        for _ in range(h if allow_partial else 1):
            if self._apply_carve(board, drop, location, mask, rtopo, allow_partial):
                return True
            drop -= 1
        return False

    def _apply_carve(self, board, drop, location, mask, rtopo, allow_partial) -> bool:
        h, w = mask.shape
        if drop + h > BOARD_H:
            return False
        window = board[drop : drop + h, location : location + w]
        # after the first carve every mask cell must be filled (full
        # overlap, game/tetris.py:321-329)
        if not allow_partial and not np.all(~mask | window):
            return False
        saved = window.copy()
        window &= ~mask
        # the carve must be where a fresh forward drop lands (:341-349)
        new_drop = int(np.min(self._drop_deltas(board, location, rtopo, w))) - 1
        if new_drop != drop:
            board[drop : drop + h, location : location + w] = saved
            return False
        return True

    def generate(self):
        """(board bool[20, 10], pieces list[int] of length M+1) and, with
        ``record_solution``, the (rotations, location) list whose forward
        replay wins (reference ``_generate_initial_config``,
        game/tetris.py:226-284)."""
        rng = self.rng
        board = np.zeros((BOARD_H, BOARD_W), dtype=bool)
        board[-self.L :, :] = True
        pieces: list[int] = []
        solution: list[tuple[int, int]] = []
        bag = SevenBag(rng)
        backtracker = _Backtracker()

        # carve until the bottom row has <= 8 filled cells, so the game does
        # not start won (game/tetris.py:234)
        while np.count_nonzero(board[-1]) > 8:
            piece, bag_idx, refilled = bag.draw()
            if refilled:
                cp_pieces = ((list(pieces), list(solution))
                             if self.record_solution else list(pieces))
                backtracker.push((np.copy(board), cp_pieces))

            rotations = rng.randint(0, 3)
            width = get_tetromino(piece, rotations)[0].shape[1]
            location = rng.randint(0, BOARD_W - width)

            if len(pieces) < self.M and self._try_carve(
                board, piece, rotations, location, allow_partial=not pieces
            ):
                pieces.insert(0, piece)
                if self.record_solution:
                    solution.insert(0, (rotations, location))
                bag.remove(bag_idx)
                if self.render_fn is not None:
                    self.render_fn(board)
            elif len(pieces) >= self.M or backtracker.note_failure():
                cp_board, cp_pieces = backtracker.pop_latest()
                if self.record_solution:
                    solution = list(cp_pieces[1])
                    cp_pieces = list(cp_pieces[0])
                board = np.copy(cp_board)
                pieces = list(cp_pieces)
                bag.refill()

        # pad the piece list to M+1 with random 7-bags (game/tetris.py:281-284)
        if len(pieces) <= self.M:
            pieces = pieces + bag.sequence(self.M - len(pieces) + 1)

        if self.record_solution:
            return board, pieces, solution
        return board, pieces
