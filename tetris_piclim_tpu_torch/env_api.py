"""The single-env API, a drop-in for the reference ``Tetris`` class.

Counterpart of ``tetris_piclim_tpu/env_api.py`` (reference game/tetris.py:
140-470): the same constructor ``Tetris(L, M, warm_reset=True, render=False,
framerate=30, debug=False)``, the methods ``move(rotations, location)``,
``get_state()``, ``reset()``, ``terminate()``, and the ``board`` /
``pieces`` / ``lines_cleared`` / ``moves_used`` / ``state`` attributes. One
interactive move is a handful of numpy operations on the host
(:func:`host_move`): a device round trip per move would cost more than the
move. The batched device engines stay the training path. The module loads
numpy and the standard library only, as its producer processes do.

Differences from the reference, each restorable with ``parity=True`` (the
JAX package's policy):

* ``reset()`` zeroes ``lines_cleared`` / ``moves_used`` / ``state``; the
  reference forgets to (game/tetris.py:438-443);
* ``get_state()`` at a terminal state clamps the next-piece index instead of
  raising IndexError (game/tetris.py:435-436);
* the forward producer rotates its seed windows and appends the extra
  piece (the reference pins seeds 0..99 and prepends it).

Warm reset keeps the reference's two producer processes (game/tetris.py:
190-214), one carving and one forward generate-and-prove, spawned. Each
sends configurations down a pipe of its own (bounded by the pipe's buffer)
and watches a lock-free stop flag, so a producer that dies, however it dies,
blocks nothing: its pipe reads as end-of-file and is discarded, and the
producer is restarted with a fresh pipe, at most 5 times. ``reset()``
therefore never hangs: it returns a configuration, or raises once the
restarts are spent and no producer is left. Rendering is ASCII unless
``render="pygame"`` and pygame imports (the display falls back to ASCII);
as in the reference (game/tetris.py:181-182), rendering turns warm reset
off.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from .gen._producers import MAX_RESTARTS, ProducerPool, _put
from .gen.carver import CarvingGenerator
from .tables import BOARD_H, BOARD_W, NROT, get_tetromino

# per (piece, rotation): the unpadded mask and its int rtopo, built once
_HOST_TET = [
    [(get_tetromino(p, r)[0], np.asarray(get_tetromino(p, r)[1], dtype=np.int64))
     for r in range(int(NROT[p]))]
    for p in range(7)
]


def host_move(board, piece, rotations, location):
    """One hard drop on a numpy board with the reference ``move`` semantics
    (game/tetris.py:354-433), without the state bookkeeping. Returns
    (topout, lines cleared, drop); mutates ``board`` unless it tops out."""
    rots = _HOST_TET[piece]
    mask, rtopo = rots[rotations % len(rots)]
    h, w = mask.shape
    location = max(0, min(location, BOARD_W - w))
    window = board[:, location : location + w]
    topo = np.where(window.any(axis=0), window.argmax(axis=0), BOARD_H)
    drop = int((topo - rtopo).min()) - 1
    if drop < 0:
        return True, 0, drop
    board[drop : drop + h, location : location + w] |= mask
    full = board[drop : drop + h].all(axis=1)
    k = int(full.sum())
    if k:
        keep = np.ones(BOARD_H, dtype=bool)
        keep[drop : drop + h][full] = False
        board[k:] = board[keep]
        board[:k] = False
    return False, k, drop


def _carve_producer(conn, stop, L, M) -> None:
    """Carving producer (reference warm_reset_worker, game/tetris.py:473-479)."""
    rng = random.Random()
    while not stop.is_set():
        if not _put(conn, stop, CarvingGenerator(L, M, rng=rng).generate()):
            return


def _forward_producer(conn, stop, L, M, parity) -> None:
    """Forward generate-and-prove producer (reference
    forward_warm_reset_worker, game/tetris.py:482-488). Parity mode pins the
    seed window to 0..99 and prepends the random piece, as the reference."""
    from .gen.pipeline import generate_batch, translate_batch

    rng = random.Random()
    seed = 0
    while not stop.is_set():
        games = generate_batch(L, M, seed_start=seed, seed_end=seed + 100)
        if not parity:
            seed += 100
        for item in translate_batch(games, M, rng=rng, parity=parity):
            if not _put(conn, stop, item):
                return


class Tetris:
    def __init__(self, L: int, M: int, warm_reset: bool = True, render=False,
                 framerate: int = 30, debug: bool = False, parity: bool = False,
                 seed: Optional[int] = None) -> None:
        self.L = L
        self.M = M
        self.warm_reset = warm_reset
        self.render = bool(render)
        self.framerate = framerate
        self.debug = debug
        self.parity = parity
        self._rng = random.Random(seed) if seed is not None else random
        if debug:
            self.solution: list[tuple[int, int]] = []

        self.lines_cleared = 0
        self.moves_used = 0
        self.state = None

        self._pygame = None
        if self.render:
            self.warm_reset = False  # reference game/tetris.py:181-182
            if render == "pygame":
                self._init_pygame()

        self._pool = None
        if self.warm_reset:
            self._pool = ProducerPool([(_carve_producer, (L, M)),
                                       (_forward_producer, (L, M, parity))])

        self._board = np.zeros((BOARD_H, BOARD_W), dtype=bool)
        self.load_warm_reset()

    def _next_config(self):
        """One configuration from whichever producer has one ready; dead
        producers are restarted while restarts remain."""
        while True:
            for item in self._pool.receive(2.0):
                return item
            # starved: producers may have died
            self._pool.restart_dead()
            if self._pool.restarts >= MAX_RESTARTS and not self._pool.any_alive():
                raise RuntimeError(
                    f"warm-reset producers died {self._pool.restarts} restarts "
                    "ago and no configuration is left; failing fast instead of "
                    "blocking reset() forever (game/tetris.py:447)")

    def load_warm_reset(self) -> None:
        if self.warm_reset:
            board, pieces = self._next_config()
        else:
            # render each accepted carve, as the reference's carve loop
            # (game/tetris.py:264-265)
            render_fn = self.render_frame if self.render else None
            if self.debug:
                board, pieces, self.solution = CarvingGenerator(
                    self.L, self.M, rng=self._rng, record_solution=True,
                    render_fn=render_fn).generate()
            else:
                board, pieces = CarvingGenerator(
                    self.L, self.M, rng=self._rng, render_fn=render_fn).generate()
        self._pieces_full = list(pieces)
        self._board = np.array(board, dtype=bool)
        self._cursor = 0
        if not self.parity:
            # the reference's reset() forgets these (game/tetris.py:438-443)
            self.lines_cleared = 0
            self.moves_used = 0
            self.state = None

    # -- the reference API ------------------------------------------------------

    @property
    def board(self) -> np.ndarray:
        return self._board

    @property
    def pieces(self) -> list[int]:
        return [int(p) for p in self._pieces_full[self._cursor:]]

    def move(self, rotations: int, location: int) -> None:
        """The reference ``move`` (game/tetris.py:354-422), on the host."""
        piece = int(self._pieces_full[self._cursor])
        self._cursor += 1  # consumed before any check (tetris.py:356)
        topout, k, _ = host_move(self._board, piece, rotations, location)
        if topout:
            self.state = False
        else:
            self.moves_used += 1
            if k == 0:
                if self.moves_used >= self.M:
                    self.state = False
            else:
                self.lines_cleared += k
                if self.lines_cleared >= self.L:
                    self.state = True
                elif self.moves_used >= self.M:
                    self.state = False
        if self.render:
            self.render_frame(self.board)

    def get_state(self):
        """(board, current piece, next piece, lines left, moves left, state),
        reference game/tetris.py:435-436."""
        remaining = self.pieces
        if self.parity:
            cur, nxt = remaining[0], remaining[1]  # IndexError at the end
        else:
            cur = remaining[0] if remaining else 0
            nxt = remaining[1] if len(remaining) > 1 else cur
        return (self.board, cur, nxt, self.L - self.lines_cleared,
                self.M - self.moves_used, self.state)

    def reset(self) -> None:
        self.load_warm_reset()

    def terminate(self) -> None:
        """Stop the producers (drain, join, terminate what still runs)."""
        if self._pool is not None:
            self._pool.close()
        if self._pygame is not None:
            self._pygame.quit()

    # -- rendering --------------------------------------------------------------

    def _init_pygame(self) -> None:
        try:
            import pygame
        except ImportError:
            return  # ASCII
        self._pygame = pygame
        self._cell = 40
        pygame.init()
        self._screen = pygame.display.set_mode((400, 800))
        pygame.display.set_caption("Tetris-piclim")
        self._clock = pygame.time.Clock()

    def render_frame(self, board: np.ndarray) -> None:
        if self._pygame is not None:
            pg = self._pygame
            for y in range(board.shape[0]):
                for x in range(board.shape[1]):
                    color = (99, 64, 247) if board[y, x] else (255, 255, 255)
                    pg.draw.rect(self._screen, color,
                                 (x * self._cell, y * self._cell, self._cell, self._cell))
            pg.display.flip()
            self._clock.tick(self.framerate)
        else:
            print("\n".join("".join("#" if c else "." for c in row) for row in board))
            print("-" * board.shape[1])

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
