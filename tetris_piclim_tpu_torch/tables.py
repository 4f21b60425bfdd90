"""Tetromino geometry tables (numpy), the port's own copy.

Engine-flavor piece ids I=0, L=1, J=2, T=3, S=4, Z=5, O=6 with the rotation
order of the reference game (game/tetris.py:23-57). Every mask is padded into
a 4x4 box anchored at the top-left. Per (piece, rotation):

* ``WIDTH`` / ``HEIGHT``: true extents,
* ``RTOPO``: per mask column, the row of its lowest filled cell (0 beyond
  the width),
* ``NROT``: rotations per piece; rotation indices wrap modulo this.

The host forward generator and its solver (``gen/forward.py``,
``gen/solver.py``) use the generator flavor instead: letter-keyed shapes
``GEN_SHAPES`` with the rotation order of the reference's generator
(TetrisGameGenerator.py:5-13), drawn in the order ``GEN_NAME_ORDER``;
``PIECE_IDS`` maps a letter to its engine id.

The values equal ``tetris_piclim_tpu.tables`` (tests/test_torch_bitboard.py,
tests/test_torch_holdout.py).
"""

from __future__ import annotations

import numpy as np

BOARD_H = 20
BOARD_W = 10
NUM_PIECES = 7
MAX_ROT = 4
MASK_BOX = 4

PIECE_NAMES = ("I", "L", "J", "T", "S", "Z", "O")
PIECE_IDS = {name: idx for idx, name in enumerate(PIECE_NAMES)}

_ART: dict[str, tuple[tuple[str, ...], ...]] = {
    "I": (("####",), ("#", "#", "#", "#")),
    "L": (
        ("..#", "###"),
        ("##", ".#", ".#"),
        ("###", "#.."),
        ("#.", "#.", "##"),
    ),
    "J": (
        ("#..", "###"),
        (".#", ".#", "##"),
        ("###", "..#"),
        ("##", "#.", "#."),
    ),
    "T": (
        (".#.", "###"),
        (".#", "##", ".#"),
        ("###", ".#."),
        ("#.", "##", "#."),
    ),
    "S": ((".##", "##."), ("#.", "##", ".#")),
    "Z": (("##.", ".##"), (".#", "##", "#.")),
    "O": (("##", "##"),),
}


def _build():
    masks = np.zeros((NUM_PIECES, MAX_ROT, MASK_BOX, MASK_BOX), dtype=bool)
    width = np.zeros((NUM_PIECES, MAX_ROT), dtype=np.int32)
    height = np.zeros((NUM_PIECES, MAX_ROT), dtype=np.int32)
    rtopo = np.zeros((NUM_PIECES, MAX_ROT, MASK_BOX), dtype=np.int32)
    nrot = np.zeros((NUM_PIECES,), dtype=np.int32)
    for pid, name in enumerate(PIECE_NAMES):
        rots = [
            np.array([[ch == "#" for ch in row] for row in art], dtype=bool)
            for art in _ART[name]
        ]
        nrot[pid] = len(rots)
        for r in range(MAX_ROT):
            m = rots[r % len(rots)]
            h, w = m.shape
            masks[pid, r, :h, :w] = m
            width[pid, r] = w
            height[pid, r] = h
            rtopo[pid, r, :w] = h - 1 - np.argmax(m[::-1], axis=0)
    return masks, width, height, rtopo, nrot


MASKS, WIDTH, HEIGHT, RTOPO, NROT = _build()


def get_tetromino(piece: int, rotations: int) -> tuple[np.ndarray, tuple[int, ...]]:
    """The unpadded bool mask of ``piece`` at ``rotations`` (modulo its
    rotation count) and its reverse topography, as the reference's lookup
    (game/tetris.py:60-61); the host carver and ``env_api`` use it."""
    r = rotations % int(NROT[piece])
    h, w = int(HEIGHT[piece, r]), int(WIDTH[piece, r])
    return MASKS[piece, r, :h, :w], tuple(int(x) for x in RTOPO[piece, r, :w])


# Generator flavor (reference TetrisGameGenerator.py:5-13): the rotation
# ORDER differs from the engine's, so seeded ``randint(0, nrot - 1)`` draws
# map to the reference's shapes.
_GEN_ART: dict[str, tuple[tuple[str, ...], ...]] = {
    "I": (("####",), ("#", "#", "#", "#")),
    "J": (
        ("#..", "###"),
        ("##", "#.", "#."),
        ("###", "..#"),
        (".#", ".#", "##"),
    ),
    "L": (
        ("..#", "###"),
        ("#.", "#.", "##"),
        ("###", "#.."),
        ("##", ".#", ".#"),
    ),
    "O": (("##", "##"),),
    "S": ((".##", "##."), ("#.", "##", ".#")),
    "T": (
        (".#.", "###"),
        ("#.", "##", "#."),
        ("###", ".#."),
        (".#", "##", ".#"),
    ),
    "Z": (("##.", ".##"), (".#", "##", "#.")),
}

# piece-name order of the forward generator's ``random.choice``
# (reference TetrisGameGenerator.py:22)
GEN_NAME_ORDER = ("I", "J", "L", "O", "S", "T", "Z")

GEN_SHAPES: dict[str, list[np.ndarray]] = {
    name: [
        np.array([[ch == "#" for ch in row] for row in art], dtype=np.int64)
        for art in arts
    ]
    for name, arts in _GEN_ART.items()
}
