"""Tetromino geometry tables (numpy), the port's own copy.

Engine-flavor piece ids I=0, L=1, J=2, T=3, S=4, Z=5, O=6 with the rotation
order of the reference game (game/tetris.py:23-57). Every mask is padded into
a 4x4 box anchored at the top-left. Per (piece, rotation):

* ``WIDTH`` / ``HEIGHT``: true extents,
* ``RTOPO``: per mask column, the row of its lowest filled cell (0 beyond
  the width),
* ``NROT``: rotations per piece; rotation indices wrap modulo this.

The values equal ``tetris_piclim_tpu.tables`` (tests/test_torch_bitboard.py).
"""

from __future__ import annotations

import numpy as np

BOARD_H = 20
BOARD_W = 10
NUM_PIECES = 7
MAX_ROT = 4
MASK_BOX = 4

PIECE_NAMES = ("I", "L", "J", "T", "S", "Z", "O")

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
