"""Packed-bitboard Tetris-piclim step in plain PyTorch.

Counterpart of ``tetris_piclim_tpu/ops/bitboard.py``. The 20x10 board is 10
**int32** column bitmasks (bit r set = cell (r, c) filled; bit 0 = top row).
Boards use 20 bits, so every value stays non-negative in int32 and the
arithmetic agrees word for word with the JAX package's uint32 version.

This module is the contract the CUDA kernels (:mod:`.rollout`,
:mod:`.actor`) are held against, and the plain path the trainer runs on the
CPU. Every random draw is an input (``reset_idx``), so tests can feed the
JAX function and this one the same numbers.

Differences from the JAX step, each deliberate:

* torch has no popcount; ``_ctz20`` and ``_popcount`` are exact integer
  bit tricks for 20-bit words;
* the current piece is read at ``min(cursor, P-1)``: the JAX gather fills
  an out-of-range read (only a step after the last piece of a finished,
  un-reset episode) with -128, and a CUDA gather out of range is a fault.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import tables
from ..engine import LOSS, RUNNING, WIN, StepResult, per_env, state_where

H, W = tables.BOARD_H, tables.BOARD_W
_NEG_BIG = -(1 << 20)


def _build_aligned_tables():
    """COLMASK10[p, r, loc, j]: column mask of piece p / rotation r placed at
    column loc, for board column j (0 outside the piece). RTOPO10 the same,
    with -BIG outside the piece so ``topo - rtopo`` never wins the min.
    Flattened to [7*4*10, 10] for one gather per env."""
    colmask = np.zeros((7, 4, 10, 10), dtype=np.int32)
    rtopo10 = np.full((7, 4, 10, 10), _NEG_BIG, dtype=np.int32)
    cm4 = np.zeros((7, 4, 4), dtype=np.int32)
    for p in range(7):
        for r in range(4):
            w = int(tables.WIDTH[p, r])
            for c in range(w):
                cm4[p, r, c] = sum(
                    1 << row for row in range(4) if tables.MASKS[p, r, row, c]
                )
            for loc in range(10):
                for c in range(w):
                    if loc + c < 10:
                        colmask[p, r, loc, loc + c] = cm4[p, r, c]
                        rtopo10[p, r, loc, loc + c] = tables.RTOPO[p, r, c]
    return colmask.reshape(280, 10), rtopo10.reshape(280, 10), cm4


COLMASK10, RTOPO10, COLMASK4 = _build_aligned_tables()


class _Tables(NamedTuple):
    colmask10: torch.Tensor  # int32[280, 10]
    rtopo10: torch.Tensor    # int32[280, 10]
    width: torch.Tensor      # int64[7, 4]
    height: torch.Tensor     # int64[7, 4]
    nrot: torch.Tensor       # int64[7]


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device) -> _Tables:
    """The step's constant tables on ``device`` (built once per device)."""
    return _Tables(
        colmask10=torch.as_tensor(COLMASK10, device=device),
        rtopo10=torch.as_tensor(RTOPO10, device=device),
        width=torch.as_tensor(tables.WIDTH, dtype=torch.int64, device=device),
        height=torch.as_tensor(tables.HEIGHT, dtype=torch.int64, device=device),
        nrot=torch.as_tensor(tables.NROT, dtype=torch.int64, device=device),
    )


@functools.lru_cache(maxsize=None)
def kernel_tables(device: torch.device) -> torch.Tensor:
    """int32[28 * 2] for the CUDA kernels' shared memory: one word pair per
    ``piece * 4 + q`` (q = rot & 3) describing rotation ``q mod nrot[piece]``,
    so the kernels index with ``rot & 3`` and never divide (nrot is 1, 2 or
    4). Word 0: the 4-row cell mask of piece column c in bits 4c..4c+3 (0
    beyond the width) and its rtopo in bits 16+4c..16+4c+3. Word 1: the
    width in bits 0..2 and the row span ``(1 << height) - 1`` in bits 4..7."""
    t = np.zeros((28, 2), np.int64)
    for p in range(7):
        for q in range(4):
            r = q % int(tables.NROT[p])
            w, h = int(tables.WIDTH[p, r]), int(tables.HEIGHT[p, r])
            for c in range(w):
                t[p * 4 + q, 0] |= int(COLMASK4[p, r, c]) << (4 * c)
                t[p * 4 + q, 0] |= int(tables.RTOPO[p, r, c]) << (16 + 4 * c)
            t[p * 4 + q, 1] = w | (((1 << h) - 1) << 4)
    assert t.max() < 2 ** 31 and COLMASK4.max() < 16 and tables.RTOPO.max() < 16
    return torch.as_tensor(t.reshape(-1).astype(np.int32), device=device)


class PackedState(NamedTuple):
    """Batch-first packed env state; every field has leading axis N."""

    cols: torch.Tensor           # int32[N, 10] column bitmasks
    pieces: torch.Tensor         # int8[N, P]
    cursor: torch.Tensor         # int32[N]
    lines_cleared: torch.Tensor  # int32[N]
    moves_used: torch.Tensor     # int32[N]
    lines_goal: torch.Tensor     # int32[N]
    move_limit: torch.Tensor     # int32[N]
    status: torch.Tensor         # int8[N]


# -- packing -----------------------------------------------------------------

def pack_board(board: torch.Tensor) -> torch.Tensor:
    """bool[..., 20, 10] -> int32[..., 10]."""
    weights = (1 << torch.arange(H, dtype=torch.int32, device=board.device))
    return (board.to(torch.int32) * weights[:, None]).sum(dim=-2, dtype=torch.int32)


def unpack_board(cols: torch.Tensor) -> torch.Tensor:
    """int32[..., 10] -> bool[..., 20, 10]."""
    shifts = torch.arange(H, dtype=torch.int32, device=cols.device)[:, None]
    return ((cols.unsqueeze(-2) >> shifts) & 1).bool()


def from_env_state(env_state) -> PackedState:
    """An array-engine ``engine.EnvState`` batch as a PackedState (the
    replay stores packed states whatever the trainer's backend)."""
    return PackedState(pack_board(env_state.board), *env_state[1:])


def make_state_batch(boards, pieces, lines_goal, move_limit) -> PackedState:
    """Fresh states from boards (int32[N, 10] packed or bool[N, 20, 10]);
    ``lines_goal`` and ``move_limit`` are scalars or per-env [N] arrays."""
    boards = torch.as_tensor(boards)
    cols = boards if boards.dtype == torch.int32 else pack_board(boards.bool())
    n, dev = cols.shape[0], cols.device
    z = torch.zeros((n,), dtype=torch.int32, device=dev)
    return PackedState(
        cols=cols.contiguous(),
        pieces=torch.as_tensor(pieces, device=dev).to(torch.int8).contiguous(),
        cursor=z,
        lines_cleared=z.clone(),
        moves_used=z.clone(),
        lines_goal=per_env(lines_goal, n, dev),
        move_limit=per_env(move_limit, n, dev),
        status=torch.zeros((n,), dtype=torch.int8, device=dev),
    )


# -- bit helpers -------------------------------------------------------------

# _BIT_OF[k]: the 20-bit word whose bit i is set iff bit k of i is set
_BIT_OF = [sum(1 << i for i in range(H) if (i >> k) & 1) for k in range(5)]


def _ctz20(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of a 20-bit word, 20 when it is 0 (the
    packed 'first filled row from the top'). Exact: the isolated low bit's
    index is read off bit by bit, with no float on the way."""
    lsb = x & -x
    idx = torch.zeros_like(x)
    for k, m in enumerate(_BIT_OF):
        idx = idx | (((lsb & m) != 0).to(x.dtype) << k)
    return torch.where(x == 0, torch.full_like(x, H), idx)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 words (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0x7FFFFFFF) >> 24


def current_piece(state: PackedState, offset: int = 0) -> torch.Tensor:
    """int64[N]: the piece at ``cursor + offset`` (clipped into the
    sequence)."""
    p = state.pieces.shape[1]
    at = (state.cursor.long() + offset).clamp(0, p - 1)
    return state.pieces.gather(1, at[:, None])[:, 0].long()


def packed_fields(state: PackedState):
    """The packed observation fields (cols, cur, nxt, lines-left,
    moves-left, status) that replay records store, cur/nxt as int32."""
    return (
        state.cols,
        current_piece(state).to(torch.int32),
        current_piece(state, 1).to(torch.int32),
        state.lines_goal - state.lines_cleared,
        state.move_limit - state.moves_used,
        state.status,
    )


# -- the step ----------------------------------------------------------------

def step(state: PackedState, rotations: torch.Tensor,
         locations: torch.Tensor) -> StepResult:
    """Batched hard-drop step on packed boards; the semantics of the JAX
    ``bitboard.step`` (reference game/tetris.py:354-433)."""
    t = device_tables(state.cols.device)
    piece = current_piece(state)
    r = torch.remainder(rotations.long(), t.nrot[piece])
    w = t.width[piece, r]
    h = t.height[piece, r]
    loc = torch.minimum(torch.clamp(locations.long(), min=0), W - w)

    flat = (piece * 4 + r) * 10 + loc
    aligned_mask = t.colmask10[flat]
    aligned_rtopo = t.rtopo10[flat]

    topo = _ctz20(state.cols)
    drop = (topo - aligned_rtopo).min(dim=1).values - 1
    topout = drop < 0

    drop_c = drop.clamp(min=0)
    locked = state.cols | (aligned_mask << drop_c[:, None])

    # full rows within the piece span
    full = locked[:, 0]
    for c in range(1, W):
        full = full & locked[:, c]
    span = ((1 << h.to(torch.int32)) - 1) << drop_c
    cm = full & span
    k = _popcount(cm)

    # delete-and-shift each cleared row, topmost first (4 static rounds)
    board = locked
    cmw = cm
    for _ in range(4):
        active = cmw != 0
        lsb = cmw & -cmw
        low = lsb - 1
        keep_hi = ~((lsb << 1) - 1)
        newb = ((board & low[:, None]) << 1) | (board & keep_hi[:, None])
        board = torch.where(active[:, None], newb, board)
        cmw = cmw & (cmw - 1)

    moves_used = state.moves_used + 1
    lines = state.lines_cleared + k
    prev = state.status.to(torch.int32)
    over = moves_used >= state.move_limit
    status_noclear = torch.where(over, LOSS, prev)
    status_clear = torch.where(lines >= state.lines_goal, WIN, status_noclear)
    status = torch.where(
        topout, LOSS, torch.where(k > 0, status_clear, status_noclear)
    ).to(torch.int8)

    new_state = PackedState(
        cols=torch.where(topout[:, None], state.cols, board),
        pieces=state.pieces,
        cursor=state.cursor + 1,
        lines_cleared=torch.where(topout, state.lines_cleared, lines),
        moves_used=torch.where(topout, state.moves_used, moves_used),
        lines_goal=state.lines_goal,
        move_limit=state.move_limit,
        status=status,
    )
    lines_delta = torch.where(topout, torch.zeros_like(k), k)
    done = status != RUNNING
    return StepResult(new_state, lines_delta, done, status == WIN)


def obs_from_fields(cols, cur, nxt, lines_left, moves_left, status) -> torch.Tensor:
    """float32[N, 217] observation from the packed fields: 200 board cells
    (row-major), one-hot current and next piece, lines-left, moves-left,
    status (+1 win, -1 loss)."""
    n = cols.shape[0]
    eye = torch.eye(tables.NUM_PIECES, device=cols.device)
    status_f = torch.where(
        status == WIN, 1.0, torch.where(status == LOSS, -1.0, 0.0)
    )
    return torch.cat(
        [
            unpack_board(cols).reshape(n, H * W).float(),
            eye[cur.long()],
            eye[nxt.long()],
            torch.stack([lines_left.float(), moves_left.float(), status_f], dim=1),
        ],
        dim=1,
    )


def observe(state: PackedState) -> torch.Tensor:
    """float32[N, 217] observation of ``state`` (see :func:`obs_from_fields`)."""
    return obs_from_fields(*packed_fields(state))


# the JAX module's batch names; this module is batch first by construction
step_batch = step
observe_batch = observe


def to_board(state: PackedState) -> torch.Tensor:
    """bool[N, 20, 10] boards of ``state``."""
    return unpack_board(state.cols)


def reset_from_bank(state: PackedState, bank_cols: torch.Tensor,
                    bank_pieces: torch.Tensor,
                    reset_idx: torch.Tensor) -> PackedState:
    """Fresh states from bank rows ``reset_idx`` (goal and limit kept)."""
    idx = reset_idx.long()
    z = torch.zeros_like(state.cursor)
    return PackedState(
        cols=bank_cols[idx],
        pieces=bank_pieces[idx],
        cursor=z,
        lines_cleared=z,
        moves_used=z,
        lines_goal=state.lines_goal,
        move_limit=state.move_limit,
        status=torch.zeros_like(state.status),
    )


def step_autoreset_batch(
    states: PackedState,
    rotations: torch.Tensor,
    locations: torch.Tensor,
    bank_cols: torch.Tensor,     # int32[B, 10]
    bank_pieces: torch.Tensor,   # int8[B, P]
    reset_idx: torch.Tensor,     # int[N] bank rows for envs that finish
) -> tuple[PackedState, StepResult]:
    """Step; terminal envs are swapped for bank rows ``reset_idx``."""
    res = step(states, rotations, locations)
    fresh = reset_from_bank(states, bank_cols, bank_pieces, reset_idx)
    return state_where(res.done, fresh, res.state), res
