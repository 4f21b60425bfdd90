"""The readable array engine, and the constants every layer of the port shares.

Counterpart of ``tetris_piclim_tpu/engine.py``: the reference's stateful
``Tetris.move`` (game/tetris.py:354-433) as a fixed-shape step on a batch of
:class:`EnvState` (bool[N, 20, 10] boards), with no data-dependent control
flow: every branch is computed and selected with ``torch.where``, and the
line clear is a stable argsort-gather. The packed bitboard step
(:mod:`.ops.bitboard`) is the production path; this engine is the trainer's
``backend="array"`` and the parity reference the bitboard is held against.

The JAX engine is single-env and vmapped; here every function is batch
first, and a single env is a batch of one. Quirks kept from the reference
(tests hold them against the JAX engine): the current piece is consumed
before any check; a top-out loses without counting the move or touching the
board; only rows the locked piece spans are checked for full lines; win is
checked before the move-limit loss; a step on a terminal state behaves as
the reference's unguarded ``move``. Locations are clamped to [0, 10 - w]
and the cursor to the sequence (a JAX gather clamps the same way). Every
random draw is an input (``reset_idx``), as in :mod:`.ops.bitboard`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import tables

RUNNING = 0
WIN = 1
LOSS = 2

OBS_DIM = 217  # 200 board + 7 cur + 7 nxt + lines-left + moves-left + status
_BIG = 1 << 20

H, W = tables.BOARD_H, tables.BOARD_W


class StepResult(NamedTuple):
    state: tuple              # the post-step state (no reset)
    lines_delta: torch.Tensor  # int32[N] lines cleared by this step
    done: torch.Tensor        # bool[N] terminal after this step
    won: torch.Tensor         # bool[N]


class EnvState(NamedTuple):
    """Batch-first env state; every field has leading axis N."""

    board: torch.Tensor          # bool[N, 20, 10]
    pieces: torch.Tensor         # int8[N, P], P >= M+1
    cursor: torch.Tensor         # int32[N]
    lines_cleared: torch.Tensor  # int32[N]
    moves_used: torch.Tensor     # int32[N]
    lines_goal: torch.Tensor     # int32[N] (L)
    move_limit: torch.Tensor     # int32[N] (M)
    status: torch.Tensor         # int8[N]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(masks bool[7, 4, 16], width, height, rtopo int64[7, 4, 4], nrot) on
    ``device``."""
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return (t(tables.MASKS.reshape(7, 4, 16), torch.bool),
            t(tables.WIDTH, torch.int64), t(tables.HEIGHT, torch.int64),
            t(tables.RTOPO, torch.int64), t(tables.NROT, torch.int64))


def per_env(x, n: int, device: torch.device) -> torch.Tensor:
    """int32[n] on ``device`` from a scalar or an [n] array (a Python int,
    numpy or a tensor), broadcast as ``jnp.broadcast_to`` does."""
    x = torch.as_tensor(x).to(device=device, dtype=torch.int32)
    return x.broadcast_to((n,)).clone()


def make_state_batch(boards, pieces, lines_goal, move_limit) -> EnvState:
    """Fresh states from boards bool[N, 20, 10] and pieces [N, P] (copied);
    ``lines_goal`` and ``move_limit`` are scalars or per-env [N] arrays."""
    boards = torch.as_tensor(boards).to(torch.bool).clone()
    n, dev = boards.shape[0], boards.device
    z = torch.zeros((n,), dtype=torch.int32, device=dev)
    return EnvState(
        board=boards,
        pieces=torch.as_tensor(pieces, device=dev).to(torch.int8).clone(),
        cursor=z,
        lines_cleared=z.clone(),
        moves_used=z.clone(),
        lines_goal=per_env(lines_goal, n, dev),
        move_limit=per_env(move_limit, n, dev),
        status=torch.zeros((n,), dtype=torch.int8, device=dev),
    )


def make_state(board, pieces, lines_goal, move_limit) -> EnvState:
    """One env (board bool[20, 10], pieces [P]) as a batch of one."""
    return make_state_batch(torch.as_tensor(board)[None],
                            torch.as_tensor(pieces)[None], lines_goal, move_limit)


def state_where(mask: torch.Tensor, a, b):
    """Field-wise ``where(mask, a, b)`` of two batch-first states of one
    NamedTuple type (``EnvState`` or ``ops.bitboard.PackedState``), with
    ``mask`` bool[N]."""
    return type(a)(*[
        torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)
    ])


def _piece_at(state: EnvState, offset: int = 0) -> torch.Tensor:
    at = (state.cursor.long() + offset).clamp(0, state.pieces.shape[1] - 1)
    return state.pieces.gather(1, at[:, None])[:, 0].long()


def step(state: EnvState, rotations: torch.Tensor,
         location: torch.Tensor) -> StepResult:
    """One hard-drop move per env (reference game/tetris.py:354-433)."""
    n, dev = state.board.shape[0], state.board.device
    masks, width, height, rtopo_t, nrot = _tables(dev)
    piece = _piece_at(state)
    r = torch.remainder(rotations.long(), nrot[piece])
    mask = masks[piece, r]                     # [N, 16] 4x4, top-left anchored
    w, h = width[piece, r], height[piece, r]
    loc = torch.minimum(location.long().clamp(min=0), W - w)

    # first filled row of each of the 4 box columns, 20 when empty
    box = torch.arange(4, device=dev)
    cols = (loc[:, None] + box).clamp(0, W - 1)                 # [N, 4]
    cells = state.board.gather(2, cols[:, None, :].expand(n, H, 4))
    rows = torch.arange(H, device=dev)[None, :]
    topo = torch.where(cells, rows[:, :, None], H).min(dim=1).values
    deltas = torch.where(box < w[:, None], topo - rtopo_t[piece, r], _BIG)
    drop = deltas.min(dim=1).values - 1
    topout = drop < 0

    # lock: the 4x4 mask placed at (drop, loc)
    rel_r = torch.arange(H, device=dev)[None, :, None] - drop[:, None, None]
    rel_c = torch.arange(W, device=dev)[None, None, :] - loc[:, None, None]
    in_box = (rel_r >= 0) & (rel_r < 4) & (rel_c >= 0) & (rel_c < 4)
    cell = (rel_r.clamp(0, 3) * 4 + rel_c.clamp(0, 3)).reshape(n, H * W)
    overlay = in_box & mask.gather(1, cell).view(n, H, W)
    locked = state.board | overlay

    # clear the full rows within the piece's span: a stable partition puts
    # the cleared rows on top (zeroed), the rest keep their order
    in_span = (rows >= drop[:, None]) & (rows < (drop + h)[:, None])
    cleared = locked.all(dim=2) & in_span
    k = cleared.sum(dim=1).to(torch.int32)
    order = torch.argsort(torch.where(cleared, 0, 1), dim=1, stable=True)
    board_after = (locked.gather(1, order[:, :, None].expand(n, H, W))
                   & (rows >= k[:, None])[:, :, None])

    moves_used = state.moves_used + 1
    lines = state.lines_cleared + k
    prev = state.status.to(torch.int32)
    over = moves_used >= state.move_limit
    status_noclear = torch.where(over, LOSS, prev)
    status_clear = torch.where(lines >= state.lines_goal, WIN, status_noclear)
    status = torch.where(
        topout, LOSS, torch.where(k > 0, status_clear, status_noclear)
    ).to(torch.int8)

    new_state = EnvState(
        board=torch.where(topout[:, None, None], state.board, board_after),
        pieces=state.pieces,
        cursor=state.cursor + 1,  # consumed even on a top-out (tetris.py:356)
        lines_cleared=torch.where(topout, state.lines_cleared, lines),
        moves_used=torch.where(topout, state.moves_used, moves_used),
        lines_goal=state.lines_goal,
        move_limit=state.move_limit,
        status=status,
    )
    lines_delta = torch.where(topout, torch.zeros_like(k), k)
    done = status != RUNNING
    return StepResult(new_state, lines_delta, done, status == WIN)


def observe(state: EnvState) -> torch.Tensor:
    """float32[N, 217]: 200 board cells (row-major), one-hot current and
    next piece (indices clamped into the sequence), lines-left, moves-left,
    status (+1 win, -1 loss) (reference ``get_state``, game/tetris.py:
    435-436)."""
    n = state.board.shape[0]
    eye = torch.eye(tables.NUM_PIECES, device=state.board.device)
    status_f = torch.where(state.status == WIN, 1.0,
                           torch.where(state.status == LOSS, -1.0, 0.0))
    return torch.cat([
        state.board.reshape(n, H * W).float(),
        eye[_piece_at(state)],
        eye[_piece_at(state, 1)],
        torch.stack([(state.lines_goal - state.lines_cleared).float(),
                     (state.move_limit - state.moves_used).float(),
                     status_f], dim=1),
    ], dim=1)


# the JAX engine's vmapped names; this engine is batch first by construction
step_batch = step
observe_batch = observe


def reset_from_bank(bank_boards: torch.Tensor, bank_pieces: torch.Tensor,
                    index: torch.Tensor, lines_goal, move_limit) -> EnvState:
    """Fresh states from bank rows ``index`` (bool[B, 20, 10] boards)."""
    idx = index.long()
    return make_state_batch(bank_boards[idx], bank_pieces[idx], lines_goal,
                            move_limit)


def step_autoreset_batch(
    states: EnvState,
    rotations: torch.Tensor,
    locations: torch.Tensor,
    bank_boards: torch.Tensor,   # bool[B, 20, 10]
    bank_pieces: torch.Tensor,   # int8[B, P]
    reset_idx: torch.Tensor,     # int[N] bank rows for envs that finish
) -> tuple[EnvState, StepResult]:
    """Step; terminal envs are swapped for bank rows ``reset_idx`` (each
    env keeps its own goal and limit)."""
    res = step(states, rotations, locations)
    idx = reset_idx.long()
    z = torch.zeros_like(states.cursor)
    fresh = EnvState(
        board=bank_boards[idx], pieces=bank_pieces[idx], cursor=z,
        lines_cleared=z, moves_used=z, lines_goal=states.lines_goal,
        move_limit=states.move_limit, status=torch.zeros_like(states.status))
    return state_where(res.done, fresh, res.state), res
