"""On-device forward-family generator and its vectorized winnability prover.

Counterpart of ``tetris_piclim_tpu/gen/jax_forward.py``. Thousands of
forward-family candidates per call, each proven winnable or dropped:

* prefill: lockstep random hard drops onto empty packed boards until the
  next placement would top the ``initial_height_max`` cap (reference
  TetrisGameGenerator.py:72-85: a colliding piece is skipped, full rows
  clear, the capping placement is not made);
* sequence: independent 7-bag draws (:func:`.bag.bag_sequences_device`);
* prove: a beam search (default width 8). Every move expands all live
  search states x 40 (rotation, column) placements, scores them (win now >>
  total lines >> fewer buried holes >> drop depth, ties to the lowest
  rotation then the leftmost column), drops duplicate successors and keeps
  the best K. A game is winnable only when a recorded action sequence wins.
  ``beam_width=1`` is the greedy one-step rollout.

Given the same boards and sequences, the provers return the JAX package's
verdicts, solutions and lengths word for word, on the CPU and on the GPU
alike: every selection is a stable sort or a first-index search (CUDA's
``topk`` and ``argsort`` give no order among ties), and the successor hash
is the JAX uint32 multiply-xor, computed in int64 and masked to 32 bits.
The prefill takes its draws as an input (``draws=``) so that a test can
feed it JAX's; otherwise it draws them from ``generator``.

The beam prover stops early once every game is decided (won, or no live
beam left): the JAX scan runs all M moves, but the later moves change none
of the outputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import tables
from ..engine import RUNNING, WIN
from ..ops.bitboard import (
    PackedState,
    _ctz20,
    _popcount,
    current_piece,
    device_tables,
    make_state_batch,
    state_where,
    step,
)
from .bag import bag_sequences_device
from .device_carver import _first

H, W = tables.BOARD_H, tables.BOARD_W
_NEG = -(2 ** 30)
_MASK32 = 0xFFFFFFFF
_HASH_MUL = 1_000_003
_CHECK_EVERY = 4  # moves between host checks of the all-decided condition


class ForwardBatch(NamedTuple):
    boards: torch.Tensor     # int32[N, 10] packed prefill boards
    pieces: torch.Tensor     # int8[N, M+1] 7-bag piece sequence
    rotations: torch.Tensor  # int8[N, M]   the prover's solution
    locations: torch.Tensor  # int8[N, M]
    n_moves: torch.Tensor    # int32[N]     solution length (winners only)
    winnable: torch.Tensor   # bool[N]      proven winnable


def _clear_rows(board: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Delete the rows set in ``rows`` (a word per board, at most 4 bits)
    from the column words ``board[..., 10]``, topmost first."""
    cmw = rows
    for _ in range(4):
        active = cmw != 0
        lsb = cmw & -cmw
        low = lsb - 1
        keep_hi = ~((lsb << 1) - 1)
        newb = ((board & low[..., None]) << 1) | (board & keep_hi[..., None])
        board = torch.where(active[..., None], newb, board)
        cmw = cmw & (cmw - 1)
    return board


def _full_rows(locked: torch.Tensor) -> torch.Tensor:
    full = locked[..., 0]
    for c in range(1, W):
        full = full & locked[..., c]
    return full


# -- prefill -----------------------------------------------------------------

def prefill_boards_device(
    n: int,
    initial_height_max: int = 4,
    max_iters: int = 96,
    *,
    draws: Optional[tuple] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """int32[n, 10]: random-stack prefill boards, height <= the cap.

    Each iteration drops one (piece, rotation, column) on every board that
    has not stopped; a drop whose top lands above the cap stops that board
    and is not placed; full rows clear. ``max_iters`` only bounds the loop:
    boards stop themselves. ``draws=(piece, rot_raw, u)``, each
    ``[iterations, n]`` (ints in [0, 7) and [0, 4), float32 in [0, 1)), are
    the per-iteration draws and must cover ``max_iters`` iterations; without
    them ``max_iters`` iterations' worth come from ``generator``.
    ``device`` defaults to that of the draws, else of the generator."""
    if draws is None and generator is None:
        raise ValueError("prefill_boards_device needs a generator or draws")
    if device is None:
        device = draws[0].device if draws is not None else generator.device
    if draws is None:
        shape = (max_iters, n)
        draws = (
            torch.randint(0, 7, shape, generator=generator, device=device),
            torch.randint(0, 4, shape, generator=generator, device=device),
            torch.rand(shape, generator=generator, device=device),
        )
    pieces, rots, us = (torch.as_tensor(d, device=device) for d in draws)
    have = min(d.shape[0] for d in (pieces, rots, us))
    if have < max_iters:
        raise ValueError(f"draws cover {have} prefill iterations, fewer than "
                         f"max_iters={max_iters}")
    dev = pieces.device
    t = device_tables(dev)
    cols = torch.zeros((n, W), dtype=torch.int32, device=dev)
    stopped = torch.zeros((n,), dtype=torch.bool, device=dev)
    for it in range(max_iters):
        if it % 16 == 0 and it and bool(stopped.all()):
            break  # stopped boards never change again
        piece = pieces[it].long()
        r = torch.remainder(rots[it].long(), t.nrot[piece])
        w = t.width[piece, r]
        # float32 product as in JAX, truncated toward zero
        loc = (us[it].float() * (W - w + 1).float()).to(torch.int32).long()
        loc = torch.minimum(loc.clamp(min=0), W - w)

        flat = (piece * 4 + r) * 10 + loc
        drop = (_ctz20(cols) - t.rtopo10[flat]).min(dim=1).values - 1
        collide = drop < 0                    # skip, don't stop
        over_cap = (H - drop) > initial_height_max
        place = ~stopped & ~collide & ~over_cap
        stopped = stopped | (~collide & over_cap)

        locked = cols | (t.colmask10[flat] << drop.clamp(min=0)[:, None])
        board = _clear_rows(locked, _full_rows(locked))
        cols = torch.where(place[:, None], board, cols)
    return cols


# -- placement scoring (shared by the greedy and beam provers) ---------------

def _score_placements(state: PackedState):
    """Score all 40 (rotation, column) placements of every env's next piece.

    Returns ``(score, win_now, topout, succ_hash)``, each ``[n, 4, 10]``:
    ``score`` int32 (win now >> total lines >> fewer buried holes >> deeper
    drop; rotation-major, so first-index ties prefer the lowest rotation,
    then the leftmost column), ``win_now`` and ``topout`` bool, and
    ``succ_hash`` int64 holding the uint32 hash of (post-clear board, total
    lines) that the beam uses to drop duplicate successors."""
    t = device_tables(state.cols.device)
    piece = current_piece(state)                            # [n]
    dev = piece.device
    pe = piece[:, None]
    r = torch.remainder(torch.arange(4, device=dev)[None, :], t.nrot[pe])
    w = t.width[pe, r]                                      # [n, 4]
    h = t.height[pe, r].to(torch.int32)
    loc = torch.minimum(torch.arange(10, device=dev)[None, None, :],
                        (W - w)[:, :, None])                # [n, 4, 10]
    flat = (pe[:, :, None] * 4 + r[:, :, None]) * 10 + loc
    mask = t.colmask10[flat]                                # int32[n,4,10,10]
    rtopo = t.rtopo10[flat]

    topo = _ctz20(state.cols)                               # [n, 10]
    drop = (topo[:, None, None, :] - rtopo).min(dim=3).values - 1
    topout = drop < 0
    dropc = drop.clamp(min=0)

    locked = state.cols[:, None, None, :] | (mask << dropc[..., None])
    full = _full_rows(locked)
    span = ((1 << h) - 1)[:, :, None] << dropc
    cm = full & span
    k = _popcount(cm)

    total = state.lines_cleared[:, None, None] + k
    win_now = total >= state.lines_goal[:, None, None]
    # holes under the post-placement surface: per column, the empty cells
    # below its top filled cell
    cleared = _clear_rows(locked, cm)
    col_fill = _popcount(cleared)
    col_height = H - _ctz20(cleared)
    holes = (col_height - col_fill).sum(dim=3, dtype=torch.int32)
    score = (torch.where(win_now, 10_000_000, 0).to(torch.int32)
             + total * 100_000 - holes * 2_000 + drop)
    succ_hash = torch.zeros(cleared.shape[:3], dtype=torch.int64, device=dev)
    for c in range(W):
        succ_hash = ((succ_hash * _HASH_MUL) & _MASK32) ^ cleared[..., c].long()
    succ_hash = ((succ_hash * _HASH_MUL) & _MASK32) ^ total.long()
    return score, win_now, topout, succ_hash


def _greedy_actions(state: PackedState) -> tuple[torch.Tensor, torch.Tensor]:
    """Best (rotation, location) per env over all 40 placements; top-outs
    are the last resort, ties go to the lowest rotation, then column."""
    n = state.cols.shape[0]
    score, _, topout, _ = _score_placements(state)
    score = (score - torch.where(topout, 100_000_000, 0)).reshape(n, 40)
    a = _first(score == score.max(dim=1, keepdim=True).values)
    return a // 10, a % 10


def prove_batch_device(boards, pieces, L: int, M: int, beam_width: int = 1):
    """Prove each (board, sequence) winnable within M moves.

    ``beam_width=1``: the greedy rollout; ``beam_width=K>1``: the beam
    search (:func:`_beam_prove`). Returns ``(winnable bool[N], rotations
    int8[N, M], locations int8[N, M], n_moves int32[N])``; winners' recorded
    actions replay to WIN. ``boards`` are int32[N, 10] or bool[N, 20, 10]."""
    if beam_width > 1:
        return _beam_prove(boards, pieces, L, M, beam_width)
    state = make_state_batch(boards, pieces, L, M)
    rots, locs = [], []
    for _ in range(M):
        rot, loc = _greedy_actions(state)
        res = step(state, rot, loc)
        state = state_where(state.status != RUNNING, state, res.state)
        rots.append(rot.to(torch.int8))
        locs.append(loc.to(torch.int8))
    winnable = state.status == WIN
    return (winnable, torch.stack(rots, dim=1), torch.stack(locs, dim=1),
            torch.where(winnable, state.moves_used, 0))


def _beam_prove(boards, pieces, L: int, M: int, K: int):
    """Beam-search prover (see :func:`prove_batch_device`).

    The search state is [N, K] envs flattened to [N*K] (game-major), so the
    step and the scorer run unchanged. Each move: score all K*40 successors
    of every game; record the first winning successor of a game not yet won
    (its beam's history plus the winning action is the solution, so won
    states never take a beam slot); mask dead successors (top-outs, dead
    beams) and duplicates (equal hash, kept once); keep the K best by a
    stable descending sort (``lax.top_k``'s lower-index-first ties) and step
    their parents."""
    state0 = make_state_batch(boards, pieces, L, M)
    N, dev = state0.cols.shape[0], state0.cols.device
    state = PackedState(*[x.repeat_interleave(K, dim=0) for x in state0])
    alive = (torch.arange(N * K, device=dev) % K) == 0   # beam 0 only
    hist_rot = torch.zeros((N, K, M), dtype=torch.int8, device=dev)
    hist_loc = torch.zeros_like(hist_rot)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    sol_rot = torch.zeros((N, M), dtype=torch.int8, device=dev)
    sol_loc = torch.zeros_like(sol_rot)
    sol_len = torch.zeros((N,), dtype=torch.int32, device=dev)
    slot = torch.arange(K * 40, device=dev)[None, :]
    games = torch.arange(N, device=dev)[:, None]

    for i in range(M):
        if i % _CHECK_EVERY == 0 and i and not bool(
                (~done & alive.reshape(N, K).any(dim=1)).any()):
            break  # every game won or out of live beams
        score, win_now, topout, succ_hash = _score_placements(state)
        score = score.reshape(N, K, 40)
        win_now = win_now.reshape(N, K, 40)
        valid = alive.reshape(N, K)[:, :, None] & ~topout.reshape(N, K, 40)
        score = torch.where(valid, score, _NEG)

        # -- record the first winning successor of each game not yet won
        flat_win = (win_now & valid).reshape(N, K * 40)
        any_win = flat_win.any(dim=1)
        wi = torch.where(any_win, _first(flat_win), 0)
        wb, wa = wi // 40, wi % 40
        win_rot = hist_rot.gather(1, wb[:, None, None].expand(N, 1, M))[:, 0]
        win_loc = hist_loc.gather(1, wb[:, None, None].expand(N, 1, M))[:, 0]
        win_rot[:, i] = (wa // 10).to(torch.int8)
        win_loc[:, i] = (wa % 10).to(torch.int8)
        newly = any_win & ~done
        sol_rot = torch.where(newly[:, None], win_rot, sol_rot)
        sol_loc = torch.where(newly[:, None], win_loc, sol_loc)
        sol_len = torch.where(newly, i + 1, sol_len)
        done = done | any_win

        # wins are recorded, not expanded. Dedup runs over valid, non-winning
        # slots only: the others get slot-unique sentinel hashes, and a slot
        # is a duplicate only when the preceding equal-hash slot is valid
        score = torch.where(win_now, _NEG, score).reshape(N, K * 40)
        flat_ok = (valid & ~win_now).reshape(N, K * 40)
        h = torch.where(flat_ok, succ_hash.reshape(N, K * 40), slot)
        hs, order = torch.sort(h, dim=1, stable=True)
        ok_sorted = flat_ok.gather(1, order)
        dup_sorted = torch.zeros_like(flat_ok)
        dup_sorted[:, 1:] = (hs[:, 1:] == hs[:, :-1]) & ok_sorted[:, :-1]
        dup = torch.zeros_like(flat_ok).scatter_(1, order, dup_sorted)
        score = torch.where(dup, _NEG, score)

        # -- keep the K best successors and step their parents
        top_scores, top_idx = torch.sort(score, dim=1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
        tb, ta = top_idx // 40, top_idx % 40
        parent = PackedState(*[x[(games * K + tb).reshape(-1)] for x in state])
        state = step(parent, (ta // 10).reshape(-1), (ta % 10).reshape(-1)).state
        alive = (top_scores > _NEG // 2).reshape(-1)
        hist_rot = hist_rot.gather(1, tb[:, :, None].expand(N, K, M))
        hist_loc = hist_loc.gather(1, tb[:, :, None].expand(N, K, M))
        hist_rot[:, :, i] = (ta // 10).to(torch.int8)
        hist_loc[:, :, i] = (ta % 10).to(torch.int8)

    return done, sol_rot, sol_loc, torch.where(done, sol_len, 0)


# -- end to end --------------------------------------------------------------

def generate_batch_device(
    n: int,
    L: int,
    M: int,
    initial_height_max: int = 4,
    beam_width: int = 8,
    *,
    generator: torch.Generator,
    device,
) -> ForwardBatch:
    """``n`` forward-family candidates, generated and proven in lockstep.
    Winners (``.winnable``) are winnable; callers oversample and keep them.
    Sequences have length M+1 (the env's next-piece slot)."""
    dev = torch.device(device)
    cols = prefill_boards_device(n, initial_height_max, generator=generator,
                                 device=dev)
    pieces = bag_sequences_device(n, M + 1, generator=generator, device=dev)
    winnable, rots, locs, n_moves = prove_batch_device(
        cols, pieces, L, M, beam_width=beam_width)
    return ForwardBatch(boards=cols, pieces=pieces, rotations=rots,
                        locations=locs, n_moves=n_moves.to(torch.int32),
                        winnable=winnable)
