"""On-device vectorized carving generator (PyTorch, packed bitboards).

Counterpart of ``tetris_piclim_tpu/gen/jax_carver.py``: the reverse-carving
construction of the reference (game/tetris.py:226-352) run for thousands of
configurations in lockstep. Each iteration proposes a random (piece,
rotation, location) per env, evaluates the 4 candidate carve depths at once
and accepts the first valid one.

Kept from the reference (they make the output provably winnable): a carve is
accepted only when a fresh hard drop after the carve lands exactly in the
carved hole (game/tetris.py:341-349); the first carve may be partial, later
carves must overlap fully (game/tetris.py:257, 303-329); carving ends when
the bottom row has <= 8 filled cells (game/tetris.py:234); the piece list is
padded to M+1. As in the JAX carver, pieces are iid uniform and an env that
fails 40 carves in a row restarts from the solid board.

The draws come from a ``torch.Generator`` or, as ``draws=``, from the
caller: fed JAX's own draws, the carver returns JAX's batch word for word,
and fed draws made on the CPU, the card returns the CPU's.

The loop checks its all-done condition every 16 iterations
rather than every one, so the host waits on the device that much less often;
finished envs are frozen, so the extra iterations change nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import tables
from ..ops.bitboard import _ctz20, device_tables

H, W = tables.BOARD_H, tables.BOARD_W
_MAX_FAILS = 40  # reference CheckpointManager.max_attempts (game/tetris.py:116)
_CHECK_EVERY = 16  # iterations between host checks of the all-done condition


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True on the last dim (its size when none)."""
    n = mask.shape[-1]
    lane = torch.arange(n, device=mask.device)
    return torch.where(mask, lane, n).min(dim=-1).values


class CarveBatch(NamedTuple):
    boards: torch.Tensor     # int32[N, 10] packed initial configurations
    pieces: torch.Tensor     # int8[N, M+1] piece sequence (played order)
    rotations: torch.Tensor  # int8[N, M]   solution rotations (played order)
    locations: torch.Tensor  # int8[N, M]   solution locations (played order)
    n_moves: torch.Tensor    # int32[N]     carved prefix length (<= M)


class _Carry(NamedTuple):
    cols: torch.Tensor   # int32[n, 10] boards being carved
    seq: torch.Tensor    # int8[n, M]   carved pieces, carve order
    rots: torch.Tensor   # int8[n, M]
    locs: torch.Tensor   # int8[n, M]
    n_mv: torch.Tensor   # int64[n]     carves accepted so far
    fails: torch.Tensor  # int64[n]     failed carves in a row
    done: torch.Tensor   # bool[n]


def _carve_iter(t, solid: torch.Tensor, depth: torch.Tensor,
                slots: torch.Tensor, c: _Carry, piece: torch.Tensor,
                rot_raw: torch.Tensor, u: torch.Tensor) -> _Carry:
    """One lockstep carve attempt per env from its (piece, raw rotation,
    uniform location) draw (JAX's loop body, gen/jax_carver.py:84-186);
    ``depth`` is ``arange(4)[None]`` and ``slots`` ``arange(M)[None]``."""
    cols, seq, rots, locs, n_mv, fails, done = c
    n, M = seq.shape
    i32 = torch.int32
    r = torch.remainder(rot_raw, t.nrot[piece])
    w = t.width[piece, r]
    h = t.height[piece, r]
    loc = (u * (W - w + 1).float()).long().clamp(min=0)
    loc = torch.minimum(loc, W - w)

    flat = (piece * 4 + r) * 10 + loc
    mask10 = t.colmask10[flat]
    rtopo10 = t.rtopo10[flat]

    # forward drop on the current board (reference game/tetris.py:293-301)
    deltas = _ctz20(cols) - rtopo10
    dmin = deltas.min(dim=1).values
    drop0 = dmin - 1
    amin = _first(deltas == dmin[:, None])
    push = rtopo10.gather(1, amin[:, None])[:, 0] + 1
    top_drop = drop0 + push

    allow_partial = n_mv == 0
    cand = top_drop[:, None] - depth                         # [n, 4]
    n_cand = torch.where(allow_partial, h, torch.ones_like(h))
    shift = cand.clamp(0, H).to(i32)
    smask = mask10[:, None, :] << shift[:, :, None]          # [n, 4, 10]
    in_bounds = (cand >= 0) & (cand + h[:, None] <= H)
    overlap_full = ((cols[:, None, :] & smask) == smask).all(dim=2)
    carved = cols[:, None, :] & ~smask
    nd = (_ctz20(carved) - rtopo10[:, None, :]).min(dim=2).values - 1
    ok = ((depth < n_cand[:, None]) & in_bounds
          & (allow_partial[:, None] | overlap_full) & (nd == cand))
    any_ok = ok.any(dim=1)
    first = _first(ok).clamp(max=3)
    chosen = carved.gather(1, first[:, None, None].expand(n, 1, W))[:, 0]

    active = ~done & (n_mv < M)
    accept = active & any_ok
    new_cols = torch.where(accept[:, None], chosen, cols)
    write = (slots == n_mv.clamp(0, M - 1)[:, None]) & accept[:, None]
    seq = torch.where(write, piece[:, None].to(torch.int8), seq)
    rots = torch.where(write, rot_raw[:, None].to(torch.int8), rots)
    locs = torch.where(write, loc[:, None].to(torch.int8), locs)
    n_mv = n_mv + accept.long()
    fails = torch.where(accept, 0, torch.where(active, fails + 1, fails))

    bottom = ((new_cols >> (H - 1)) & 1).sum(dim=1)
    finished = active & (bottom <= 8) & (n_mv > 0)          # tetris.py:234
    done = done | finished
    restart = active & ~finished & ((fails > _MAX_FAILS) | (n_mv >= M))
    return _Carry(
        cols=torch.where(restart[:, None], solid, new_cols),
        seq=seq, rots=rots, locs=locs,
        n_mv=torch.where(restart, 0, n_mv),
        fails=torch.where(restart, 0, fails),
        done=done)


def generate_batch_device(
    n: int,
    L: int,
    M: int,
    *,
    max_iters: Optional[int] = None,
    draws: Optional[tuple] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> CarveBatch:
    """Carve ``n`` winnable (board, sequence) configurations in lockstep.
    The first ``n_moves`` entries of the recorded solution replay to a WIN
    clearing >= L lines.

    ``max_iters`` bounds the loop (None: JAX's ``24 * M + 512``); rows not
    done by then have ``n_moves == 0``. The draws come from ``generator``,
    each iteration's (piece, rotation, location) in turn and then the pad
    pieces, or from ``draws=(piece, rot_raw, u, pad)``: ``piece`` ints in
    [0, 7), ``rot_raw`` ints in [0, 4) and ``u`` float32 in [0, 1), each
    ``[iterations, n]``, and ``pad`` int8 in [0, 7) ``[n, M+1]``, as JAX's
    loop body and its final split draw them; the loop then runs at most
    ``min(max_iters, iterations)`` iterations. ``device`` defaults to that
    of the draws, else of the generator."""
    if draws is None and generator is None:
        raise ValueError("generate_batch_device needs a generator or draws")
    if max_iters is None:
        max_iters = 24 * M + 512  # as the JAX carver
    if device is None:
        device = draws[0].device if draws is not None else generator.device
    dev = torch.device(device)
    if draws is not None:
        d_piece, d_rot, d_u, d_pad = (torch.as_tensor(d, device=dev) for d in draws)
        max_iters = min(max_iters, d_piece.shape[0])
    t = device_tables(dev)
    solid = torch.full((n, W), ((1 << L) - 1) << (H - L), dtype=torch.int32,
                       device=dev)
    seq = torch.zeros((n, M), dtype=torch.int8, device=dev)
    n_mv = torch.zeros((n,), dtype=torch.int64, device=dev)
    c = _Carry(cols=solid.clone(), seq=seq, rots=torch.zeros_like(seq),
               locs=torch.zeros_like(seq), n_mv=n_mv, fails=torch.zeros_like(n_mv),
               done=torch.zeros((n,), dtype=torch.bool, device=dev))
    depth = torch.arange(4, device=dev)[None, :]
    slots = torch.arange(M, device=dev)[None, :]

    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and bool(c.done.all()):
            break
        if draws is None:
            piece = torch.randint(0, 7, (n,), generator=generator, device=dev)
            rot_raw = torch.randint(0, 4, (n,), generator=generator, device=dev)
            u = torch.rand((n,), generator=generator, device=dev)
        else:
            piece, rot_raw, u = d_piece[it].long(), d_rot[it].long(), d_u[it].float()
        c = _carve_iter(t, solid, depth, slots, c, piece, rot_raw, u)

    # carved order is reversed for play (reference insert(0, ...) at
    # game/tetris.py:258-260): played[i] = carved[n_mv - 1 - i]
    P = M + 1
    idx = c.n_mv[:, None] - 1 - torch.arange(P, device=dev)[None, :]
    if draws is None:
        pad = torch.randint(0, 7, (n, P), generator=generator, device=dev)
    else:
        pad = d_pad
    pieces = torch.where(idx >= 0, c.seq.gather(1, idx.clamp(0, M - 1)),
                         pad.to(torch.int8))
    idx_m = idx[:, :M]
    valid_m = idx_m >= 0
    gidx = idx_m.clamp(0, M - 1)
    zero = torch.zeros_like(c.rots)
    return CarveBatch(
        boards=c.cols,
        pieces=pieces,
        rotations=torch.where(valid_m, c.rots.gather(1, gidx), zero),
        locations=torch.where(valid_m, c.locs.gather(1, gidx), zero),
        n_moves=torch.where(c.done, c.n_mv, 0).to(torch.int32),
    )
