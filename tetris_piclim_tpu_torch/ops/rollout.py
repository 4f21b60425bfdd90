"""K fused env steps with bank auto-reset: the random-policy rollout.

Counterpart of ``tetris_piclim_tpu/ops/pallas_rollout.py::rollout_fused``.
:func:`rollout_fused` launches the CUDA kernel ``csrc/rollout.cu`` for a
state on the GPU and runs :func:`rollout_reference`, the plain PyTorch
version, for a state on the CPU.

Actions come from scripted ``actions=(rots, locs, reset_idx)`` streams of
shape [K, N] (the verification path) or, with ``actions=None``, from random
draws: in the kernel a counter-based Philox keyed on (seed, env, step), in
the plain version a ``torch.Generator``. The two give different numbers from
the same seed. :func:`philox_draws` is the plain version of the kernels'
draw stream: scripted with its output, the plain version must reproduce a
kernel's random mode word for word.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from . import bitboard as bb

MAX_BANK = 65536  # the JAX kernel's 16-bit bank index range

_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo32(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of ``m * x`` for a 32-bit constant ``m`` and
    32-bit values in an int64 tensor; 16-bit limbs keep every intermediate
    below 2^49, so int64 never overflows."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    mid = (a >> 16) + b
    return mid >> 16, (a & 0xFFFF) | ((mid & 0xFFFF) << 16)


def philox4x32_10(counter, key):
    """Philox-4x32-10 (Salmon et al., SC'11) in int64 arithmetic masked to
    32 bits. ``counter``: four int64 tensors of 32-bit words (broadcast
    together); ``key``: two ints. Returns the four output words as int64
    tensors. The plain version of ``tetris::philox4x32_10`` in
    ``csrc/env_step.cuh``."""
    x, y, z, w = torch.broadcast_tensors(*counter)
    k0, k1 = key[0] & _M32, key[1] & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, x)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, z)
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _M32, (k1 + _PHILOX_W1) & _M32
    return x, y, z, w


class PhiloxDraws(NamedTuple):
    """The kernels' draws for K steps of N envs, each [K, N]."""
    explore_u: torch.Tensor   # float32 in [0, 1), 24 bits (the actor only)
    rot: torch.Tensor         # int32 in [0, 4)
    col: torch.Tensor         # int32 in [0, 10)
    reset_idx: torch.Tensor   # int32 in [0, bank)

    @property
    def actions(self):
        """The rollout's ``actions=`` streams."""
        return self.rot, self.col, self.reset_idx

    @property
    def draws(self):
        """The actor's ``draws=`` streams."""
        return tuple(self)


def philox_draws(seed: int, n: int, n_steps: int, bank: int,
                 device=None) -> PhiloxDraws:
    """The draws the CUDA kernels make in random mode: for env e and step k
    the Philox block of counter (e, k, 0, 0) under key (seed, 0); word x
    gives the explore draw ``(x >> 8) * 2^-24``, word y the rotation
    ``(y * 4) >> 32``, word z the column ``(z * 10) >> 32`` and word w the
    bank row ``(w * bank) >> 32``. A stream depends on (seed, env, step)
    only, not on N, K or how a kernel lays its threads out."""
    env = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    step = torch.arange(n_steps, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    x, y, z, w = philox4x32_10((env, step, zero, zero), (seed, 0))
    uniform_int = lambda bits, hi: ((bits * hi) >> 32).to(torch.int32)  # noqa: E731
    return PhiloxDraws(
        explore_u=(x >> 8).to(torch.float32) * (1.0 / 16777216.0),
        rot=uniform_int(y, 4), col=uniform_int(z, 10),
        reset_idx=uniform_int(w, bank))


def rollout_reference(
    state: bb.PackedState,
    bank_cols: torch.Tensor,
    bank_pieces: torch.Tensor,
    n_steps: int,
    *,
    actions=None,
    generator: torch.Generator | None = None,
):
    """K steps of ``bitboard.step`` + bank auto-reset. Returns
    ``(state, episodes, wins)`` with the counts as 0-d int tensors."""
    n, dev = state.cols.shape[0], state.cols.device
    bank = bank_cols.shape[0]
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    wins = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(n_steps):
        if actions is not None:
            rot, loc, idx = (a[k] for a in actions)
        else:
            draw = lambda hi: torch.randint(  # noqa: E731
                0, hi, (n,), generator=generator, device=dev)
            rot, loc, idx = draw(4), draw(10), draw(bank)
        state, res = bb.step_autoreset_batch(
            state, rot, loc, bank_cols, bank_pieces, idx
        )
        episodes += res.done.sum()
        wins += res.won.sum()
    return state, episodes, wins


def check_state(state: bb.PackedState, bank_cols, bank_pieces) -> None:
    n, p = state.pieces.shape
    want = {
        "cols": (torch.int32, (n, 10)), "pieces": (torch.int8, (n, p)),
        "cursor": (torch.int32, (n,)), "lines_cleared": (torch.int32, (n,)),
        "moves_used": (torch.int32, (n,)), "lines_goal": (torch.int32, (n,)),
        "move_limit": (torch.int32, (n,)), "status": (torch.int8, (n,)),
    }
    for name, (dtype, shape) in want.items():
        x = getattr(state, name)
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() \
                or not x.is_cuda:
            raise ValueError(f"state.{name}: want contiguous CUDA {dtype}{shape}")
    b = bank_cols.shape[0]
    if bank_cols.dtype != torch.int32 or tuple(bank_cols.shape) != (b, 10) \
            or not bank_cols.is_contiguous() or not bank_cols.is_cuda:
        raise ValueError("bank_cols: want contiguous CUDA int32[B, 10]")
    if bank_pieces.dtype != torch.int8 or tuple(bank_pieces.shape) != (b, p) \
            or not bank_pieces.is_contiguous() or not bank_pieces.is_cuda:
        raise ValueError(f"bank_pieces: want contiguous CUDA int8[{b}, {p}]")
    if not 0 < b <= MAX_BANK:
        raise ValueError(f"bank capacity {b} outside 1..{MAX_BANK}")


def scripted(actions, n_steps: int, n: int, limits) -> list:
    """Validated int32 [K, N] copies of scripted draw streams; each stream's
    values must lie in [0, limit) where a limit is given (the kernel indexes
    with them)."""
    out = []
    for a, hi in zip(actions, limits):
        a = a.to(torch.int32).contiguous()
        if tuple(a.shape) != (n_steps, n):
            raise ValueError(f"scripted stream shape {tuple(a.shape)} != {(n_steps, n)}")
        if hi is not None and n_steps and (int(a.min()) < 0 or int(a.max()) >= hi):
            raise ValueError(f"scripted stream values outside [0, {hi})")
        out.append(a)
    return out


def new_state_like(state: bb.PackedState) -> bb.PackedState:
    """Output buffers for a kernel that writes a whole state (goal and limit
    are per-env constants and are shared, not copied)."""
    return bb.PackedState(
        cols=torch.empty_like(state.cols),
        pieces=torch.empty_like(state.pieces),
        cursor=torch.empty_like(state.cursor),
        lines_cleared=torch.empty_like(state.lines_cleared),
        moves_used=torch.empty_like(state.moves_used),
        lines_goal=state.lines_goal,
        move_limit=state.move_limit,
        status=torch.empty_like(state.status),
    )


def rollout_fused(
    state: bb.PackedState,
    bank_cols: torch.Tensor,     # int32[B, 10]
    bank_pieces: torch.Tensor,   # int8[B, P]
    n_steps: int,
    *,
    seed: int = 0,
    actions=None,                # optional (rots, locs, reset_idx), each [K, N]
):
    """Run ``n_steps`` fused env steps. Returns ``(state, episodes, wins)``.

    On a CUDA state this launches the kernel (and raises if it cannot); on a
    CPU state it runs :func:`rollout_reference`, with draws from a generator
    seeded by ``seed`` when ``actions`` is None."""
    if not state.cols.is_cuda:
        gen = torch.Generator(device=state.cols.device).manual_seed(seed)
        return rollout_reference(state, bank_cols, bank_pieces, n_steps,
                                 actions=actions, generator=gen)
    check_state(state, bank_cols, bank_pieces)
    n, p = state.pieces.shape
    bank = bank_cols.shape[0]
    rots = locs = idxs = None
    if actions is not None:
        rots, locs, idxs = scripted(actions, n_steps, n, (None, None, bank))
    out = new_state_like(state)
    stats = torch.zeros(2, dtype=torch.int32, device=state.cols.device)
    lib = _build.load("rollout")
    ptr = _build.ptr
    rc = lib.rollout_launch(
        ptr(state.cols), ptr(state.pieces), ptr(state.cursor),
        ptr(state.lines_cleared), ptr(state.moves_used), ptr(state.status),
        ptr(state.lines_goal), ptr(state.move_limit),
        ptr(bank_cols), ptr(bank_pieces), bank, n, p, n_steps,
        ptr(rots), ptr(locs), ptr(idxs), seed & 0xFFFFFFFF,
        ptr(bb.kernel_tables(state.cols.device)),
        ptr(out.cols), ptr(out.pieces), ptr(out.cursor),
        ptr(out.lines_cleared), ptr(out.moves_used), ptr(out.status),
        ptr(stats), torch.cuda.current_stream(state.cols.device).cuda_stream,
    )
    _build.check(rc, "rollout")
    _build.LAUNCHES["rollout"] += 1
    return out, stats[0], stats[1]
