"""Device-resident ring replay buffer of packed transitions.

Counterpart of ``tetris_piclim_tpu/dqn/replay.py`` (uniform, 1-step). A
transition is stored packed: the 10 column words plus the scalar obs fields
(current/next piece, lines-left, moves-left, status), ~93 bytes instead of
two 217-float observations; the float observations are rebuilt at sample
time for the batch only.

Writes are one contiguous slice at the ring head. The capacity must be a
multiple of the per-step batch, so a write never wraps. ``pos`` and
``size`` are host ints, so the trainer needs no device sync per step. The
buffer is updated in place (the JAX version returns a new pytree).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.bitboard import PackedState, obs_from_fields, packed_fields

_FIELDS = {  # name: (dtype, trailing shape)
    "cols": (torch.int32, (10,)),
    "cur": (torch.int8, ()),
    "nxt": (torch.int8, ()),
    "lines_left": (torch.int32, ()),
    "moves_left": (torch.int32, ()),
    "rot": (torch.int8, ()),
    "col": (torch.int8, ()),
    "reward": (torch.float32, ()),
    "done": (torch.bool, ()),
    "n_cols": (torch.int32, (10,)),
    "n_cur": (torch.int8, ()),
    "n_nxt": (torch.int8, ()),
    "n_lines_left": (torch.int32, ()),
    "n_moves_left": (torch.int32, ()),
    "n_status": (torch.int8, ()),
}


class Batch(NamedTuple):
    obs: torch.Tensor        # f32[B, 217]
    rot: torch.Tensor        # int64[B]
    col: torch.Tensor        # int64[B]
    reward: torch.Tensor     # f32[B]
    next_obs: torch.Tensor   # f32[B, 217]
    done: torch.Tensor       # bool[B]


class ReplayBuffer:
    """Ring of ``capacity`` packed transitions on ``device``."""

    def __init__(self, capacity: int, device="cpu"):
        self.capacity = capacity
        self.device = torch.device(device)
        self.buf = {
            name: torch.zeros((capacity, *shape), dtype=dtype, device=self.device)
            for name, (dtype, shape) in _FIELDS.items()
        }
        self.pos = 0
        self.size = 0

    def add_fields(self, cols, cur, nxt, ll, ml, rot, col, reward, done,
                   n_cols, n_cur, n_nxt, n_ll, n_ml, n_st) -> None:
        """Contiguous write of N transitions at the ring head."""
        n = rot.shape[0]
        if self.capacity % n:
            raise ValueError(
                f"replay capacity ({self.capacity}) must be a multiple of the "
                f"per-step batch ({n}) for wrap-free contiguous writes"
            )
        vals = (cols, cur, nxt, ll, ml, rot, col, reward, done,
                n_cols, n_cur, n_nxt, n_ll, n_ml, n_st)
        for buf, val in zip(self.buf.values(), vals):
            buf[self.pos:self.pos + n].copy_(val)
        self.pos = (self.pos + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def add(self, state_before: PackedState, rot, col, reward,
            state_after: PackedState, done) -> None:
        cols, cur, nxt, ll, ml, _ = packed_fields(state_before)
        n_cols, n_cur, n_nxt, n_ll, n_ml, n_st = packed_fields(state_after)
        self.add_fields(cols, cur, nxt, ll, ml, rot, col, reward, done,
                        n_cols, n_cur, n_nxt, n_ll, n_ml, n_st)

    def sample(self, batch_size: int, j: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Batch:
        """Uniform sample with replacement. ``j`` [B] are offsets from the
        oldest transition, ``idx = (oldest + j) mod capacity``; drawn from
        ``generator`` when not given. The status lane of ``obs`` is 0: a
        stored pre-action state is always running."""
        if j is None:
            j = torch.randint(0, max(self.size, 1), (batch_size,),
                              generator=generator, device=self.device)
        oldest = (self.pos - self.size) % self.capacity
        idx = torch.remainder(oldest + j.to(self.device).long(), self.capacity)
        b = {name: buf[idx] for name, buf in self.buf.items()}
        obs = obs_from_fields(b["cols"], b["cur"], b["nxt"], b["lines_left"],
                              b["moves_left"], torch.zeros_like(b["cur"]))
        next_obs = obs_from_fields(b["n_cols"], b["n_cur"], b["n_nxt"],
                                   b["n_lines_left"], b["n_moves_left"],
                                   b["n_status"])
        return Batch(obs=obs, rot=b["rot"].long(), col=b["col"].long(),
                     reward=b["reward"], next_obs=next_obs, done=b["done"])

    def state_dict(self) -> dict:
        return {"buf": self.buf, "pos": self.pos, "size": self.size}

    def load_state_dict(self, sd: dict) -> None:
        for name, buf in self.buf.items():
            buf.copy_(sd["buf"][name])
        self.pos, self.size = int(sd["pos"]), int(sd["size"])
