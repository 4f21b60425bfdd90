"""Device-resident ring replay buffer of packed transitions.

Counterpart of ``tetris_piclim_tpu/dqn/replay.py``. A transition is stored
packed: the 10 column words plus the scalar obs fields (current/next piece,
lines-left, moves-left, status), ~93 bytes instead of two 217-float
observations; the float observations are rebuilt at sample time for the
batch only.

Writes are one contiguous slice at the ring head. The capacity must be a
multiple of the per-step batch, so a write never wraps, and the next
transition of the same env slot sits exactly ``step_gap`` (= num_envs)
slots ahead: an n-step chain is a pure gather. ``pos`` and ``size`` are
host ints, so the trainer needs no device sync per step. The buffer is
updated in place (the JAX version returns a new pytree).

Prioritized replay (PER): every slot keeps its raw priority ``|td| + eps``
and a fresh write takes the running maximum ``max_prio``, a device tensor,
so neither costs a sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
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
    # n-step / PER extras; None = 1-step uniform (td_loss then uses
    # cfg.gamma and unit weights)
    discount: Optional[torch.Tensor] = None  # f32[B] gamma^(k*+1)
    weight: Optional[torch.Tensor] = None    # f32[B] importance weights


def cat_batches(a: Batch, b: Batch, gamma: float) -> Batch:
    """``a`` then ``b`` along the batch; a missing discount is ``gamma``
    and a missing weight 1 where the other batch has one."""
    fill = {"discount": gamma, "weight": 1.0}
    out = {}
    for name, x in a._asdict().items():
        y = getattr(b, name)
        if x is None and y is None:
            out[name] = None
            continue
        x = torch.full_like(y, fill[name]) if x is None else x
        y = torch.full_like(x, fill[name]) if y is None else y
        out[name] = torch.cat([x, y], dim=0)
    return Batch(**out)


class ReplayBuffer:
    """Ring of ``capacity`` packed transitions on ``device``."""

    def __init__(self, capacity: int, device="cpu"):
        self.capacity = capacity
        self.device = torch.device(device)
        self.buf = {
            name: torch.zeros((capacity, *shape), dtype=dtype, device=self.device)
            for name, (dtype, shape) in _FIELDS.items()
        }
        self.priority = torch.zeros((capacity,), dtype=torch.float32,
                                    device=self.device)
        self.max_prio = torch.ones((), dtype=torch.float32, device=self.device)
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
        self.priority[self.pos:self.pos + n].copy_(self.max_prio.expand(n))
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
        """Uniform 1-step sample with replacement. ``j`` [B] are offsets
        from the oldest transition, ``idx = (oldest + j) mod capacity``;
        drawn from ``generator`` when not given."""
        return self.sample_ext(batch_size, j=j, generator=generator)[0]

    def _oldest(self) -> int:
        return (self.pos - self.size) % self.capacity

    def sample_ext(self, batch_size: int, *, gamma: float = 0.99,
                   n_step: int = 1, step_gap: int = 1,
                   prioritized: bool = False, alpha: float = 0.6,
                   beta: float = 0.4, j: Optional[torch.Tensor] = None,
                   idx0: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        """n-step / prioritized sample; returns ``(batch, idx0)``, the base
        slots that :meth:`update_priority` writes back to.

        Bases are restricted to transitions whose whole chain is written
        (the newest ``(n_step - 1) * step_gap`` are excluded). Uniform: the
        bases are ``(oldest + j) mod capacity`` with offsets ``j`` in
        ``[0, valid)``. Prioritized: the bases ``idx0`` are drawn by
        ``torch.multinomial`` over ``priority ** alpha`` with the slots
        outside the valid window masked (the mask comes from the host ints
        ``pos`` and ``size``), and the batch carries max-normalized
        importance weights (Schaul et al. 2016). Either draw may be given
        (``j`` or ``idx0``) instead of drawn from ``generator``.

        The chain ``i, i + g, ..., i + (n-1) g`` is cut at its first
        ``done`` (the auto-reset successor starts a new episode): the
        return sums ``gamma^k r_k`` up to and including it, ``next_obs`` is
        its successor state and ``discount`` is ``gamma^(k* + 1)``. The
        status lane of ``obs`` is 0: a stored pre-action state is always
        running. A 1-step batch carries no discount, a uniform one no weight.
        """
        cap, dev = self.capacity, self.device
        oldest = self._oldest()
        valid = max(self.size - (n_step - 1) * step_gap, 1)
        weight = None
        if prioritized:
            logical = torch.remainder(
                torch.arange(cap, device=dev) - oldest, cap)
            ok = logical < valid
            logp = alpha * torch.log(self.priority.clamp(min=1e-12))
            logits = torch.where(ok, logp, float("-inf"))
            if idx0 is None:
                probs = torch.where(ok, torch.exp(logp), 0.0)
                idx0 = torch.multinomial(probs, batch_size, replacement=True,
                                         generator=generator)
            idx0 = idx0.to(dev).long()
            log_p = logp[idx0] - torch.logsumexp(logits, dim=0)
            w = torch.exp(-beta * (torch.log(torch.tensor(
                float(valid), dtype=torch.float32, device=dev)) + log_p))
            weight = w / w.max().clamp(min=1e-12)
        elif idx0 is None:
            if j is None:
                j = torch.randint(0, valid, (batch_size,), generator=generator,
                                  device=dev)
            idx0 = torch.remainder(oldest + j.to(dev).long(), cap)
        else:
            idx0 = idx0.to(dev).long()

        b = self.buf
        if n_step == 1:
            idx_last, reward, done, discount = (
                idx0, b["reward"][idx0], b["done"][idx0], None)
        else:
            ks = torch.arange(n_step, device=dev)
            idx = torch.remainder(idx0[:, None] + ks[None, :] * step_gap, cap)
            rew, dn = b["reward"][idx], b["done"][idx]
            # gamma^k in float32, made on the host: the same table on every
            # device, and the return summed in chain order
            powers = torch.as_tensor(
                np.float32(gamma) ** np.arange(n_step + 1, dtype=np.float32),
                device=dev)
            live = torch.ones_like(dn[:, 0])   # no done strictly before k
            reward = torch.zeros_like(rew[:, 0])
            for k in range(n_step):
                reward = reward + live.float() * powers[k] * rew[:, k]
                live = live & ~dn[:, k]
            k_star = torch.where(dn, ks[None, :], n_step).min(dim=1).values
            k_star = k_star.clamp(max=n_step - 1)   # no done: the chain's end
            idx_last = idx.gather(1, k_star[:, None])[:, 0]
            done = dn.gather(1, k_star[:, None])[:, 0]
            discount = powers[k_star + 1]
        obs = obs_from_fields(b["cols"][idx0], b["cur"][idx0], b["nxt"][idx0],
                              b["lines_left"][idx0], b["moves_left"][idx0],
                              torch.zeros_like(b["cur"][idx0]))
        next_obs = obs_from_fields(
            b["n_cols"][idx_last], b["n_cur"][idx_last], b["n_nxt"][idx_last],
            b["n_lines_left"][idx_last], b["n_moves_left"][idx_last],
            b["n_status"][idx_last])
        batch = Batch(obs=obs, rot=b["rot"][idx0].long(),
                      col=b["col"][idx0].long(), reward=reward,
                      next_obs=next_obs, done=done, discount=discount,
                      weight=weight)
        return batch, idx0

    def update_priority(self, idx: torch.Tensor, td_abs: torch.Tensor,
                        eps: float) -> None:
        """Write ``|td| + eps`` back at the sampled slots and raise
        ``max_prio``. Where a slot was sampled more than once the last
        occurrence wins: every occurrence writes the value of the last one,
        so the result does not depend on the order of the scatter (CUDA's
        ``index_put_`` keeps an unspecified one of the duplicates)."""
        new_p = td_abs.float() + eps
        same = idx[:, None] == idx[None, :]
        pos = torch.arange(idx.shape[0], device=idx.device)
        last = torch.where(same, pos[None, :], -1).max(dim=1).values
        self.priority[idx] = new_p[last]
        torch.maximum(self.max_prio, new_p.max(), out=self.max_prio)

    def state_dict(self) -> dict:
        return {"buf": self.buf, "pos": self.pos, "size": self.size,
                "priority": self.priority, "max_prio": self.max_prio}

    def load_state_dict(self, sd: dict) -> None:
        for name, buf in self.buf.items():
            buf.copy_(sd["buf"][name])
        self.pos, self.size = int(sd["pos"]), int(sd["size"])
        if "priority" in sd:
            self.priority.copy_(sd["priority"])
            self.max_prio.copy_(sd["max_prio"])
        else:
            # a buffer saved before priorities were kept: every written slot
            # (a ring that has not wrapped is written from slot 0) at the
            # initial max priority, as the JAX buffer writes them
            self.priority.zero_()
            self.priority[:self.size] = 1.0
            self.max_prio.fill_(1.0)
