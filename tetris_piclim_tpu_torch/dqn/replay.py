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

Under a data-parallel mesh (``parallel/mesh.py``) of W ranks the ring is
still one global ring of ``capacity`` slots, as JAX's sharded ring is, but
each rank stores only the transitions of its own N/W envs (N = num_envs):
global slot ``g = t N + e`` (ring row t, env e) lives on rank ``e // (N/W)``
at local slot ``t N/W + e mod N/W`` (:meth:`ReplayBuffer.global_to_local`).
Each rank writes its envs' block contiguously, so writes need no
communication, and an n-step chain ``g, g + N, ...`` stays on one rank.
``pos`` and ``size`` count global slots. Every rank draws the same global
indices; each reads the rows at their local slots (the rows another rank
owns read as some valid row of its own, which the learner masks out).
Under PER the priorities are gathered from every rank before a draw, so
the draw and its weights are the one-process ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.bitboard import PackedState, obs_from_fields, packed_fields
from ..utils.device import resolve_device

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
    """Ring of ``capacity`` packed transitions on ``device``; under a
    ``mesh`` this rank's ``capacity / W`` of them, for a trainer of
    ``num_envs`` envs in all (see the module docstring)."""

    def __init__(self, capacity: int, device="cuda", mesh=None,
                 num_envs: Optional[int] = None):
        self.capacity = capacity
        self.mesh = mesh
        self.world = 1 if mesh is None else mesh.size
        self.rank = 0 if mesh is None else mesh.rank
        self.num_envs = num_envs
        if mesh is not None:
            if num_envs is None or num_envs % self.world or capacity % num_envs:
                raise ValueError(
                    f"a ring on a mesh of {self.world} needs num_envs ({num_envs}) "
                    f"divisible by the mesh size and replay capacity "
                    f"({capacity}) a multiple of num_envs")
            device = mesh.device
        self.device = resolve_device(device)
        local = capacity // self.world
        self.buf = {
            name: torch.zeros((local, *shape), dtype=dtype, device=self.device)
            for name, (dtype, shape) in _FIELDS.items()
        }
        self.priority = torch.zeros((local,), dtype=torch.float32,
                                    device=self.device)
        self.max_prio = torch.ones((), dtype=torch.float32, device=self.device)
        self.pos = 0
        self.size = 0

    def global_to_local(self, g):
        """``(owner rank, local slot)`` of global slot(s) ``g`` (a tensor or
        an int)."""
        if self.world == 1:
            return g * 0, g
        n_env = self.num_envs
        n_loc = n_env // self.world
        e = g % n_env
        return e // n_loc, (g // n_env) * n_loc + e % n_loc

    def owned(self, g: torch.Tensor) -> Optional[torch.Tensor]:
        """bool mask of the global slots ``g`` this rank stores; None on
        one process (all of them)."""
        if self.world == 1:
            return None
        return self.global_to_local(g)[0] == self.rank

    def _local(self, g):
        return self.global_to_local(g)[1]

    def _to_global(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's local ``x`` [capacity/W, ...] gathered in the global
        slot order [capacity, ...] (a collective under a mesh)."""
        if self.world == 1:
            return x
        from ..parallel.mesh import all_gather

        n_loc = self.num_envs // self.world
        rows = all_gather(self.mesh, x).view(
            self.world, self.capacity // self.num_envs, n_loc, *x.shape[1:])
        return rows.transpose(0, 1).reshape(self.capacity, *x.shape[1:])

    def _from_global(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [capacity/W, ...] of a global-order ``x``."""
        if self.world == 1:
            return x
        n_loc = self.num_envs // self.world
        rows = x.reshape(self.capacity // self.num_envs, self.world, n_loc,
                         *x.shape[1:])
        return rows[:, self.rank].reshape(-1, *x.shape[1:])

    def add_fields(self, cols, cur, nxt, ll, ml, rot, col, reward, done,
                   n_cols, n_cur, n_nxt, n_ll, n_ml, n_st) -> None:
        """Contiguous write of this rank's N/W transitions at the ring head
        (all N on one process)."""
        n = rot.shape[0]
        step = n * self.world
        if self.capacity % step:
            raise ValueError(
                f"replay capacity ({self.capacity}) must be a multiple of the "
                f"per-step batch ({step}) for wrap-free contiguous writes"
            )
        if self.mesh is not None and step != self.num_envs:
            raise ValueError(f"a step writes {n} transitions per rank; the "
                             f"ring expects {self.num_envs // self.world}")
        vals = (cols, cur, nxt, ll, ml, rot, col, reward, done,
                n_cols, n_cur, n_nxt, n_ll, n_ml, n_st)
        at = self.pos // self.world
        for buf, val in zip(self.buf.values(), vals):
            buf[at:at + n].copy_(val)
        self.priority[at:at + n].copy_(self.max_prio.expand(n))
        self.pos = (self.pos + step) % self.capacity
        self.size = min(self.size + step, self.capacity)

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
        (``j`` or ``idx0``) instead of drawn from ``generator``. Indices
        are global slots; under a mesh every rank draws the same ones from
        the priorities of every rank, and reads the rows at their local
        slots (:meth:`owned` says which rows are its own).

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
            logp = alpha * torch.log(self._to_global(self.priority).clamp(min=1e-12))
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
        loc0 = self._local(idx0)
        if n_step == 1:
            loc_last, reward, done, discount = (
                loc0, b["reward"][loc0], b["done"][loc0], None)
        else:
            ks = torch.arange(n_step, device=dev)
            loc = self._local(torch.remainder(
                idx0[:, None] + ks[None, :] * step_gap, cap))
            rew, dn = b["reward"][loc], b["done"][loc]
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
            loc_last = loc.gather(1, k_star[:, None])[:, 0]
            done = dn.gather(1, k_star[:, None])[:, 0]
            discount = powers[k_star + 1]
        obs = obs_from_fields(b["cols"][loc0], b["cur"][loc0], b["nxt"][loc0],
                              b["lines_left"][loc0], b["moves_left"][loc0],
                              torch.zeros_like(b["cur"][loc0]))
        next_obs = obs_from_fields(
            b["n_cols"][loc_last], b["n_cur"][loc_last], b["n_nxt"][loc_last],
            b["n_lines_left"][loc_last], b["n_moves_left"][loc_last],
            b["n_status"][loc_last])
        batch = Batch(obs=obs, rot=b["rot"][loc0].long(),
                      col=b["col"][loc0].long(), reward=reward,
                      next_obs=next_obs, done=done, discount=discount,
                      weight=weight)
        return batch, idx0

    def update_priority(self, idx: torch.Tensor, td_abs: torch.Tensor,
                        eps: float) -> None:
        """Write ``|td| + eps`` back at the sampled slots and raise
        ``max_prio``. Where a slot was sampled more than once the last
        occurrence wins: every occurrence writes the value of the last one,
        so the result does not depend on the order of the scatter (CUDA's
        ``index_put_`` keeps an unspecified one of the duplicates).

        Under a mesh ``idx`` and ``td_abs`` are the whole batch's, the same
        on every rank (the learner's all-reduce gives each rank every
        row's ``|td|``), so ``max_prio`` needs no collective of its own.
        A rank writes only the slots it owns; a row of another rank that
        maps to the same local slot writes the value that slot gets."""
        new_p = td_abs.float() + eps
        loc = self._local(idx)
        same = loc[:, None] == loc[None, :]
        owned = self.owned(idx)
        if owned is not None:
            same = same & owned[None, :]
        pos = torch.arange(idx.shape[0], device=idx.device)
        last = torch.where(same, pos[None, :], -1).max(dim=1).values
        if owned is None:
            self.priority[loc] = new_p[last]
        else:
            self.priority[loc] = torch.where(
                last >= 0, new_p[last.clamp(min=0)], self.priority[loc])
        torch.maximum(self.max_prio, new_p.max(), out=self.max_prio)

    def state_dict(self) -> dict:
        """The ring in the global slot order (gathered from every rank under
        a mesh, a collective), so a checkpoint loads on any mesh size."""
        return {"buf": {k: self._to_global(v) for k, v in self.buf.items()},
                "pos": self.pos, "size": self.size,
                "priority": self._to_global(self.priority),
                "max_prio": self.max_prio}

    def load_state_dict(self, sd: dict) -> None:
        """Load a global-order ring (:meth:`state_dict`); under a mesh this
        rank keeps its own slots."""
        for name, buf in self.buf.items():
            buf.copy_(self._from_global(sd["buf"][name]))
        self.pos, self.size = int(sd["pos"]), int(sd["size"])
        if "priority" in sd:
            self.priority.copy_(self._from_global(sd["priority"]))
            self.max_prio.copy_(sd["max_prio"])
        else:
            # a buffer saved before priorities were kept: every written slot
            # (a ring that has not wrapped is written from slot 0) at the
            # initial max priority, as the JAX buffer writes them
            prio = torch.zeros((self.capacity,), dtype=torch.float32)
            prio[:self.size] = 1.0
            self.priority.copy_(self._from_global(prio))
            self.max_prio.fill_(1.0)
