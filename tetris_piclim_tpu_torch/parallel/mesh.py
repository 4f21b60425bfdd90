"""A 1-D data-parallel mesh over processes, and the layout of the trainer
on it.

Counterpart of ``tetris_piclim_tpu/parallel/mesh.py``. The JAX mesh is a
set of devices under GSPMD: envs and the replay ring are sharded along
their leading axis, weights and bank replicated, and XLA inserts one
gradient all-reduce per update. Here each rank is one process on one
device, and the same layout is kept by hand:

* rank ``r`` of ``W`` holds envs ``[r N/W, (r+1) N/W)`` and their
  transitions, in a local ring of ``capacity / W`` slots
  (``dqn/replay.py``: global slot ``t N + e`` is local slot
  ``t N/W + e mod N/W`` on rank ``e // (N/W)``, a bijection);
* weights, target, optimizer state, generators and the bank are the same
  on every rank: rank 0's are broadcast at the start and after each bank
  refresh;
* every rank draws the same global random numbers and keeps its slice, so
  the training chunk computes what one process computes;
* one all-reduce per learner update carries the gradients (and the loss
  terms), one per chunk the chunk's counts.

A mesh may span the first n ranks of a larger group (``make_mesh(n)``, as
JAX's takes the first n devices): its collectives then run over a group of
their own, and the other ranks get no mesh.

Divisibility contracts: ``num_envs`` and ``replay_capacity`` must be
multiples of the mesh size (checked in :func:`shard_train_state`, with
JAX's message).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from .distributed import process_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group along one axis (``"dp"``). ``active``
    is False for the one-process mesh, whose collectives do nothing.
    ``group`` is the process group (None: the default group); ``rank`` is
    this process's rank within it."""
    rank: int
    size: int
    device: torch.device
    axis: str = "dp"
    active: bool = False
    group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    @property
    def src(self) -> int:
        """The global rank of the group's rank 0, which broadcasts."""
        return 0 if self.group is None else dist.get_global_rank(self.group, 0)


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device="cuda") -> Optional[Mesh]:
    """The mesh of the first ``n_devices`` processes of the default group
    (all of them by default; one process alone: a one-rank mesh), as JAX
    takes the first n devices. Fewer ranks than the group: every rank of
    the group must call this (``dist.new_group`` is collective), ranks
    ``[0, n)`` get a mesh over the new group and the others get None.
    Asking for more ranks than the group has raises as JAX does."""
    active = dist.is_initialized()
    world = dist.get_world_size() if active else 1
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n == world:
        return Mesh(rank=dist.get_rank() if active else 0, size=world,
                    device=process_device(device), axis=axis, active=active)
    group = dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return Mesh(rank=dist.get_rank(group), size=n, device=process_device(device),
                axis=axis, active=True, group=group)


# -- collectives (no-ops on a one-process mesh) ---------------------------------

STAGED = {"broadcasts": 0}   # broadcasts that went through the mesh's device


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place sum (or ``"max"``) of ``t`` over the ranks."""
    if mesh.active:
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=mesh.group)
    return t


def broadcast(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` into every rank's ``t``, in place. A tensor on the
    CPU goes through the mesh's device when that is a GPU (NCCL carries
    only device memory); ``STAGED`` counts those."""
    if not mesh.active:
        return t
    if t.device == mesh.device:
        dist.broadcast(t, mesh.src, group=mesh.group)
        return t
    STAGED["broadcasts"] += 1
    staged = t.to(mesh.device)
    dist.broadcast(staged, mesh.src, group=mesh.group)
    t.copy_(staged)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``[W, *t.shape]``: every rank's ``t`` in rank order."""
    if not mesh.active:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.stack(parts)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh."""
    if mesh.active:
        dist.barrier(group=mesh.group)


# -- layout -------------------------------------------------------------------------

def replicate(mesh: Mesh, tensors):
    """Broadcast rank 0's values into every rank's, in place: a module (its
    parameters and buffers) or an iterable of tensors. Returns the
    argument."""
    items = tensors.state_dict().values() if isinstance(tensors, nn.Module) else tensors
    with torch.no_grad():
        for t in items:
            broadcast(mesh, t)
    return tensors


def batch_sharding(mesh: Mesh):
    """A function that gives this rank's slice of a leading axis (which
    must be a multiple of the mesh size)."""
    def take(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"leading axis ({n}) must be divisible by mesh "
                             f"size {mesh.size}")
        k = n // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k]
    return take


def shard_bank(mesh: Mesh, bank):
    """The bank is replicated: rank 0's rows and families go to every rank
    (each rank resets from any row with a local gather, so the reset path
    needs no collective). Every rank's bank must hold rows of the same
    shape. Rank 0's bank lock is held throughout, so rows that its
    producers (``ConfigBank.start_refresh``) swap in meanwhile wait for the
    next call. Returns the bank."""
    if not mesh.active:
        return bank
    with bank._lock:
        cols, pieces = bank.rows
        cols, pieces = cols.contiguous(), pieces.contiguous()
        replicate(mesh, (cols, pieces))
        family = torch.as_tensor(bank.family).to(mesh.device)
        broadcast(mesh, family)
        bank.rows = (cols, pieces)
        bank.family[:] = family.cpu().numpy()
    return bank


def replicate_ints(mesh: Mesh, values: Iterable[int]) -> list[int]:
    """Rank 0's host ints, on every rank."""
    t = torch.tensor(list(values), dtype=torch.int64, device=mesh.device)
    return [int(v) for v in broadcast(mesh, t).tolist()]


def shard_train_state(mesh: Mesh, ts):
    """Lay out a one-process ``TrainState`` (``dqn/train.py``) on the mesh,
    in place: this rank's env slice, a local ring holding this rank's
    transitions of the global ring, and rank 0's weights, target,
    optimizer state, generators and counters everywhere. Returns ``ts``."""
    from ..dqn.replay import ReplayBuffer

    n = mesh.size
    num_envs = ts.env.status.shape[0]
    cap = ts.replay.capacity
    if num_envs % n or cap % n:
        raise ValueError(
            f"num_envs ({num_envs}) and replay_capacity ({cap}) must be "
            f"divisible by mesh size {n}")
    if ts.replay.mesh is not None:
        raise ValueError("the train state is already laid out on a mesh")
    take = batch_sharding(mesh)
    ts.env = type(ts.env)(*[take(f).contiguous() for f in ts.env])
    ring = ReplayBuffer(cap, mesh.device, mesh=mesh, num_envs=num_envs)
    ring.load_state_dict(ts.replay.state_dict())
    ts.replay = ring
    replicate(mesh, ts.net)
    replicate(mesh, ts.target_net)
    replicate(mesh, ts.opt.mu + ts.opt.nu + ts.opt.nu_max)
    for g in (ts.gen, ts.host_gen):
        g.set_state(broadcast(mesh, g.get_state()))
    ts.opt.count, ts.global_step, ts.updates_done = replicate_ints(
        mesh, (ts.opt.count, ts.global_step, ts.updates_done))
    ts.mesh = mesh
    return ts
