"""Checkpoint / resume of the training state and the bank (torch.save).

Counterpart of ``tetris_piclim_tpu/utils/checkpoint.py`` (orbax there): the
full TrainState (online and target weights, optimizer moments, replay ring,
env states, generator states, counters) goes to ``<path>/state.pt``, and
the live bank rows and their families to ``<path>/bank.pt``, so a run
resumes exactly where it stopped and an evaluation sees the bank training
ended on.

A state laid out on a data-parallel mesh (``parallel/mesh.py``) is written
in the one-process layout: every rank's env slice and local ring are
gathered (a collective, so every rank calls :func:`save_train_state`) and
rank 0 writes them. :func:`restore_train_state` reads the file on rank 0
and hands every rank its part. So a checkpoint restores on any mesh size,
one process included.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..gen.bank import ConfigBank
from ..parallel.mesh import all_gather, barrier, batch_sharding


def save_train_state(path: str, state) -> str:
    """Write ``state`` (a ``dqn.train.TrainState``) to ``<path>/state.pt``."""
    mesh = state.mesh
    env = state.env._asdict()
    if mesh is not None:
        env = {k: all_gather(mesh, v).flatten(0, 1) for k, v in env.items()}
    sd = {
        "net": state.net.state_dict(),
        "target_net": state.target_net.state_dict(),
        "opt": state.opt.state_dict(),
        "replay": state.replay.state_dict(),
        "env": env,
        "gen": state.gen.get_state(),
        "host_gen": state.host_gen.get_state(),
        "global_step": state.global_step,
        "updates_done": state.updates_done,
    }
    out = os.path.join(path, "state.pt")
    if mesh is None or mesh.is_root:
        os.makedirs(path, exist_ok=True)
        torch.save(sd, out)
    if mesh is not None:
        barrier(mesh)
    return out


def _load(path: str, name: str, device) -> dict:
    if os.path.isdir(path):
        path = os.path.join(path, name)
    return torch.load(path, map_location=device, weights_only=True)


def restore_train_state(path: str, state) -> None:
    """Load :func:`save_train_state` output into ``state`` in place (same
    config shape: num_envs, replay capacity, model; any mesh size)."""
    dev = state.replay.device
    mesh = state.mesh
    if mesh is None:
        sd = _load(path, "state.pt", dev)
    else:
        # rank 0 reads; the others need not see the file
        box = [_load(path, "state.pt", "cpu") if mesh.is_root else None]
        if mesh.active:
            dist.broadcast_object_list(box, src=mesh.src, group=mesh.group,
                                       device=mesh.device)
        sd = box[0]
    state.net.load_state_dict(sd["net"])
    state.target_net.load_state_dict(sd["target_net"])
    state.opt.load_state_dict(sd["opt"])
    state.replay.load_state_dict(sd["replay"])
    take = (lambda x: x) if mesh is None else batch_sharding(mesh)
    state.env = type(state.env)(**{k: take(v).to(dev).contiguous()
                                   for k, v in sd["env"].items()})
    state.gen.set_state(sd["gen"].cpu())
    state.host_gen.set_state(sd["host_gen"].cpu())
    state.global_step = int(sd["global_step"])
    state.updates_done = int(sd["updates_done"])


def restore_params(path: str, device) -> tuple[dict, dict]:
    """Only the (online, target) network state_dicts of a checkpoint."""
    sd = _load(path, "state.pt", device)
    return sd["net"], sd["target_net"]


def save_bank(path: str, bank: ConfigBank) -> str:
    """Write the bank's live rows and their families to ``<path>/bank.pt``."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "bank.pt")
    torch.save({"cols": bank.cols, "pieces": bank.pieces,
                "family": torch.as_tensor(bank.family),
                "L": bank.L, "M": bank.M}, out)
    return out


def restore_bank(path: str, device) -> ConfigBank:
    """A bank from :func:`save_bank` output (the directory or the file); a
    file written without ``family`` gives carve-family rows."""
    sd = _load(path, "bank.pt", device)
    family = sd.get("family")
    return ConfigBank.from_rows(
        sd["L"], sd["M"], sd["cols"], sd["pieces"],
        None if family is None else family.cpu().numpy())
