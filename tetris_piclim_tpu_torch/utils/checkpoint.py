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

:func:`load_flax_npz` reads the weights of a JAX run written out as numpy
(``tools/tpu_checkpoint.py``: flax paths as keys), so a policy trained by
the JAX package loads into the port with no JAX. :func:`save_policy_npz`
writes a policy trained by the port, with the bank rows it was evaluated
on and the results, to one ``.npz`` that numpy alone reads
(``tools/flagship_policy.py``); :func:`read_policy_npz` reads it back.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..gen.bank import ConfigBank
from ..models.qnet import params_from_flax
from ..ops.bitboard import pack_board, unpack_board
from ..parallel.mesh import all_gather, barrier, batch_sharding
from .device import resolve_device


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


def read_flax_npz(path: str) -> dict:
    """The nested parameter trees of an ``.npz`` whose keys are flax paths
    (``params/params/Dense_0/kernel``, ...), as numpy arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    return tree


def load_flax_npz(path: str, device) -> tuple[dict, dict]:
    """The (online, target) ``QNetwork`` state_dicts of an ``.npz`` holding
    a JAX train state's two parameter trees under their flax paths
    (``params/...`` and ``target_params/...``; :func:`read_flax_npz`),
    converted by ``params_from_flax``."""
    tree = read_flax_npz(path)
    return tuple({k: v.to(device) for k, v in params_from_flax(tree[name]).items()}
                 for name in ("params", "target_params"))


def save_bank(path: str, bank: ConfigBank) -> str:
    """Write the bank's live rows and their families to ``<path>/bank.pt``."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "bank.pt")
    torch.save({"cols": bank.cols, "pieces": bank.pieces,
                "family": torch.as_tensor(bank.family),
                "L": bank.L, "M": bank.M}, out)
    return out


def restore_bank(path: str, device="cuda") -> ConfigBank:
    """A bank from :func:`save_bank` output (the directory or the file); a
    file written without ``family`` gives carve-family rows."""
    sd = _load(path, "bank.pt", resolve_device(device))
    family = sd.get("family")
    return ConfigBank.from_rows(
        sd["L"], sd["M"], sd["cols"], sd["pieces"],
        None if family is None else family.cpu().numpy())


def save_policy_npz(path: str, net_sd: dict, banks: dict, meta: dict) -> str:
    """Write a policy and its evaluation rows to one ``.npz``: the online
    net's state_dict under ``net/<name>`` (float32), each bank of ``banks``
    (name -> :class:`ConfigBank`) as ``<name>_boards`` (bool[N, 20, 10]),
    ``<name>_pieces`` (int8[N, M+1]) and ``<name>_family`` (int8[N]), and
    ``meta`` (with the task's ``L`` and ``M``) as a JSON string."""
    arrays = {f"net/{k}": v.detach().cpu().float().numpy() for k, v in net_sd.items()}
    for name, bank in banks.items():
        arrays[f"{name}_boards"] = unpack_board(bank.cols).cpu().numpy()
        arrays[f"{name}_pieces"] = bank.pieces.cpu().numpy().astype(np.int8)
        arrays[f"{name}_family"] = np.asarray(bank.family, dtype=np.int8)
    arrays["meta"] = np.array(json.dumps(meta))
    np.savez_compressed(path, **arrays)
    return path


def read_policy_npz(path: str, device="cpu") -> dict:
    """:func:`save_policy_npz` output: ``{"net": state_dict, "banks":
    {name: ConfigBank}, "meta": dict}``, tensors on ``device``."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        net = {k[4:]: torch.as_tensor(z[k], device=device)
               for k in z.files if k.startswith("net/")}
        banks = {}
        for key in z.files:
            if key.endswith("_boards"):
                name = key[:-len("_boards")]
                cols = pack_board(torch.as_tensor(z[key], device=device))
                banks[name] = ConfigBank.from_rows(
                    meta["L"], meta["M"], cols,
                    torch.as_tensor(z[f"{name}_pieces"], device=device),
                    z[f"{name}_family"])
    return {"net": net, "banks": banks, "meta": meta}


def is_policy_npz(path: str) -> bool:
    """Whether an ``.npz`` is :func:`save_policy_npz` output (else a JAX
    run's flax parameters)."""
    with np.load(path) as z:
        return "meta" in z.files
