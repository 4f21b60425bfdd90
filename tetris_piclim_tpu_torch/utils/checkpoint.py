"""Checkpoint / resume of the training state and the bank (torch.save).

Counterpart of ``tetris_piclim_tpu/utils/checkpoint.py`` (orbax there): the
full TrainState (online and target weights, optimizer moments, replay ring,
env states, generator states, counters) goes to ``<path>/state.pt``, and
the live bank rows and their families to ``<path>/bank.pt``, so a run
resumes exactly where it stopped and an evaluation sees the bank training
ended on.
"""

from __future__ import annotations

import os

import torch

from ..gen.bank import ConfigBank


def save_train_state(path: str, state) -> str:
    """Write ``state`` (a ``dqn.train.TrainState``) to ``<path>/state.pt``."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "state.pt")
    torch.save({
        "net": state.net.state_dict(),
        "target_net": state.target_net.state_dict(),
        "opt": state.opt.state_dict(),
        "replay": state.replay.state_dict(),
        "env": state.env._asdict(),
        "gen": state.gen.get_state(),
        "host_gen": state.host_gen.get_state(),
        "global_step": state.global_step,
        "updates_done": state.updates_done,
    }, out)
    return out


def _load(path: str, name: str, device) -> dict:
    if os.path.isdir(path):
        path = os.path.join(path, name)
    return torch.load(path, map_location=device, weights_only=True)


def restore_train_state(path: str, state) -> None:
    """Load :func:`save_train_state` output into ``state`` in place (same
    config shape: num_envs, replay capacity, model)."""
    dev = state.replay.device
    sd = _load(path, "state.pt", dev)
    state.net.load_state_dict(sd["net"])
    state.target_net.load_state_dict(sd["target_net"])
    state.opt.load_state_dict(sd["opt"])
    state.replay.load_state_dict(sd["replay"])
    state.env = type(state.env)(**sd["env"])
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
