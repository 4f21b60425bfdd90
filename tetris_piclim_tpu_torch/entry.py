"""One forward step of the flagship model, with example arguments.

Counterpart of ``__graft_entry__.py::entry`` (the JAX package's entry
point), exactly as wide: the conv torso with dueling and the 40-way joint
head, epsilon-greedy at epsilon 0.05, and one lockstep env step of 256 envs
on empty boards at L=2/M=20. It runs the torso and the packed step in plain
PyTorch and no kernel of ``csrc/``, as JAX's runs XLA and no Pallas kernel.

JAX's ``forward_step(params, states, key)`` splits the key into the three
draws of ``dqn/agent.py::select_actions``; here they are arguments: the
explore uniforms (an env explores where its uniform is below epsilon) and
the random rotation and column it then takes.
"""

from __future__ import annotations

import sys
import types

import torch

from .dqn import agent as agent_lib
from .models.convnet import ConvQNetwork
from .models.qnet import NUM_COL, NUM_ROT
from .ops import bitboard
from .utils.device import resolve_device

NUM_ENVS = 256
EPSILON = 0.05


@torch.no_grad()
def forward_step(net, states: bitboard.PackedState, explore: torch.Tensor,
                 rand_rot: torch.Tensor, rand_col: torch.Tensor):
    """Observe, epsilon-greedy on ``net`` with the given draws, step every
    env. Returns (new state, lines cleared in all, episodes ended)."""
    obs = bitboard.observe_batch(states)
    rot, col = agent_lib.select_actions(net, obs, EPSILON, explore_u=explore,
                                        r_rot=rand_rot, r_col=rand_col)
    res = bitboard.step_batch(states, rot, col)
    return res.state, res.lines_delta.sum(), res.done.sum()


def entry(device="cuda", seed: int = 0):
    """``(forward_step, (net, states, explore, rand_rot, rand_col))`` with
    the flagship net initialised as flax does from ``torch.Generator``
    seed ``seed``, and the draws from a generator of the same seed, all on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    net = ConvQNetwork(dueling=True, joint=True,
                       generator=torch.Generator().manual_seed(seed)).to(dev)
    boards = torch.zeros((NUM_ENVS, 20, 10), dtype=torch.bool, device=dev)
    pieces = (torch.arange(21, dtype=torch.int8, device=dev) % 7).repeat(NUM_ENVS, 1)
    states = bitboard.make_state_batch(boards, pieces, 2, 20)
    gen = torch.Generator(device=dev).manual_seed(seed)
    explore = torch.rand((NUM_ENVS,), generator=gen, device=dev)
    rand_rot = torch.randint(0, NUM_ROT, (NUM_ENVS,), generator=gen, device=dev)
    rand_col = torch.randint(0, NUM_COL, (NUM_ENVS,), generator=gen, device=dev)
    return forward_step, (net, states, explore, rand_rot, rand_col)


class _CallableModule(types.ModuleType):
    """The package exports the function ``entry`` under this module's own
    name, and importing the module binds the module to that name; so the
    module calls the function."""

    def __call__(self, *args, **kwargs):
        return entry(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
