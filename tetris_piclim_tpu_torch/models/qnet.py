"""Q-network: the reference-declared MLP 217 -> 4x128 -> 14 (or 40).

Counterpart of ``tetris_piclim_tpu/models/qnet.py``. Observation: 200 board
cells + one-hot current and next piece + lines-left + moves-left + status.
Actions: 4 rotation and 10 column Q-values combined additively (the factored
14-way head), or ``joint=True`` for the 40-way head over (rot, col),
row-major ``a = rot * 10 + col``.

Initialization matches flax's ``nn.Dense`` default: ``lecun_normal`` weights
(a normal truncated at +-2 sigma, rescaled so the variance is 1/fan_in)
and zero biases. :func:`params_from_flax` carries flax weights across for
the tests.
"""

from __future__ import annotations

import math
import numpy as np
import torch
from torch import nn

from ..engine import OBS_DIM

NUM_ROT = 4
NUM_COL = 10
ACTION_DIM = NUM_ROT + NUM_COL  # 14
JOINT_DIM = NUM_ROT * NUM_COL   # 40
HIDDEN = (128, 128, 128, 128)   # reference model/model.py:9-13

# std of a unit normal truncated at +-2 (flax variance_scaling's constant)
_TRUNC_STD = 0.87962566103423978


class QNetwork(nn.Module):
    """MLP 217 -> hidden -> head; ReLU between layers, float32. Built on
    the CPU (``generator`` is a CPU generator); move it with ``.to``."""

    def __init__(self, joint: bool = False, dueling: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if dueling:
            raise NotImplementedError(
                "dueling heads are not ported yet (ROADMAP.md, queue A)"
            )
        self.joint = joint
        self.head_dim = JOINT_DIM if joint else ACTION_DIM
        widths = [OBS_DIM, *HIDDEN, self.head_dim]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in self.dense:
            fan_in = layer.in_features
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense[:-1]:
            x = torch.relu(layer(x))
        return self.dense[-1](x)


def params_from_flax(np_params) -> dict[str, torch.Tensor]:
    """A ``QNetwork`` state_dict from flax QNetwork params (numpy or jax
    arrays): flax ``Dense_i`` kernels are [in, out], torch weights
    [out, in]."""
    p = np_params["params"] if "params" in np_params else np_params
    out = {}
    for i in range(len(p)):
        d = p[f"Dense_{i}"]
        out[f"dense.{i}.weight"] = torch.as_tensor(
            np.array(d["kernel"], dtype=np.float32).T.copy())
        out[f"dense.{i}.bias"] = torch.as_tensor(
            np.array(d["bias"], dtype=np.float32))
    return out


def _argmax_first(q: torch.Tensor) -> torch.Tensor:
    """First index of the maximum on the last dim (jnp.argmax tie-break),
    stated explicitly so every backend breaks ties the same way."""
    n = q.shape[-1]
    lane = torch.arange(n, device=q.device)
    hit = q == q.max(dim=-1, keepdim=True).values
    return torch.where(hit, lane, n).min(dim=-1).values


class FactoredQ:
    """Helpers for the additive factored Q over (rotation, column)."""

    @staticmethod
    def split(q):
        return q[..., :NUM_ROT], q[..., NUM_ROT:]

    @staticmethod
    def greedy(q):
        q_rot, q_col = FactoredQ.split(q)
        return _argmax_first(q_rot), _argmax_first(q_col)

    @staticmethod
    def max_value(q):
        q_rot, q_col = FactoredQ.split(q)
        return q_rot.max(dim=-1).values + q_col.max(dim=-1).values

    @staticmethod
    def gather(q, rot, col):
        q_rot, q_col = FactoredQ.split(q)
        return (q_rot.gather(-1, rot.long()[..., None])[..., 0]
                + q_col.gather(-1, col.long()[..., None])[..., 0])

    @staticmethod
    def margin_max(q, rot, col, margin: float):
        """max over the 40 joint actions of ``Q(a) + margin * [a != a_E]``
        (DQfD large-margin term, Hester et al. 2018, eq. 2)."""
        q_rot, q_col = FactoredQ.split(q)
        joint = q_rot[..., :, None] + q_col[..., None, :]
        is_e = (nn.functional.one_hot(rot.long(), NUM_ROT).to(q.dtype)[..., :, None]
                * nn.functional.one_hot(col.long(), NUM_COL).to(q.dtype)[..., None, :])
        return (joint + margin * (1.0 - is_e)).amax(dim=(-2, -1))


class JointQ:
    """Helpers for the 40-way joint Q, row-major ``a = rot * 10 + col``."""

    @staticmethod
    def greedy(q):
        flat = _argmax_first(q)
        return flat // NUM_COL, flat % NUM_COL

    @staticmethod
    def max_value(q):
        return q.max(dim=-1).values

    @staticmethod
    def gather(q, rot, col):
        a = rot.long() * NUM_COL + col.long()
        return q.gather(-1, a[..., None])[..., 0]

    @staticmethod
    def margin_max(q, rot, col, margin: float):
        a = rot.long() * NUM_COL + col.long()
        is_e = nn.functional.one_hot(a, JOINT_DIM).to(q.dtype)
        return (q + margin * (1.0 - is_e)).max(dim=-1).values


def q_ops(q_dim: int):
    """The Q-helper class for a head width: 14 factored, 40 joint."""
    if q_dim == ACTION_DIM:
        return FactoredQ
    if q_dim == JOINT_DIM:
        return JointQ
    raise ValueError(f"unrecognized Q head width {q_dim} (expected 14 or 40)")
