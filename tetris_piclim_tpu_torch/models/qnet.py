"""Q-network: the reference-declared MLP 217 -> 4x128 -> 14 (or 40).

Counterpart of ``tetris_piclim_tpu/models/qnet.py``. Observation: 200 board
cells + one-hot current and next piece + lines-left + moves-left + status.
Actions: 4 rotation and 10 column Q-values combined additively (the factored
14-way head), or ``joint=True`` for the 40-way head over (rot, col),
row-major ``a = rot * 10 + col``. ``dueling=True`` replaces the head with a
value head and an advantage head (:func:`dueling_combine`,
:func:`dueling_combine_joint`); the conv torso is ``models/convnet.py``.

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


def dueling_combine(v: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """Factored dueling Q from ``v[..., 1]`` and branch advantages
    ``adv[..., 14]``: each branch's advantages mean-centred, plus half the
    value, so ``Q(s,(r,c)) = V + Ar - mean(Ar) + Ac - mean(Ac)`` stays
    additive."""
    a_rot, a_col = adv[..., :NUM_ROT], adv[..., NUM_ROT:]
    half_v = v * 0.5
    a_rot = a_rot - a_rot.mean(dim=-1, keepdim=True) + half_v
    a_col = a_col - a_col.mean(dim=-1, keepdim=True) + half_v
    return torch.cat([a_rot, a_col], dim=-1)


def dueling_combine_joint(v: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """``Q(s,a) = V(s) + A(s,a) - mean_a A(s,a)`` for the 40-way head."""
    return v + adv - adv.mean(dim=-1, keepdim=True)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> None:
    """flax's default kernel init in place: a normal truncated at +-2
    sigma, scaled so that the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class QHead(nn.Module):
    """The Q head on a feature vector: one ``Linear`` to 14 or 40, or with
    ``dueling`` a value head (``value``) and an advantage head (``adv``).
    Always float32."""

    def __init__(self, width: int, joint: bool, dueling: bool,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.joint, self.dueling = joint, dueling
        out_dim = JOINT_DIM if joint else ACTION_DIM
        if dueling:
            self.value, self.adv = nn.Linear(width, 1), nn.Linear(width, out_dim)
            layers = (self.value, self.adv)
        else:
            self.out = nn.Linear(width, out_dim)
            layers = (self.out,)
        for layer in layers:
            lecun_normal_(layer.weight, width, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.dueling:
            return self.out(x)
        combine = dueling_combine_joint if self.joint else dueling_combine
        return combine(self.value(x), self.adv(x))


class QNetwork(nn.Module):
    """MLP 217 -> hidden -> head; ReLU between layers, float32. Built on
    the CPU (``generator`` is a CPU generator); move it with ``.to``.

    The plain net keeps all five layers in ``dense`` (the layout the fused
    actor reads); a dueling net keeps the four hidden layers there and its
    two heads in ``head``."""

    def __init__(self, joint: bool = False, dueling: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.joint, self.dueling = joint, dueling
        self.head_dim = JOINT_DIM if joint else ACTION_DIM
        widths = [OBS_DIM, *HIDDEN] + ([] if dueling else [self.head_dim])
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        for layer in self.dense:
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)
        # built after the dense layers, so a generator's draws come in
        # flax's order (Dense_4 is the value head)
        self.head = QHead(HIDDEN[-1], joint, True, generator) if dueling else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dueling:
            for layer in self.dense:
                x = torch.relu(layer(x))
            return self.head(x)
        for layer in self.dense[:-1]:
            x = torch.relu(layer(x))
        return self.dense[-1](x)


def dense_from_flax(d) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight [out, in], bias) of a flax ``Dense`` (kernel [in, out])."""
    return (torch.as_tensor(np.array(d["kernel"], dtype=np.float32).T.copy()),
            torch.as_tensor(np.array(d["bias"], dtype=np.float32)))


def head_from_flax(p, first: int, prefix: str, dueling: bool) -> dict:
    """State-dict entries of a Q head whose flax layers start at
    ``Dense_<first>``. In flax's compact call ``combine(nn.Dense(1)(x),
    nn.Dense(out)(x))`` the arguments are built left to right, so the value
    head is ``Dense_<first>`` and the advantage head the next one."""
    names = ("value", "adv") if dueling else ("out",)
    out = {}
    for k, name in enumerate(names):
        w, b = dense_from_flax(p[f"Dense_{first + k}"])
        out[f"{prefix}{name}.weight"], out[f"{prefix}{name}.bias"] = w, b
    return out


def params_from_flax(np_params) -> dict[str, torch.Tensor]:
    """A ``QNetwork`` state_dict from flax QNetwork params (numpy or jax
    arrays), plain or dueling (six Dense layers: value ``Dense_4``,
    advantage ``Dense_5``)."""
    p = np_params["params"] if "params" in np_params else np_params
    n_hidden = len(HIDDEN)
    dueling = len(p) == n_hidden + 2
    out = {}
    for i in range(n_hidden if dueling else len(p)):
        out[f"dense.{i}.weight"], out[f"dense.{i}.bias"] = dense_from_flax(
            p[f"Dense_{i}"])
    if dueling:
        out.update(head_from_flax(p, n_hidden, "head.", True))
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


def init_qnet(generator: torch.Generator | None = None,
              action_dim: int = ACTION_DIM) -> QNetwork:
    """A flax-initialised plain ``QNetwork`` with a head of ``action_dim``
    outputs (14, the factored head, or 40, the joint one), drawn from the
    CPU ``generator``. The JAX ``init_qnet(key, action_dim)`` returns the
    module and its parameter tree; a torch module holds its parameters, so
    this returns the module alone."""
    if action_dim not in (ACTION_DIM, JOINT_DIM):
        raise ValueError(f"Q head width {action_dim}: want {ACTION_DIM} or {JOINT_DIM}")
    return QNetwork(joint=action_dim == JOINT_DIM, generator=generator)
