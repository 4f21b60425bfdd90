"""Actor and learner math for the DQN.

Counterpart of ``tetris_piclim_tpu/dqn/agent.py``: epsilon-greedy with
exponential decay, replay-sampled Huber TD updates (double DQN by default),
AdamW with amsgrad in optax's order, and a Polyak-averaged target network
(reference model/train.py:8-27).

The optimizer is written out by hand. ``optax.scale_by_amsgrad`` keeps the
running max of the *bias-corrected* second moment, while
``torch.optim.AdamW(amsgrad=True)`` keeps the max of the raw moment and
corrects afterwards, which is a different update.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.qnet import NUM_COL, NUM_ROT, q_ops
from ..ops.actor import epsilon
from ..utils.config import DQNConfig
from .replay import Batch, ReplayBuffer


def check_supported(cfg: DQNConfig) -> None:
    """Raise on learner options the port has not ported yet."""
    if cfg.n_step != 1 or cfg.prioritized:
        raise NotImplementedError(
            "n-step returns and prioritized replay are not ported yet "
            "(ROADMAP.md, queue A)"
        )
    if cfg.opt_state_bf16:
        raise NotImplementedError(
            "bf16 optimizer moments are not ported yet (ROADMAP.md, queue A)"
        )


def eps_schedule(step: int, cfg: DQNConfig) -> float:
    """EPS_END + (EPS_START - EPS_END) * exp(-step / EPS_DECAY)
    (reference model/train.py:10-12, 17-19), in float32."""
    return float(epsilon(step, cfg.eps_start, cfg.eps_end, cfg.eps_decay))


@torch.no_grad()
def select_actions(net: nn.Module, obs: torch.Tensor, eps: float, *,
                   explore_u=None, r_rot=None, r_col=None,
                   generator: Optional[torch.Generator] = None):
    """Epsilon-greedy over (rotation, column) for either head. The draws
    (explore uniforms, random rot and col, each [N]) are inputs; those not
    given come from ``generator``."""
    n, dev = obs.shape[0], obs.device
    if explore_u is None:
        explore_u = torch.rand((n,), generator=generator, device=dev)
    if r_rot is None:
        r_rot = torch.randint(0, NUM_ROT, (n,), generator=generator, device=dev)
    if r_col is None:
        r_col = torch.randint(0, NUM_COL, (n,), generator=generator, device=dev)
    q = net(obs)
    g_rot, g_col = q_ops(q.shape[-1]).greedy(q)
    explore = explore_u < eps
    rot = torch.where(explore, r_rot.long(), g_rot).to(torch.int32)
    col = torch.where(explore, r_col.long(), g_col).to(torch.int32)
    return rot, col


def td_loss(net: nn.Module, target_net: nn.Module, batch: Batch,
            cfg: DQNConfig) -> tuple[torch.Tensor, dict]:
    """Huber TD loss (mean over the batch) on the online net's Q.

    ``double_dqn`` selects next actions with the online net and evaluates
    them with the target net; otherwise the max over the target net."""
    q = net(batch.obs)
    ops = q_ops(q.shape[-1])
    q_chosen = ops.gather(q, batch.rot, batch.col)
    with torch.no_grad():
        q_next_target = target_net(batch.next_obs)
        if cfg.double_dqn:
            a_rot, a_col = ops.greedy(net(batch.next_obs))
            next_val = ops.gather(q_next_target, a_rot, a_col)
        else:
            next_val = ops.max_value(q_next_target)
        target = batch.reward + cfg.gamma * (1.0 - batch.done.float()) * next_val
    td = q_chosen - target
    loss = F.huber_loss(q_chosen, target, delta=cfg.huber_delta)
    aux = {
        "loss": loss.detach(),
        "q_mean": q_chosen.detach().mean(),
        "td_abs": td.detach().abs().mean(),
    }
    return loss, aux


class AmsgradW:
    """optax ``chain(scale_by_amsgrad(), add_decayed_weights(wd),
    scale_by_learning_rate(lr))`` on a list of tensors, in optax's order:

        mu = (1-b1) g + b1 mu;   nu = (1-b2) g^2 + b2 nu
        mu_hat = mu / (1 - b1^t);  nu_hat = nu / (1 - b2^t)
        nu_max = max(nu_max, nu_hat)
        p += -lr * (mu_hat / (sqrt(nu_max + eps_root) + eps) + wd * p)
    """

    def __init__(self, params, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        self.params = list(params)
        self.lr, self.wd = lr, weight_decay
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu, self.nu, self.nu_max = zeros(), zeros(), zeros()

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        self.count += 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        c1 = float(1.0 - f32(self.b1) ** self.count)
        c2 = float(1.0 - f32(self.b2) ** self.count)
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu,
                                        self.nu_max):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            torch.maximum(nu_max, nu / c2, out=nu_max)
            u = (mu / c1) / ((nu_max + self.eps_root).sqrt() + self.eps)
            p.add_(u + self.wd * p, alpha=-self.lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu,
                "nu_max": self.nu_max}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for dst, src in ((self.mu, sd["mu"]), (self.nu, sd["nu"]),
                         (self.nu_max, sd["nu_max"])):
            for d, s in zip(dst, src):
                d.copy_(s)


def make_optimizer(net: nn.Module, cfg: DQNConfig) -> AmsgradW:
    """AdamW with amsgrad (reference model/train.py:27; decoupled weight
    decay 1e-2, the torch AdamW default)."""
    check_supported(cfg)
    return AmsgradW(net.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)


@torch.no_grad()
def polyak(target_net: nn.Module, net: nn.Module, tau: float) -> None:
    """target <- tau * online + (1 - tau) * target (TAU=0.005), in place."""
    for t, p in zip(target_net.parameters(), net.parameters()):
        t.mul_(1.0 - tau).add_(p * tau)


def learner_update(net: nn.Module, target_net: nn.Module, opt: AmsgradW,
                   rpl: ReplayBuffer, cfg: DQNConfig, *,
                   j: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> dict:
    """One replay-sampled TD update + Polyak target step, in place. ``j``
    [batch] are the sample offsets (drawn from ``generator`` when None).
    Returns the loss terms as device tensors (no host sync)."""
    batch = rpl.sample(cfg.batch_size, j=j, generator=generator)
    opt.zero_grad()
    loss, aux = td_loss(net, target_net, batch, cfg)
    loss.backward()
    opt.step()
    polyak(target_net, net, cfg.tau)
    return aux
