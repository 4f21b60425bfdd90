"""Actor and learner math for the DQN.

Counterpart of ``tetris_piclim_tpu/dqn/agent.py``: epsilon-greedy with
exponential decay, replay-sampled Huber TD updates (double DQN by default;
1-step or n-step, uniform or prioritized), AdamW with amsgrad in optax's
order, a Polyak-averaged target network (reference model/train.py:8-27),
and the demonstration split of the batch with the DQfD margin term.

The optimizers are written out by hand. ``optax.scale_by_amsgrad``
(:class:`AmsgradW`) keeps the running max of the *bias-corrected* second
moment, while ``torch.optim.AdamW(amsgrad=True)`` keeps the max of the raw
moment and corrects afterwards, which is a different update. The JAX
package's bf16-moment variant (:class:`AmsgradBf16`) is the latter kind.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine import RUNNING
from ..models.qnet import NUM_COL, NUM_ROT, q_ops
from ..ops.actor import epsilon
from ..utils.config import DQNConfig, EnvConfig
from .replay import Batch, ReplayBuffer, cat_batches


def env_reward(env: EnvConfig, lines_delta: torch.Tensor, done: torch.Tensor,
               won: torch.Tensor) -> torch.Tensor:
    """float32[N] reward of a step: ``reward_per_line`` per line cleared,
    plus ``win_reward`` on a win or ``loss_reward`` on a loss (the
    reference defines no reward; the JAX trainers' shaping)."""
    lost = done & ~won
    return (lines_delta.float() * env.reward_per_line
            + won.float() * env.win_reward + lost.float() * env.loss_reward)


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


@torch.no_grad()
def greedy_rollout(net: nn.Module, env, n_steps: int, backend):
    """The greedy policy for ``n_steps`` steps on ``backend``
    (``ops.bitboard`` or ``engine``), finished envs frozen: the evaluation
    rollout of both trainers. Returns the final state."""
    for _ in range(n_steps):
        q = net(backend.observe(env))
        rot, col = q_ops(q.shape[-1]).greedy(q)
        res = backend.step(env, rot, col)
        env = backend.state_where(env.status != RUNNING, env, res.state)
    return env


def td_loss(net: nn.Module, target_net: nn.Module, batch: Batch,
            cfg: DQNConfig, mask: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, dict]:
    """Huber TD loss (mean over the batch, each sample scaled by its
    importance weight under PER) on the online net's Q.

    ``double_dqn`` selects next actions with the online net and evaluates
    them with the target net; otherwise the max over the target net. The
    bootstrap is discounted by ``batch.discount`` (gamma^(k*+1) for n-step
    batches), else by ``cfg.gamma``.

    ``mask`` (float32[B], 0 or 1) keeps the rows this rank owns on a mesh:
    the loss, ``q_mean`` and ``td_abs`` are then this rank's share of the
    batch's, sums over its rows divided by the whole batch size B, and
    ``td_abs_per_sample`` is 0 on the other rows. The mean is always taken
    as a sum over B, so one process and a one-rank mesh give the same
    bits."""
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
        disc = cfg.gamma if batch.discount is None else batch.discount
        target = batch.reward + disc * (1.0 - batch.done.float()) * next_val
    td_abs = (q_chosen - target).detach().abs()
    q_out = q_chosen.detach()
    per_sample = F.huber_loss(q_chosen, target, reduction="none",
                              delta=cfg.huber_delta)
    if batch.weight is not None:
        per_sample = batch.weight * per_sample
    if mask is not None:
        per_sample, td_abs, q_out = per_sample * mask, td_abs * mask, q_out * mask
    n = per_sample.shape[0]
    loss = per_sample.sum() / n
    aux = {
        "loss": loss.detach(),
        "q_mean": q_out.sum() / n,
        "td_abs": td_abs.sum() / n,
        "td_abs_per_sample": td_abs,
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

    state_dtype = torch.float32

    def __init__(self, params, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        self.params = list(params)
        self.lr, self.wd = lr, weight_decay
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.count = 0
        zeros = lambda: [torch.zeros_like(p, dtype=self.state_dtype)  # noqa: E731
                         for p in self.params]
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


class AmsgradBf16(AmsgradW):
    """The JAX package's ``scale_by_amsgrad_bf16`` in the same optax chain:
    AMSGrad whose moments (mu, nu, nu_max) are stored in bfloat16.

    Arithmetic is float32; only the stores round (to nearest even, as
    ``Tensor.copy_`` into a bf16 buffer does). Unlike :class:`AmsgradW` the
    running max is of the raw second moment, corrected afterwards:

        mu = b1 mu + (1-b1) g;   nu = b2 nu + (1-b2) g g
        nu_max = max(nu_max, nu)
        p += -lr * ((mu / c1) / (sqrt(nu_max / c2 + eps_root) + eps) + wd p)

    with ``c1 = 1 - b1^t`` and ``c2 = 1 - b2^t`` in float32."""

    state_dtype = torch.bfloat16

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        c1 = float(1.0 - f32(self.b1) ** self.count)
        c2 = float(1.0 - f32(self.b2) ** self.count)
        for p, mu, nu, nu_max in zip(self.params, self.mu, self.nu, self.nu_max):
            g = p.grad.float()
            mu_f = self.b1 * mu.float() + (1.0 - self.b1) * g
            nu_f = self.b2 * nu.float() + (1.0 - self.b2) * g * g
            nu_max_f = torch.maximum(nu_max.float(), nu_f)
            u = (mu_f / c1) / ((nu_max_f / c2 + self.eps_root).sqrt() + self.eps)
            p.add_(u + self.wd * p, alpha=-self.lr)
            mu.copy_(mu_f)
            nu.copy_(nu_f)
            nu_max.copy_(nu_max_f)


def make_optimizer(net: nn.Module, cfg: DQNConfig) -> AmsgradW:
    """AdamW with amsgrad (reference model/train.py:27; decoupled weight
    decay 1e-2, the torch AdamW default); ``cfg.opt_state_bf16`` gives the
    bf16-moment variant."""
    cls = AmsgradBf16 if cfg.opt_state_bf16 else AmsgradW
    return cls(net.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)


def per_beta_schedule(step: int, cfg: DQNConfig, total_steps: int) -> float:
    """The PER importance exponent, annealed linearly from ``per_beta`` to
    1 over ``per_beta_steps`` env steps (0: ``total_steps``, the config's
    run length), in float32 as the JAX schedule computes it."""
    f32 = np.float32
    if not cfg.per_beta_anneal:
        return float(f32(cfg.per_beta))
    horizon = cfg.per_beta_steps if cfg.per_beta_steps > 0 else total_steps
    frac = min(f32(step) / f32(max(horizon, 1)), f32(1.0))
    return float(f32(cfg.per_beta) + f32(1.0 - cfg.per_beta) * frac)


@torch.no_grad()
def polyak(target_net: nn.Module, net: nn.Module, tau: float) -> None:
    """target <- tau * online + (1 - tau) * target (TAU=0.005), in place."""
    for t, p in zip(target_net.parameters(), net.parameters()):
        t.mul_(1.0 - tau).add_(p * tau)


def _all_reduce_update(mesh, params: list, aux: dict) -> None:
    """One all-reduce (sum) over the ranks of every gradient and the loss
    terms, in one flat float32 buffer: afterwards each rank holds the
    gradient of the whole batch's loss, and ``aux`` the whole batch's."""
    from ..parallel.mesh import all_reduce

    keys = ("loss", "q_mean", "td_abs", "td_abs_per_sample")
    parts = [p.grad.reshape(-1) for p in params] + [aux[k].reshape(-1) for k in keys]
    flat = all_reduce(mesh, torch.cat(parts))
    at = 0
    for p in params:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
        at += p.numel()
    for k in keys:
        n = aux[k].numel()
        aux[k] = flat[at:at + n].view_as(aux[k])
        at += n


def learner_update(net: nn.Module, target_net: nn.Module, opt: AmsgradW,
                   rpl: ReplayBuffer, cfg: DQNConfig, *,
                   step_gap: int = 1, beta: Optional[float] = None,
                   j: Optional[torch.Tensor] = None,
                   idx0: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   demo: Optional[ReplayBuffer] = None, demo_n: int = 0,
                   demo_j: Optional[torch.Tensor] = None,
                   demo_margin: float = 0.0,
                   demo_margin_weight: float = 1.0) -> dict:
    """One replay-sampled TD update + Polyak target step, in place; under
    PER the new ``|td|`` priorities are written back.

    The sample follows ``cfg`` (1-step or n-step, uniform or prioritized);
    ``step_gap`` is the ring stride between consecutive transitions of one
    env (num_envs). ``j`` gives a uniform draw's offsets and ``idx0`` any
    draw's base slots (as :meth:`ReplayBuffer.sample_ext` takes them);
    without them the draw comes from ``generator``.

    With ``demo`` and ``demo_n > 0``, ``demo_n`` of the ``cfg.batch_size``
    rows are a uniform 1-step sample of the demonstration buffer (offsets
    ``demo_j``), after the env rows. ``demo_margin > 0`` adds the DQfD
    large-margin term on them (Hester et al. 2018, eq. 2),
    ``mean(max_a [Q(s,a) + margin [a != a_E]] - Q(s, a_E))`` times
    ``demo_margin_weight``, from one more forward of the demo observations.

    On a mesh (the ring's, ``rpl.mesh``) every rank draws the same global
    batch and computes every row, but counts only the rows it owns; the
    demonstration rows and the margin term (the demo buffer is the same on
    every rank) count on rank 0. One all-reduce sums the gradients, so each
    rank steps with the gradient of the whole batch's mean loss, as JAX's
    GSPMD learner does, and the weights stay equal on every rank.

    Returns the loss terms as device tensors (no host sync), each the
    whole batch's; ``loss`` is the TD loss alone."""
    mesh = rpl.mesh
    demo_on = demo is not None and demo_n > 0
    n_env = cfg.batch_size - demo_n if demo_on else cfg.batch_size
    batch, idx0 = rpl.sample_ext(
        n_env, gamma=cfg.gamma, n_step=cfg.n_step, step_gap=step_gap,
        prioritized=cfg.prioritized, alpha=cfg.per_alpha,
        beta=cfg.per_beta if beta is None else beta, j=j, idx0=idx0,
        generator=generator)
    owned = rpl.owned(idx0)
    mask = None if owned is None else owned.float()
    root = mesh is None or mesh.is_root
    if demo_on:
        demo_batch = demo.sample(demo_n, j=demo_j, generator=generator)
        batch = cat_batches(batch, demo_batch, cfg.gamma)
        if mask is not None:
            mask = torch.cat([mask, torch.full((demo_n,), float(root),
                                               device=mask.device)])
    opt.zero_grad()
    loss, aux = td_loss(net, target_net, batch, cfg, mask)
    if demo_on and demo_margin > 0.0:
        q_d = net(demo_batch.obs)
        ops = q_ops(q_d.shape[-1])
        j_e = (ops.margin_max(q_d, demo_batch.rot, demo_batch.col, demo_margin)
               - ops.gather(q_d, demo_batch.rot, demo_batch.col)).mean()
        aux["demo_margin_loss"] = j_e.detach()
        if root:
            loss = loss + demo_margin_weight * j_e
    loss.backward()
    if mesh is not None:
        _all_reduce_update(mesh, opt.params, aux)
    opt.step()
    polyak(target_net, net, cfg.tau)
    if cfg.prioritized:
        rpl.update_priority(idx0, aux["td_abs_per_sample"][:n_env], cfg.per_eps)
    return aux
