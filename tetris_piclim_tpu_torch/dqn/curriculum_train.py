"""Curriculum DQN trainer: a (L, M) level per env, promoted by win rate.

Counterpart of ``tetris_piclim_tpu/dqn/curriculum_train.py``. One chunk
trains a mixed population: each env carries its own lines goal and move
limit and resets from the bank of its own level
(:func:`..gen.curriculum.step_autoreset_curriculum`); between chunks the
host promotes a fraction of the envs of every level whose win rate reached
the threshold (:func:`..gen.curriculum.promote_levels`, with the JAX
trainer's numpy generator, so the same win rates promote the same envs).

A chunk step: observe -> epsilon-greedy -> ``step_autoreset_curriculum`` ->
packed replay write -> ``updates_per_step`` learner updates once the replay
holds ``max(warmup, batch) + (n_step - 1) * num_envs`` transitions. The
per-level episode and win tallies are ``bincount``s on the device; the
chunk's loss is the mean over its steps of each step's mean update loss,
a step without updates counting 0, as the JAX chunk computes it. The host
waits on the device once per chunk.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..gen import curriculum as cur_lib
from ..models.qnet import QNetwork
from ..ops import bitboard
from ..utils.config import TrainConfig
from ..utils.device import resolve_device
from . import agent as agent_lib
from .replay import ReplayBuffer


@dataclasses.dataclass
class CurriculumState:
    net: nn.Module
    target_net: nn.Module
    opt: agent_lib.AmsgradW
    replay: ReplayBuffer
    env: bitboard.PackedState
    gen: torch.Generator     # device draws (actions, resets, samples)
    global_step: int = 0


class CurriculumTrainer:
    def __init__(self, levels: Sequence[tuple[int, int]],
                 cfg: Optional[TrainConfig] = None, seed: int = 0,
                 net: Optional[nn.Module] = None, device="cuda") -> None:
        self.device = resolve_device(device)
        self.levels = list(levels)
        self.cfg = cfg or TrainConfig()
        self.n_levels = len(self.levels)
        self.bank = cur_lib.build_curriculum_bank(
            self.levels, self.cfg.bank_capacity, seed=seed, device=self.device)
        self.level = np.zeros(self.cfg.num_envs, dtype=np.int64)  # all start easy
        gen = torch.Generator(device=self.device).manual_seed(seed)
        env = cur_lib.make_states(
            self.bank, torch.as_tensor(self.level, device=self.device),
            generator=gen)
        # any net mapping obs[N, 217] -> q[N, 14 | 40] (MLP, dueling, conv)
        if net is None:
            net = QNetwork(generator=torch.Generator().manual_seed(seed))
        net = net.to(self.device)
        self.state = CurriculumState(
            net=net, target_net=copy.deepcopy(net),
            opt=agent_lib.make_optimizer(net, self.cfg.dqn),
            replay=ReplayBuffer(self.cfg.replay_capacity, self.device),
            env=env, gen=gen)
        self._rng = np.random.default_rng(seed)

    def run_chunk(self, n_steps: int):
        """``n_steps`` lockstep steps at the current levels. Returns device
        tensors: episodes and wins per level (float64[K]) and the chunk's
        loss."""
        ts, cfg, dqn = self.state, self.cfg, self.cfg.dqn
        dev, K, N = self.device, self.n_levels, cfg.num_envs
        level = torch.as_tensor(self.level, device=dev)
        B = self.bank.boards.shape[1]
        n_upd = max(1, cfg.updates_per_step)
        min_size = max(cfg.warmup_steps, dqn.batch_size) + (dqn.n_step - 1) * N
        episodes = torch.zeros(K, dtype=torch.float64, device=dev)
        wins = torch.zeros_like(episodes)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(n_steps):
            obs = bitboard.observe(ts.env)
            eps = agent_lib.eps_schedule(ts.global_step, dqn)
            rot, col = agent_lib.select_actions(ts.net, obs, eps, generator=ts.gen)
            idx = torch.randint(0, B, (N,), generator=ts.gen, device=dev)
            nxt, res = cur_lib.step_autoreset_curriculum(
                ts.env, rot, col, self.bank, level, idx)
            reward = agent_lib.env_reward(cfg.env, res.lines_delta, res.done, res.won)
            ts.replay.add(ts.env, rot, col, reward, res.state, res.done)
            ts.env = nxt
            if ts.replay.size >= min_size:
                beta = agent_lib.per_beta_schedule(ts.global_step, dqn,
                                                   cfg.total_steps)
                step_loss = 0.0
                for _ in range(n_upd):
                    aux = agent_lib.learner_update(
                        ts.net, ts.target_net, ts.opt, ts.replay, dqn,
                        step_gap=N, beta=beta, generator=ts.gen)
                    step_loss = step_loss + aux["loss"]
                loss_sum += step_loss / n_upd
            ts.global_step += 1
            episodes += torch.bincount(level, weights=res.done.double(), minlength=K)
            wins += torch.bincount(level, weights=res.won.double(), minlength=K)
        return episodes, wins, loss_sum / max(n_steps, 1)

    @torch.no_grad()
    def evaluate_levels(self, episodes_per_level: int = 256,
                        seed: Optional[int] = None,
                        rows: Optional[torch.Tensor] = None) -> list[dict]:
        """Greedy win rate at every level, each from ``episodes_per_level``
        fresh single-episode envs of its own bank (rows ``rows[k]``, else
        drawn from a generator seeded ``seed``, default 1234), rolled out
        with finished envs frozen for max(M)+1 steps, so every episode
        ends."""
        dev, E = self.device, episodes_per_level
        gen = torch.Generator(device=dev).manual_seed(1234 if seed is None else seed)
        max_m = max(m for _, m in self.levels)
        net = self.state.net
        out = []
        for k, (L, M) in enumerate(self.levels):
            lvl = torch.full((E,), k, dtype=torch.int64, device=dev)
            idx = rows[k] if rows is not None else torch.randint(
                0, self.bank.boards.shape[1], (E,), generator=gen, device=dev)
            env = agent_lib.greedy_rollout(
                net, cur_lib.make_states(self.bank, lvl, idx), max_m + 1, bitboard)
            status = env.status.cpu().numpy()
            out.append({"level": k, "L": L, "M": M, "episodes": E,
                        "win_rate": float((status == 1).mean()),
                        "loss_rate": float((status == 2).mean())})
        return out

    def train(self, total_steps: int, chunk: int = 500, threshold: float = 0.7,
              fraction: float = 0.5, log_fn=print) -> list[dict]:
        """Train ``total_steps`` steps in chunks of ``chunk``, promoting on
        the host after each chunk; one row per chunk."""
        history = []
        done = 0
        while done < total_steps:
            n = min(chunk, total_steps - done)
            t0 = time.perf_counter()
            episodes, wins, loss = self.run_chunk(n)
            eps_np = episodes.cpu().numpy()  # waits for the chunk
            wins_np = wins.cpu().numpy()
            dt = time.perf_counter() - t0
            done += n
            win_rate = wins_np / np.maximum(eps_np, 1)
            self.level = cur_lib.promote_levels(
                self.level, win_rate, self.n_levels, threshold=threshold,
                fraction=fraction, rng=self._rng)
            dist = np.bincount(self.level, minlength=self.n_levels)
            row = {
                "step": done,
                "loss": float(loss),
                "win_rate_per_level": [round(float(w), 3) for w in win_rate],
                "level_distribution": dist.tolist(),
                "steps_per_s": n * self.cfg.num_envs / max(dt, 1e-9),
            }
            history.append(row)
            if log_fn:
                log_fn(f"[{done:>6}] loss={row['loss']:.4f} "
                       f"wr={row['win_rate_per_level']} "
                       f"dist={row['level_distribution']}")
        return history
