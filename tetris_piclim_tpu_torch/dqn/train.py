"""DQN trainer: the on-device actor-learner loop.

Counterpart of ``tetris_piclim_tpu/dqn/train.py``. A chunk of ``n`` env
steps runs one of two paths:

* the per-step path (``actor_fusion=0``): observe -> epsilon-greedy on the
  Q-network -> ``bitboard.step_autoreset_batch`` -> packed replay write ->
  ``updates_per_step`` learner updates once the replay holds the warmup;
* the fused path (``actor_fusion=K``): per phase, the fused actor
  (``ops/actor.py``, the CUDA kernel on the GPU) runs K env steps with the
  policy frozen, resetting from a random KB-row window of the bank
  (KB = min(256, B)); then K replay writes and ``K * updates_per_step``
  learner updates.

PyTorch runs eagerly, so the chunk is a Python loop; every metric stays a
device tensor until the chunk ends, and the replay ring's position is a host
int, so the loop waits on the device once per chunk (logging). Random draws
come from a generator on the device; scalar draws the host needs (window
offsets, kernel seeds) from a CPU generator, so they cost no device sync.

Not ported yet (see ROADMAP.md): demonstrations, n-step and prioritized
replay, bf16 moments and dueling heads (they raise), adaptive share, host
refresh and multi-device meshes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine import RUNNING
from ..gen.bank import ConfigBank
from ..models.qnet import QNetwork, q_ops
from ..ops import bitboard
from ..ops.actor import actor_rollout_fused
from ..utils.checkpoint import restore_params, restore_train_state, save_train_state
from ..utils.config import TrainConfig
from ..utils.device import resolve_device
from . import agent as agent_lib
from .replay import ReplayBuffer


@dataclasses.dataclass
class TrainState:
    net: QNetwork
    target_net: QNetwork
    opt: agent_lib.AmsgradW
    replay: ReplayBuffer
    env: bitboard.PackedState
    gen: torch.Generator        # device draws (actions, resets, samples)
    host_gen: torch.Generator   # CPU draws the host needs as ints
    global_step: int = 0        # env steps taken (per-env lockstep)
    updates_done: int = 0


class ChunkMetrics(NamedTuple):
    episodes: torch.Tensor
    wins: torch.Tensor
    lines: torch.Tensor
    reward: torch.Tensor
    loss_sum: torch.Tensor
    loss_count: int
    q_mean_sum: torch.Tensor


class _Clock:
    """Sums the device time of spans (CUDA events on the GPU, the host
    clock on the CPU); read once per chunk, after the chunk's sync."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, start, end) -> None:
        self.spans.append((start, end))

    def total_ms(self) -> float:
        if self.cuda:
            ms = sum(a.elapsed_time(b) for a, b in self.spans)
        else:
            ms = sum(b - a for a, b in self.spans) * 1e3
        self.spans.clear()
        return ms


def height_at(device_height, done_steps: int, total_steps: int) -> int:
    """The forward generator's ``initial_height_max`` at ``done_steps``:
    ``device_height=(h0, h1)`` anneals linearly from h0 to h1 over the run;
    None is the reference's 4 (tetris_algo_main/main.py:38)."""
    if device_height is None:
        return 4
    h0, h1 = device_height
    frac = done_steps / max(total_steps, 1)
    return int(round(h0 + (h1 - h0) * frac))


class DQNTrainer:
    def __init__(self, cfg: TrainConfig, bank: Optional[ConfigBank] = None,
                 net: Optional[QNetwork] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        agent_lib.check_supported(cfg.dqn)
        if cfg.demo_every > 0:
            raise NotImplementedError(
                "demonstration-augmented training is not ported yet "
                "(ROADMAP.md, queue A)"
            )
        if net is None:
            net = QNetwork(generator=torch.Generator().manual_seed(cfg.seed))
        if bank is None:
            bank = ConfigBank(cfg.env.L, cfg.env.M, capacity=cfg.bank_capacity,
                              seed=cfg.seed, device=self.device).fill_device()
        self.bank = bank
        net = net.to(self.device)
        target = QNetwork(joint=net.joint).to(self.device)
        target.load_state_dict(net.state_dict())
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        idx = torch.randint(0, bank.capacity, (cfg.num_envs,), generator=gen,
                            device=self.device)
        env = bitboard.make_state_batch(
            bank.cols[idx], bank.pieces[idx], cfg.env.L, cfg.env.M)
        self.state = TrainState(
            net=net, target_net=target,
            opt=agent_lib.make_optimizer(net, cfg.dqn),
            replay=ReplayBuffer(cfg.replay_capacity, self.device),
            env=env, gen=gen,
            host_gen=torch.Generator().manual_seed(cfg.seed + 1),
        )
        self._clock = _Clock(self.device)

    # -- chunks -----------------------------------------------------------------

    def _reward(self, lines_delta, done, won) -> torch.Tensor:
        e = self.cfg.env
        lost = done & ~won
        return (lines_delta.float() * e.reward_per_line
                + won.float() * e.win_reward + lost.float() * e.loss_reward)

    def _learn(self, n_upd: int, m: dict) -> None:
        """``n_upd`` learner updates once the replay holds the warmup."""
        ts, dqn = self.state, self.cfg.dqn
        if ts.replay.size < max(self.cfg.warmup_steps, dqn.batch_size):
            return
        start = self._clock.mark()
        for _ in range(n_upd):
            aux = agent_lib.learner_update(
                ts.net, ts.target_net, ts.opt, ts.replay, dqn, generator=ts.gen)
            m["loss_sum"] += aux["loss"]
            m["q_mean_sum"] += aux["q_mean"]
        self._clock.add(start, self._clock.mark())
        m["loss_count"] += n_upd
        ts.updates_done += n_upd

    def _new_metrics(self) -> dict:
        z = lambda dt: torch.zeros((), dtype=dt, device=self.device)  # noqa: E731
        return {"episodes": z(torch.int64), "wins": z(torch.int64),
                "lines": z(torch.int64), "reward": z(torch.float32),
                "loss_sum": z(torch.float32), "loss_count": 0,
                "q_mean_sum": z(torch.float32)}

    def _chunk_plain(self, n_steps: int) -> ChunkMetrics:
        ts, bank, dqn = self.state, self.bank, self.cfg.dqn
        m = self._new_metrics()
        n_upd = max(1, self.cfg.updates_per_step)
        for _ in range(n_steps):
            obs = bitboard.observe(ts.env)
            eps = agent_lib.eps_schedule(ts.global_step, dqn)
            rot, col = agent_lib.select_actions(ts.net, obs, eps, generator=ts.gen)
            idx = torch.randint(0, bank.capacity, (self.cfg.num_envs,),
                                generator=ts.gen, device=self.device)
            nxt, res = bitboard.step_autoreset_batch(
                ts.env, rot, col, bank.cols, bank.pieces, idx)
            reward = self._reward(res.lines_delta, res.done, res.won)
            ts.replay.add(ts.env, rot, col, reward, res.state, res.done)
            ts.env = nxt
            self._learn(n_upd, m)
            ts.global_step += 1
            m["episodes"] += res.done.sum()
            m["wins"] += res.won.sum()
            m["lines"] += res.lines_delta.sum()
            m["reward"] += reward.sum()
        return ChunkMetrics(**m)

    def _chunk_fused(self, n_steps: int) -> ChunkMetrics:
        ts, bank, dqn = self.state, self.bank, self.cfg.dqn
        K = self.cfg.actor_fusion
        if n_steps % K:
            raise ValueError(f"chunk of {n_steps} steps is not whole K={K} phases")
        m = self._new_metrics()
        n_upd = max(1, self.cfg.updates_per_step) * K
        kb = min(256, bank.capacity)
        for _ in range(n_steps // K):
            off = int(torch.randint(0, bank.capacity - kb + 1, (),
                                    generator=ts.host_gen))
            seed = int(torch.randint(0, 2**31 - 1, (), generator=ts.host_gen))
            ts.env, trans, episodes, wins = actor_rollout_fused(
                ts.env, ts.net, bank.cols[off:off + kb],
                bank.pieces[off:off + kb], ts.global_step, seed,
                eps_start=dqn.eps_start, eps_end=dqn.eps_end,
                eps_decay=dqn.eps_decay, n_steps=K)
            reward = self._reward(trans.lines_delta, trans.done, trans.won)
            for k in range(K):
                ts.replay.add_fields(
                    trans.cols[k], trans.cur[k], trans.nxt[k],
                    trans.lines_left[k], trans.moves_left[k], trans.rot[k],
                    trans.col[k], reward[k], trans.done[k], trans.n_cols[k],
                    trans.n_cur[k], trans.n_nxt[k], trans.n_lines_left[k],
                    trans.n_moves_left[k], trans.n_status[k])
            self._learn(n_upd, m)
            ts.global_step += K
            m["episodes"] += episodes
            m["wins"] += wins
            m["lines"] += trans.lines_delta.sum()
            m["reward"] += reward.sum()
        return ChunkMetrics(**m)

    def run_chunk(self, n_steps: int) -> ChunkMetrics:
        if self.cfg.actor_fusion > 0:
            return self._chunk_fused(n_steps)
        return self._chunk_plain(n_steps)

    # -- host loop ----------------------------------------------------------------

    def train(self, total_steps: Optional[int] = None, log_fn=print,
              device_refresh_every: int = 0,
              device_forward_fraction: float = 0.0,
              device_beam_width: int = 8,
              device_height: Optional[tuple[int, int]] = None) -> dict:
        """Run ``total_steps`` env steps in chunks of ``log_every``, logging
        one row per chunk. ``device_refresh_every=k`` regenerates the bank
        on the device every k chunks (fresh seed each time), inside the
        next chunk's timer: carve rows only, or with
        ``device_forward_fraction > 0`` the whole bank as that share of
        proven forward rows (beam ``device_beam_width``) over carves.
        ``device_height=(h0, h1)`` anneals the forward generator's
        ``initial_height_max`` from h0 to h1 over this call's steps."""
        cfg = self.cfg
        total = total_steps if total_steps is not None else cfg.total_steps
        chunk = max(1, min(cfg.log_every, total))
        done_steps, since_ckpt, chunk_i = 0, 0, 0
        history = []
        bank_keys = np.random.default_rng(cfg.seed + 0xBA4E)
        t0 = time.perf_counter()
        while done_steps < total:
            if device_refresh_every and chunk_i and chunk_i % device_refresh_every == 0:
                self.bank.refresh_device(
                    seed=int(bank_keys.integers(2**31 - 1)),
                    forward_fraction=device_forward_fraction,
                    beam_width=device_beam_width,
                    initial_height_max=height_at(device_height, done_steps, total))
            chunk_i += 1
            n = min(chunk, total - done_steps)
            if cfg.actor_fusion > 0:
                K = cfg.actor_fusion
                n = -(-n // K) * K  # kernel phases are K steps
            m = self.run_chunk(n)
            episodes = int(m.episodes)  # waits for the chunk
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            learner_ms = self._clock.total_ms()
            t0 = time.perf_counter()
            done_steps += n
            count = max(m.loss_count, 1)
            row = {
                "step": done_steps,
                "env_steps": done_steps * cfg.num_envs,
                "episodes": episodes,
                "win_rate": int(m.wins) / max(episodes, 1),
                "lines": int(m.lines),
                "reward": float(m.reward),
                "loss": float(m.loss_sum) / count,
                "q_mean": float(m.q_mean_sum) / count,
                "updates": m.loss_count,
                "eps": agent_lib.eps_schedule(self.state.global_step, cfg.dqn),
                "steps_per_s": n * cfg.num_envs / max(dt, 1e-9),
                "learner_share": learner_ms / max(dt * 1e3, 1e-9),
            }
            history.append(row)
            if log_fn is not None:
                log_fn(
                    f"[{row['step']:>7}] env_steps={row['env_steps']:.2e} "
                    f"win_rate={row['win_rate']:.3f} loss={row['loss']:.4f} "
                    f"eps={row['eps']:.3f} sps={row['steps_per_s']:.3e}"
                )
            since_ckpt += n
            if cfg.checkpoint_dir and cfg.checkpoint_every > 0 \
                    and since_ckpt >= cfg.checkpoint_every:
                self.save_checkpoint()
                since_ckpt = 0
        return {"history": history}

    # -- checkpoint / resume ---------------------------------------------------------

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Save the full TrainState under ``path`` or
        ``cfg.checkpoint_dir/step_<global_step>``."""
        if path is None:
            if not self.cfg.checkpoint_dir:
                raise ValueError("no path given and cfg.checkpoint_dir unset")
            path = f"{self.cfg.checkpoint_dir}/step_{self.state.global_step}"
        save_train_state(path, self.state)
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Resume from :meth:`save_checkpoint` output (same config shape)."""
        restore_train_state(path, self.state)

    def warm_start(self, path: str) -> None:
        """Load only the network weights (online and target)."""
        net_sd, target_sd = restore_params(path, self.device)
        self.state.net.load_state_dict(net_sd)
        self.state.target_net.load_state_dict(target_sd)

    # -- evaluation ------------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, n_episodes: int = 1024, seed: Optional[int] = None,
                 bank: Optional[ConfigBank] = None) -> dict:
        """Greedy win rate over ``n_episodes`` bank configs: each env plays
        one episode (no auto-reset) for M+1 steps, finished envs frozen."""
        cfg = self.cfg
        bank = bank if bank is not None else self.bank
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1 if seed is None else seed)
        idx = torch.randint(0, bank.capacity, (n_episodes,), generator=gen,
                            device=self.device)
        env = bitboard.make_state_batch(
            bank.cols[idx], bank.pieces[idx], cfg.env.L, cfg.env.M)
        net = self.state.net
        ops = q_ops(net.head_dim)
        for _ in range(cfg.env.M + 1):
            rot, col = ops.greedy(net(bitboard.observe(env)))
            res = bitboard.step(env, rot, col)
            env = bitboard.state_where(env.status != RUNNING, env, res.state)
        status = env.status.cpu().numpy()
        return {
            "episodes": n_episodes,
            "win_rate": float((status == 1).mean()),
            "loss_rate": float((status == 2).mean()),
            "unfinished": float((status == 0).mean()),
        }
