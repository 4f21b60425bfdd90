"""DQN trainer: the on-device actor-learner loop.

Counterpart of ``tetris_piclim_tpu/dqn/train.py``. Without a bank given,
the trainer fills its own on the host, as the JAX trainer does:
``ConfigBank.fill(carve_fraction=cfg.bank_carve_fraction)``, 75% carves and
25% forward games proven by the DFS solver by default. A chunk of ``n`` env
steps runs one of two paths:

* the per-step path (``actor_fusion=0``): observe -> epsilon-greedy on the
  Q-network (any net: the MLP, dueling or not, or ``models/convnet.py``)
  -> ``step_autoreset_batch`` of the backend (``"bitboard"``, the packed
  step, or ``"array"``, the readable engine of ``engine.py``) -> packed
  replay write -> ``updates_per_step`` learner updates once the replay
  holds the warmup;
* the fused path (``actor_fusion=K``, the plain MLP only): per phase, the
  fused actor (``ops/actor.py``, the CUDA kernel on the GPU) runs K env
  steps with the policy frozen, resetting from a random KB-row window of
  the bank (KB = min(256, B)); then K replay writes and
  ``K * updates_per_step`` learner updates.

The learner samples 1-step or n-step returns, uniformly or by priority
(``dqn/replay.py``). With ``demo_every > 0`` a demonstration buffer, rebuilt
every ``demo_every`` chunks from the beam prover's recorded solutions
(:meth:`DQNTrainer._refresh_demo`), supplies ``demo_ratio`` of every batch
(per-step path on the bitboard backend only, not with PER, as in JAX).
``train(adaptive_share=True)`` steers the bank's forward share from two
probe banks; ``train(refresh_bank=True)`` runs the bank's producer
processes, which swap fresh host rows into the live bank meanwhile. A chunk
reads the bank's (boards, pieces) pair once, so every step of it sees one
generation of rows, as the JAX chunk gets the pair once as arguments.

PyTorch runs eagerly, so the chunk is a Python loop; every metric stays a
device tensor until the chunk ends, and the replay ring's position is a host
int, so the loop waits on the device once per chunk (logging), once per
bank refresh and once per demo refresh. Random draws come from a generator
on the device; scalar draws the host needs (window offsets, kernel seeds)
from a CPU generator, so they cost no device sync.

``DQNTrainer(cfg, mesh=make_mesh())`` trains data-parallel over the ranks
of a ``torch.distributed`` group (``parallel/mesh.py``), with JAX's mesh
layout: each rank steps ``num_envs / W`` envs and keeps their transitions,
and weights, bank and generators are the same on every rank. Every rank
draws the global random tensors and keeps its slice, so the per-step
chunk computes the one-process chunk (the learner's gradient is
all-reduced, ``dqn/agent.py``). The fused path runs the actor kernel on
each rank's envs with seed ``+ rank * 7919``, as JAX's ``shard_map`` does.
A chunk's counts are summed over the ranks once, at its end. Bank and demo
refreshes run on rank 0 and are broadcast; evaluation runs replicated.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import engine
from ..engine import RUNNING
from ..gen import device_forward
from ..gen.bank import ConfigBank
from ..models.qnet import NUM_COL, NUM_ROT, QNetwork
from ..ops import bitboard
from ..ops.actor import actor_rollout_fused
from ..parallel.mesh import (
    Mesh, all_reduce, batch_sharding, broadcast, replicate, replicate_ints,
    shard_bank, shard_train_state,
)
from ..utils.checkpoint import restore_params, restore_train_state, save_train_state
from ..utils.config import TrainConfig
from ..utils.device import resolve_device
from . import agent as agent_lib
from .replay import ReplayBuffer


@dataclasses.dataclass
class TrainState:
    net: nn.Module
    target_net: nn.Module
    opt: agent_lib.AmsgradW
    replay: ReplayBuffer
    env: tuple                  # PackedState, or engine.EnvState (array)
    gen: torch.Generator        # device draws (actions, resets, samples)
    host_gen: torch.Generator   # CPU draws the host needs as ints
    global_step: int = 0        # env steps taken (per-env lockstep)
    updates_done: int = 0
    mesh: Optional[Mesh] = None  # data-parallel layout (shard_train_state)


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


def _failure_share(win_carve: float, win_forward: float) -> float:
    """The forward family's share of the two failure rates, each floored
    by 0.05 so that both families stay sampled when one saturates."""
    return (1.0 - win_forward + 0.05) / (
        (1.0 - win_carve) + (1.0 - win_forward) + 0.10)


def adapt_share(share: float, win_carve: float, win_forward: float) -> float:
    """One adaptive-share step (rule v1): move the forward share toward the
    weaker family in proportion to the failure rates, EMA-smoothed (alpha
    0.5) and clipped to [0.1, 0.9]."""
    target = _failure_share(win_carve, win_forward)
    return min(0.9, max(0.1, 0.5 * share + 0.5 * target))


def adapt_share_v2(share: float, win_carve: float, win_forward: float,
                   prior: float = 0.25) -> float:
    """Prior-anchored rule (v2): the failure-rate target only while the
    forward probe is below half the carve probe, else decay toward
    ``prior``; same EMA and clip as :func:`adapt_share`."""
    if win_forward < 0.5 * win_carve:
        target = _failure_share(win_carve, win_forward)
    else:
        target = prior
    return min(0.9, max(0.1, 0.5 * share + 0.5 * target))


def height_at(device_height, done_steps: int, total_steps: int) -> int:
    """The forward generator's ``initial_height_max`` at ``done_steps``:
    ``device_height=(h0, h1)`` anneals linearly from h0 to h1 over the run;
    None is the reference's 4 (tetris_algo_main/main.py:38)."""
    if device_height is None:
        return 4
    h0, h1 = device_height
    frac = done_steps / max(total_steps, 1)
    return int(round(h0 + (h1 - h0) * frac))


_BACKENDS = {"bitboard": bitboard, "array": engine}


class DQNTrainer:
    def __init__(self, cfg: TrainConfig, bank: Optional[ConfigBank] = None,
                 net: Optional[nn.Module] = None, device="cuda",
                 backend: str = "bitboard", mesh: Optional[Mesh] = None):
        """``mesh``: train data-parallel on it (every rank of the group
        constructs the trainer with the same arguments); the device is then
        the mesh's."""
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if backend not in _BACKENDS:
            raise ValueError(f"backend {backend!r}: want one of {list(_BACKENDS)}")
        self.backend = _BACKENDS[backend]
        if net is None:
            net = QNetwork(generator=torch.Generator().manual_seed(cfg.seed))
        if cfg.actor_fusion > 0 and not (isinstance(net, QNetwork)
                                         and not net.dueling
                                         and self.backend is bitboard):
            raise ValueError(
                "actor_fusion requires the plain (non-dueling) MLP QNetwork "
                "on the bitboard backend: the fused actor kernel runs that "
                "exact forward and step")
        if cfg.demo_every > 0:
            if cfg.dqn.prioritized:
                raise ValueError(
                    "demo-augmented training is incompatible with PER "
                    "(priority updates index the env buffer only)")
            if cfg.actor_fusion > 0:
                raise ValueError(
                    "demo-augmented training requires the per-step chunk "
                    "(actor_fusion=0)")
            if self.backend is not bitboard:
                raise ValueError(
                    "demo-augmented training requires the bitboard backend")
        if mesh is not None and cfg.actor_fusion > 0 and cfg.num_envs % mesh.size:
            raise ValueError(
                f"num_envs ({cfg.num_envs}) must be divisible by the mesh "
                f"size ({mesh.size}) for actor_fusion")
        if bank is None:
            bank = ConfigBank(cfg.env.L, cfg.env.M, capacity=cfg.bank_capacity,
                              seed=cfg.seed, device=self.device)
            if mesh is None or mesh.is_root:
                bank.fill(carve_fraction=cfg.bank_carve_fraction)
            else:  # rank 0's rows arrive through shard_bank below
                bank.allocate()
        self.bank = bank
        if mesh is not None:
            shard_bank(mesh, bank)
        net = net.to(self.device)
        target = copy.deepcopy(net)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        idx = torch.randint(0, bank.capacity, (cfg.num_envs,), generator=gen,
                            device=self.device)
        boards, pieces = self._bank_rows(bank.rows)
        env = self.backend.make_state_batch(
            boards[idx], pieces[idx], cfg.env.L, cfg.env.M)
        self.state = TrainState(
            net=net, target_net=target,
            opt=agent_lib.make_optimizer(net, cfg.dqn),
            replay=ReplayBuffer(cfg.replay_capacity, self.device),
            env=env, gen=gen,
            host_gen=torch.Generator().manual_seed(cfg.seed + 1),
        )
        # the demonstration buffer lives outside TrainState, so checkpoints
        # resume with demos on or off
        self._demo: Optional[ReplayBuffer] = None
        self._demo_n = 0
        if cfg.demo_every > 0:
            self._demo = ReplayBuffer(cfg.demo_capacity, self.device)
            self._demo_n = max(1, int(round(cfg.dqn.batch_size * cfg.demo_ratio)))
        self._clock = _Clock(self.device)
        self._take = lambda x: x  # noqa: E731  this rank's slice of [num_envs]
        if mesh is not None:
            shard_train_state(mesh, self.state)
            self._take = batch_sharding(mesh)

    # -- chunks -----------------------------------------------------------------

    def _bank_rows(self, rows: tuple):
        """A bank's (boards, pieces) pair, with the boards in the backend's
        layout (packed for bitboard, bool[B, 20, 10] for the array
        engine)."""
        cols, pieces = rows
        if self.backend is bitboard:
            return cols, pieces
        return bitboard.unpack_board(cols), pieces

    def _learn(self, n_upd: int, m: dict) -> None:
        """``n_upd`` learner updates once the replay holds the warmup and
        every sampled n-step chain is written ((n-1) * num_envs newer
        transitions)."""
        ts, cfg, dqn = self.state, self.cfg, self.cfg.dqn
        min_size = (max(cfg.warmup_steps, dqn.batch_size)
                    + (dqn.n_step - 1) * cfg.num_envs)
        if ts.replay.size < min_size:
            return
        beta = agent_lib.per_beta_schedule(ts.global_step, dqn, cfg.total_steps)
        start = self._clock.mark()
        for _ in range(n_upd):
            aux = agent_lib.learner_update(
                ts.net, ts.target_net, ts.opt, ts.replay, dqn,
                step_gap=cfg.num_envs, beta=beta, generator=ts.gen,
                demo=self._demo, demo_n=self._demo_n,
                demo_margin=cfg.demo_margin,
                demo_margin_weight=cfg.demo_margin_weight)
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

    def _chunk_plain(self, n_steps: int, rows: Optional[tuple] = None) -> ChunkMetrics:
        ts, dqn, be = self.state, self.cfg.dqn, self.backend
        boards, pieces = self._bank_rows(rows or self.bank.rows)
        m = self._new_metrics()
        n_upd = max(1, self.cfg.updates_per_step)
        n, dev, take = self.cfg.num_envs, self.device, self._take
        for _ in range(n_steps):
            obs = be.observe(ts.env)
            eps = agent_lib.eps_schedule(ts.global_step, dqn)
            # the draws of all num_envs envs, in select_actions' order; a
            # rank on a mesh keeps its slice
            explore_u = torch.rand((n,), generator=ts.gen, device=dev)
            r_rot = torch.randint(0, NUM_ROT, (n,), generator=ts.gen, device=dev)
            r_col = torch.randint(0, NUM_COL, (n,), generator=ts.gen, device=dev)
            rot, col = agent_lib.select_actions(
                ts.net, obs, eps, explore_u=take(explore_u), r_rot=take(r_rot),
                r_col=take(r_col))
            idx = take(torch.randint(0, boards.shape[0], (n,), generator=ts.gen,
                                     device=dev))
            nxt, res = be.step_autoreset_batch(ts.env, rot, col, boards, pieces, idx)
            reward = agent_lib.env_reward(self.cfg.env, res.lines_delta, res.done, res.won)
            if be is bitboard:
                ts.replay.add(ts.env, rot, col, reward, res.state, res.done)
            else:  # the replay stores packed states
                ts.replay.add(bitboard.from_env_state(ts.env), rot, col, reward,
                              bitboard.from_env_state(res.state), res.done)
            ts.env = nxt
            self._learn(n_upd, m)
            ts.global_step += 1
            m["episodes"] += res.done.sum()
            m["wins"] += res.won.sum()
            m["lines"] += res.lines_delta.sum()
            m["reward"] += reward.sum()
        return self._metrics(m)

    def _chunk_fused(self, n_steps: int, rows: Optional[tuple] = None) -> ChunkMetrics:
        ts, dqn = self.state, self.cfg.dqn
        cols, pieces = rows or self.bank.rows
        K = self.cfg.actor_fusion
        if n_steps % K:
            raise ValueError(f"chunk of {n_steps} steps is not whole K={K} phases")
        m = self._new_metrics()
        n_upd = max(1, self.cfg.updates_per_step) * K
        B = cols.shape[0]
        kb = min(256, B)
        rank = 0 if self.mesh is None else self.mesh.rank
        for _ in range(n_steps // K):
            off = int(torch.randint(0, B - kb + 1, (), generator=ts.host_gen))
            seed = int(torch.randint(0, 2**31 - 1, (), generator=ts.host_gen))
            ts.env, trans, episodes, wins = actor_rollout_fused(
                ts.env, ts.net, cols[off:off + kb],
                pieces[off:off + kb], ts.global_step, seed + rank * 7919,
                eps_start=dqn.eps_start, eps_end=dqn.eps_end,
                eps_decay=dqn.eps_decay, n_steps=K)
            reward = agent_lib.env_reward(self.cfg.env, trans.lines_delta, trans.done, trans.won)
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
        return self._metrics(m)

    def _metrics(self, m: dict) -> ChunkMetrics:
        """The chunk's metrics; on a mesh the counts (episodes, wins, lines,
        reward) are summed over the ranks here, in one float64 all-reduce.
        The loss terms are already the whole batch's."""
        if self.mesh is not None:
            keys = ("episodes", "wins", "lines", "reward")
            tot = all_reduce(self.mesh, torch.stack([m[k].double() for k in keys]))
            for k, v in zip(keys, tot):
                m[k] = v.to(m[k].dtype)
        return ChunkMetrics(**m)

    def run_chunk(self, n_steps: int, rows: Optional[tuple] = None) -> ChunkMetrics:
        """``n_steps`` env steps on the bank's (cols, pieces) pair, read once
        here, or on ``rows``."""
        if self.cfg.actor_fusion > 0:
            return self._chunk_fused(n_steps, rows)
        return self._chunk_plain(n_steps, rows)

    # -- demonstration buffer --------------------------------------------------

    @torch.no_grad()
    def _demo_rollout(self, boards: torch.Tensor, pieces: torch.Tensor,
                      sol_rot: torch.Tensor, sol_loc: torch.Tensor,
                      sol_len: torch.Tensor) -> None:
        """Replay recorded winning solutions through the env and rewrite the
        demonstration buffer with the resulting transitions.

        Step t of candidate d is a demonstration while ``t < sol_len[d]``
        and the env still runs (a prefix of each column; unproven
        candidates have ``sol_len == 0``); finished envs are frozen. Each
        row stores the Monte-Carlo return-to-go ``R_t = r_t + gamma
        R_{t+1}`` (float32, a reverse scan) with ``done`` True, so the
        learner regresses ``Q(s_t, a_t)`` on it and never bootstraps from
        an expert state. The buffer's ``demo_capacity`` rows are taken at
        an even stride over the valid transitions, which come first in a
        stable sort of ``~valid`` (t-major), cycled when there are fewer.
        With no valid transition the buffer is left as it was; that test
        waits for the device (one sync per refresh)."""
        e, gamma = self.cfg.env, self.cfg.dqn.gamma
        D, M = sol_rot.shape
        K = self._demo.capacity
        env = bitboard.make_state_batch(boards, pieces, e.L, e.M)
        steps = []
        for t in range(M):
            rot, col = sol_rot[:, t].long(), sol_loc[:, t].long()
            valid = (env.status == RUNNING) & (t < sol_len)
            res = bitboard.step(env, rot, col)
            reward = agent_lib.env_reward(self.cfg.env, res.lines_delta, res.done, res.won)
            steps.append((*bitboard.packed_fields(env)[:5], rot, col, reward,
                          *bitboard.packed_fields(res.state), valid))
            env = bitboard.state_where(env.status != RUNNING, env, res.state)
        fields = [torch.stack(f) for f in zip(*steps)]   # each [M, D, ...]
        valid, reward = fields[-1], fields[7]
        cont = torch.cat([valid[1:], torch.zeros_like(valid[:1])]).float()
        returns = torch.empty_like(reward)
        r_next = torch.zeros((D,), dtype=torch.float32, device=self.device)
        for t in range(M - 1, -1, -1):
            r_next = reward[t] + gamma * r_next * cont[t]
            returns[t] = r_next
        fields[7] = returns
        valid = valid.reshape(M * D)
        n_valid = int(valid.sum())
        if n_valid == 0:
            return
        order = torch.sort((~valid).to(torch.uint8), stable=True).indices
        pos = torch.arange(K, device=self.device) * n_valid // K
        idx = order[pos % n_valid]
        rows = [f.reshape(M * D, *f.shape[2:])[idx] for f in fields[:-1]]
        done = torch.ones((K,), dtype=torch.bool, device=self.device)
        self._demo.add_fields(*rows[:8], done, *rows[8:])

    def _share_demo(self) -> None:
        """Rank 0's demonstration buffer to every rank."""
        d = self._demo
        replicate(self.mesh, list(d.buf.values()))
        pos_size = torch.tensor([d.pos, d.size], device=self.device)
        d.pos, d.size = (int(v) for v in broadcast(self.mesh, pos_size).tolist())

    def _refresh_demo(self, seed: int, initial_height_max: int = 4,
                      beam_width: int = 8) -> None:
        """Generate and prove ``demo_rows`` fresh forward-family candidates
        (from ``seed``) and rebuild the demonstration buffer from their
        recorded winning solutions."""
        cfg = self.cfg
        fb = device_forward.generate_batch_device(
            cfg.demo_rows, cfg.env.L, cfg.env.M, initial_height_max, beam_width,
            generator=torch.Generator(device=self.device).manual_seed(seed),
            device=self.device)
        self._demo_rollout(fb.boards, fb.pieces, fb.rotations, fb.locations,
                           fb.n_moves)

    # -- host loop ----------------------------------------------------------------

    def train(self, total_steps: Optional[int] = None, log_fn=print,
              refresh_bank: bool = False,
              device_refresh_every: int = 0,
              device_forward_fraction: float = 0.0,
              device_beam_width: int = 8,
              device_height: Optional[tuple[int, int]] = None,
              adaptive_share: bool = False, adapt_every: int = 20,
              adapt_episodes: int = 1024, adapt_rule: str = "v2") -> dict:
        """Run ``total_steps`` env steps in chunks of ``log_every``, logging
        one row per chunk. ``device_refresh_every=k`` regenerates the bank
        on the device every k chunks (fresh seed each time), inside the
        next chunk's timer: carve rows only, or with a forward share > 0
        the whole bank as that share of proven forward rows (beam
        ``device_beam_width``) over carves. ``device_height=(h0, h1)``
        anneals the forward generator's ``initial_height_max`` from h0 to
        h1 over this call's steps (bank and demo refreshes).

        ``adaptive_share=True``: every ``adapt_every`` chunks the greedy
        policy plays ``adapt_episodes`` episodes on each of two fixed probe
        banks (512 rows each: carves from seed ``cfg.seed + 7001``, proven
        forward rows from ``cfg.seed + 7002``), and :func:`adapt_share_v2`
        (``adapt_rule="v2"``) or :func:`adapt_share` (``"v1"``) sets the
        forward share of the following refreshes.

        ``refresh_bank=True`` starts the bank's producer processes
        (``ConfigBank.start_refresh``: carves, and forward games proven by
        the host DFS solver) before the first chunk and stops them when the
        call ends, however it ends; each row then logs the rows they have
        written and the bank's family counts. On a mesh only rank 0 runs
        them, and every chunk starts with rank 0's bank broadcast
        (``shard_bank``, under rank 0's bank lock): the chunk reads the
        rows broadcast, so all ranks step on one generation of rows, as
        JAX's chunk reads its replicated bank once.

        Seeds come from ``np.random.default_rng(cfg.seed + 0xBA4E)`` in the
        JAX trainer's order within a chunk: two for the probes, one for the
        bank refresh, one for the demo refresh.

        On a mesh every rank calls this with the same arguments. A device
        bank or demo refresh runs on rank 0 and is broadcast; the probes
        run on every rank; the producers run on rank 0 alone, and rank 0's
        refresh counts are logged on every rank."""
        cfg = self.cfg
        mesh = self.mesh
        root = mesh is None or mesh.is_root
        total = total_steps if total_steps is not None else cfg.total_steps
        chunk = max(1, min(cfg.log_every, total))
        done_steps, since_ckpt, chunk_i = 0, 0, 0
        history = []
        bank_keys = np.random.default_rng(cfg.seed + 0xBA4E)
        draw = lambda: int(bank_keys.integers(2**31 - 1))  # noqa: E731
        share = float(device_forward_fraction)
        if adaptive_share:
            # fixed probe banks under their own seeds: not the holdout, not
            # the churning training bank
            L, M, dev = cfg.env.L, cfg.env.M, self.device
            probe_c = ConfigBank(L, M, capacity=512, seed=cfg.seed + 7001,
                                 device=dev).fill_device(forward_fraction=0.0)
            probe_f = ConfigBank(L, M, capacity=512, seed=cfg.seed + 7002,
                                 device=dev).fill_device(
                forward_fraction=1.0, beam_width=device_beam_width)
            if mesh is not None:
                shard_bank(mesh, probe_c)
                shard_bank(mesh, probe_f)
        if refresh_bank and root:
            self.bank.start_refresh()
        try:
            t0 = time.perf_counter()
            while done_steps < total:
                probe = None
                if adaptive_share and chunk_i and chunk_i % adapt_every == 0:
                    seed_c, seed_f = draw(), draw()
                    wc = self.evaluate(adapt_episodes, seed=seed_c, bank=probe_c)["win_rate"]
                    wf = self.evaluate(adapt_episodes, seed=seed_f, bank=probe_f)["win_rate"]
                    rule = adapt_share_v2 if adapt_rule == "v2" else adapt_share
                    share = rule(share, wc, wf)
                    probe = {"probe_carve": wc, "probe_forward": wf}
                if device_refresh_every and chunk_i and chunk_i % device_refresh_every == 0:
                    seed = draw()
                    if root:
                        self.bank.refresh_device(
                            seed=seed, forward_fraction=share,
                            beam_width=device_beam_width,
                            initial_height_max=height_at(device_height, done_steps, total))
                    if mesh is not None and not refresh_bank:
                        shard_bank(mesh, self.bank)
                if self._demo is not None and chunk_i % cfg.demo_every == 0:
                    # runs at chunk 0 too, so the buffer is full when learning starts
                    seed = draw()
                    if root:
                        self._refresh_demo(seed, height_at(device_height, done_steps, total),
                                           device_beam_width)
                    if mesh is not None:
                        self._share_demo()
                chunk_i += 1
                n = min(chunk, total - done_steps)
                if cfg.actor_fusion > 0:
                    K = cfg.actor_fusion
                    n = -(-n // K) * K  # kernel phases are K steps
                rows = None
                if refresh_bank and mesh is not None:
                    with self.bank._lock:  # no swap between broadcast and read
                        rows = shard_bank(mesh, self.bank).rows
                m = self.run_chunk(n, rows)
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
                if refresh_bank:
                    row["bank_writes"], row["bank_families"] = self._refresh_counts()
                if device_refresh_every and (adaptive_share or device_height is not None):
                    row["forward_share"] = round(share, 4)
                if probe is not None:
                    row.update(probe)
                history.append(row)
                if log_fn is not None:
                    extra = (f" bank_writes={row['bank_writes']}"
                             f" families={row['bank_families']}"
                             if refresh_bank else "")
                    if "forward_share" in row:
                        extra += f" share={row['forward_share']:.2f}"
                    if probe is not None:
                        extra += (f" probe_c={probe['probe_carve']:.3f}"
                                  f" probe_f={probe['probe_forward']:.3f}")
                    log_fn(
                        f"[{row['step']:>7}] env_steps={row['env_steps']:.2e} "
                        f"win_rate={row['win_rate']:.3f} loss={row['loss']:.4f} "
                        f"eps={row['eps']:.3f} sps={row['steps_per_s']:.3e}{extra}"
                    )
                since_ckpt += n
                if cfg.checkpoint_dir and cfg.checkpoint_every > 0 \
                        and since_ckpt >= cfg.checkpoint_every:
                    self.save_checkpoint()
                    since_ckpt = 0
        finally:
            if refresh_bank and root:
                self.bank.stop_refresh()
        if refresh_bank and mesh is not None:
            shard_bank(mesh, self.bank)  # rows swapped in after the last chunk's read
        return {"history": history}

    def _refresh_counts(self) -> tuple[int, dict]:
        """The producers' row writes and the bank's family counts, rank 0's
        on a mesh."""
        fam = self.bank.family_counts
        vals = (self.bank.refresh_writes, fam["carve"], fam["forward"])
        if self.mesh is not None:
            vals = replicate_ints(self.mesh, vals)
        return vals[0], {"carve": vals[1], "forward": vals[2]}

    # -- checkpoint / resume ---------------------------------------------------------

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Save the full TrainState under ``path`` or
        ``cfg.checkpoint_dir/step_<global_step>`` (on a mesh: every rank
        calls this, rank 0 writes the global state)."""
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
        cfg, be = self.cfg, self.backend
        boards, pieces = self._bank_rows((bank if bank is not None else self.bank).rows)
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1 if seed is None else seed)
        idx = torch.randint(0, boards.shape[0], (n_episodes,), generator=gen,
                            device=self.device)
        env = be.make_state_batch(boards[idx], pieces[idx], cfg.env.L, cfg.env.M)
        env = agent_lib.greedy_rollout(self.state.net, env, cfg.env.M + 1, be)
        status = env.status.cpu().numpy()
        return {
            "episodes": n_episodes,
            "win_rate": float((status == 1).mean()),
            "loss_rate": float((status == 2).mean()),
            "unfinished": float((status == 0).mean()),
        }
