"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tetris_piclim_tpu_torch/csrc`` (one
nvcc per source, all at once), holds each kernel against its plain PyTorch
version on the card (scripted draws, the kernels' own Philox draws word for
word against ``philox_draws``, and batch sizes that fill no tile), and
drives the port's two paths through the entry points a user calls:

1. the random-policy rollout at the benchmark shape (N=8192 envs, K=1024
   steps per launch, L=2/M=20, a 256-row bank from the device carver);
2. the DQN trainer at full width (L=2, M=20, 4096 envs, 4096-row device
   bank, 131072-transition replay, batch 128, ``actor_fusion=8``), then a
   1024-episode greedy evaluation and a checkpoint round trip; and, for
   comparison, the same recipe on the per-step path (``actor_fusion=0``),
   whose bank's fill must carve from a generator seeded by one draw of the
   bank's ``random.Random`` (as JAX draws its key) and whose trainer must
   not draw the fill's reset rows;
3. the device forward generator and beam prover (n=1024 at L=2/M=20 and
   L=10/M=30, beam 8, height 4): timed, every winner replayed to WIN on the
   card, and 256 candidates proven on the card and on the CPU with
   identical verdicts and solutions at beam 8 and beam 1;
4. the trainer on a 25% forward-family bank refreshed every chunk (the
   README's round-5 bank recipe), then a 1024-row held-out bank checked
   disjoint from it and evaluated in all and per family;
5. the learner's parts, card against CPU with TF32 off: the conv net from
   either JAX impl's parameter tree (all four heads, and the bf16 torso),
   three bf16-moment optimizer steps, the demo rollout of a 256-candidate
   prover batch at L=10/M=30, the n-step/PER sample from given base
   indices and a priority write-back with duplicate indices;
6. round 5's flagship demo recipe at full width (L=10/M=30, conv (32,64) +
   dueling + joint, 2048 envs, bank 4096, 4 updates per step, 25% forward
   rows refreshed every chunk, height 8:4, 1024 demo rows rebuilt every
   chunk, margin 0.8), then a 2048-row holdout (its forward rows all from
   the device prover: the host DFS solver proves almost nothing at L=10 and
   took a minute) and a checkpoint round trip;
7. the adaptive share (rule v2) with bf16 moments at L=5/M=25 on the same
   flags, every logged share held against the controller;
8. the fused-actor trainer with 3-step returns and prioritized replay;
9. the host generators: 256 host carves with recorded solutions uploaded,
   read back word for word, and replayed to WIN by the card's step;
10. the trainer with no bank given, as ``cli train`` runs by default: the
    host fill of 1024 rows (75% carves, 25% forward games proven by the DFS
    solver; the carve rows read back against the host carver), then
    training with ``actor_fusion=8`` while the producer processes swap
    fresh rows into the live bank (``refresh_bank``), then a few chunks
    with the refresh off for comparison;
11. the array engine on the card against the bitboard step, word for word;
12. the curriculum trainer at full width (levels 1:10, 2:15, 3:20, 1024
    envs, 1024 rows per level, replay 131072): each level's bank carved
    from a generator of its own seed (one draw of ``random.Random(0)``) and
    carved again from it, the trainer's stream apart from the levels'; the
    card's ``step_autoreset_curriculum`` against the CPU's word for word;
    one ``run_chunk`` on the card and the same chunk on the CPU from one
    fresh state, at a mixed level array, across the warmup, on the card's
    draws fed to both (envs, ring and tallies word for word, weights
    within 1e-4); a few chunks, and the per-level greedy evaluation;
13. ``cli play`` (the recorded solution, and greedy from the phase-10
    checkpoint on the card) and ``cli bench --no-train``
    (``bench.run(train=False)``: the rollout kernel at the benchmark shape,
    beside phase 1's rate);
14. ``make_state_batch`` of both engines with per-env goals and move
    limits, card against CPU word for word through a few steps;
15. the training benchmark, ``bench_mfu.measure``, at full width (2048
    envs, conv (32,64) + dueling + joint with a bf16 torso, L=5/M=25, a
    1024-row device bank, 4 updates per step) with its chunk cut from 512
    steps to 32: the card's BF16 peak is known, and the chunk, learner and
    actor MFU each lie in (0, 1], and the learner's share of the chunk,
    read from the trainer's clock inside it, in (0, 1.05]; then a tiny ``cli train --profile-dir``
    whose ``torch.profiler`` trace parses and holds CUDA kernel events;
16. data-parallel training over ``torch.distributed``: a one-rank NCCL
    mesh word for word against no mesh, and two gloo ranks sharing the card
    against one process;
17. (a) ``refresh_bank`` on a two-rank gloo mesh sharing the card, on
    ``cli train``'s default-bank recipe (rank 0 fills the bank and runs
    the producers; every chunk reads rank 0's rows, broadcast and timed),
    (b) ``make_mesh(2)`` of three gloo ranks against one process, (c)
    ``entry()`` (the flagship net on 256 envs) on the card against the CPU;
18. the TPU-trained L=2/M=20 policy (``results/tpu_L2M20_v2_*.npz``, the
    JAX package's first DQN run, carried out of its checkpoint by
    ``tools/tpu_checkpoint.py``): (i) its greedy evaluation on the carried
    4096 bank rows at the carried draws, the card against the port on the
    CPU within 2 episodes, (ii) ``DQNTrainer.warm_start`` from the file and
    ``evaluate`` over 4096 episodes of a fresh device-carved 4096-row bank,
    within 0.03 of the TPU run's 0.5632, (iii) the actor kernel with these
    weights at epsilon 0 (N=4096, K=8, head 14) against ``actor_reference``:
    actions agree on at least 99.9% of env-steps, and every disagreement is
    a near-tie (top two Q values within 1e-4);
19. the flagship policies the port trained on the H100, at 175k steps
    (``results/flagship_L5M25_h100_policy.npz``) and at 100k steps of
    unbroken runs at training seeds 0 and 1
    (``results/flagship_L5M25_100k_h100_policy.npz``,
    ``flagship_L5M25_100k_seed1_h100_policy.npz``), each
    L=5/M=25, conv (32,64) + dueling + joint, carried out of its checkpoint
    by ``tools/flagship_policy.py`` with its training bank and its 2048
    held-out rows. For each file: ``DQNTrainer.warm_start`` from the file
    (as ``cli eval --checkpoint`` loads it), 8192 greedy episodes on the
    carried held-out rows within 0.005 of the recorded held-out win rate
    with TF32 off (per family and on the training bank reported), then
    with cuDNN's TF32 on, as the reading ran (PyTorch's default), all four
    rates equal to the recorded ones exactly, and the greedy episode
    of each of 256 held-out rows on the card against the CPU, TF32 off:
    every episode that ends otherwise has a top-two Q gap under 1e-3 on its
    way; all in under 60 s per file, with no DFS (the rows are carried).
    The evaluation draws its episodes from the run's training seed, as
    ``cli eval`` did. Each 100k policy's held-out, carve and forward win
    rates are set beside JAX's reading of its 100k checkpoint with their
    bands (0.03, 0.05, 0.05), and held where the run that made the file
    read inside: seed 0's forward row lies outside its band, and is
    reported, not held;
20. the generators on explicit draws: (a) the device carver at the
    flagship bank's shape (n=4096, L=5/M=25, JAX's default ``max_iters``)
    on draws made on the CPU from a seeded generator, card against CPU word
    for word in boards, pieces, rotations, locations and n_moves, every row
    done and replayed to WIN on the card; (b) the same with ``max_iters``
    cut to 40, some rows done and some not; (c) the generator path on the
    card as the bank calls it, timed per 4096 rows; (d) the host forward
    pipeline ``generate_batch(2, 20, 0, 100)`` on a spawn-context process
    pool against the thread pool (the same games; both wall times; the
    spawned workers re-import this script, torch included, and a watchdog
    kills a hung pool after 240 s, which fails the phase);
21. the held-out bank's draw: four L=5/M=25 beam-family draws on the card
    as ``tools/holdout_draws.py`` makes them (``make_holdout_bank`` with no
    host seeds, the tool's first four seeds), each timed; every beam row
    proven again and its solution replayed to WIN; the 100k flagship policy
    played once per row on the card and on the CPU, TF32 off, every
    outcome equal except at near-ties (top-two Q gap under 1e-4), which
    the phase names; each draw's outcomes equal to the card draw of its
    seed recorded in ``results/holdout_draws_L5M25.jsonl``, and the
    per-draw win fractions printed beside the JAX package's CPU draws
    recorded there; all in under 60 s.

Each kernel wrapper counts its launches; the counts are set to 0 just
before a path runs and read just after, and a path whose kernel never
launched fails. Every check that fails exits non-zero. Output: the card's
name and power limit, the kernels' JSON line (launches, errors, times,
bounds), and as the last line ``{"ok": true, "device": {...}}``. Needs one
card, no network; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import random
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from tetris_piclim_tpu_torch import cli
from tetris_piclim_tpu_torch import engine as array_engine
from tetris_piclim_tpu_torch.dqn import agent as agent_lib
from tetris_piclim_tpu_torch.dqn.curriculum_train import CurriculumTrainer
from tetris_piclim_tpu_torch.dqn.replay import ReplayBuffer
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer, adapt_share_v2
from tetris_piclim_tpu_torch.gen import curriculum as cur_lib
from tetris_piclim_tpu_torch.gen import device_carver, device_forward
from tetris_piclim_tpu_torch.gen.bank import (
    FAMILY_CARVE, FAMILY_FORWARD, ConfigBank, pack_host_rows, make_holdout_bank,
)
from tetris_piclim_tpu_torch.gen.carver import CarvingGenerator
from tetris_piclim_tpu_torch.gen.pipeline import generate_batch
from tetris_piclim_tpu_torch.models import convnet
from tetris_piclim_tpu_torch.models.qnet import QNetwork
from tetris_piclim_tpu_torch.ops import _build
from tetris_piclim_tpu_torch.ops import actor as actor_ops
from tetris_piclim_tpu_torch.ops import bitboard as bb
from tetris_piclim_tpu_torch.ops import rollout as rollout_ops
from tetris_piclim_tpu_torch.utils.checkpoint import (
    load_flax_npz, read_policy_npz, restore_bank, save_bank, save_train_state,
)
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

ROOT = Path(__file__).resolve().parent
DEV = torch.device("cuda")

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper), at 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12            # CUDA cores, no tensor cores
TF32_FLOP_PER_S = 495e12           # tensor cores, dense
ACTOR_TF32_PASSES = 3              # the actor's products are 3xTF32
INT32_OP_PER_S = 132 * 64 * 1.98e9  # 64 INT32 lanes per SM at boost clock
# integer operations one env step needs at least (the plain version's word
# ops: 10 ctz + 10 sub + 10 min + 20 lock + 9 and + ~30 clear/status/reset)
STEP_INT_OPS = 90


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after one warm-up)."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def adversarial_boards(rng, n: int) -> np.ndarray:
    """bool[n, 20, 10]: sparse random, deep wells, tall stacks; no full rows."""
    boards = np.zeros((n, 20, 10), bool)
    third = n // 3
    rnd = rng.random((third, 20, 10)) < 0.25
    rnd[:, :6] = False
    boards[:third] = rnd
    depth = rng.integers(1, 5, third)
    well = rng.integers(0, 10, third)
    rows = np.arange(20)[None, :] >= 20 - depth[:, None]
    boards[third:2 * third] = rows[:, :, None]
    boards[third + np.arange(third), :, well] &= False
    tall = rng.random((n - 2 * third, 20, 10)) < 0.55
    tall[:, :2] = False
    boards[2 * third:] = tall
    boards[boards.all(axis=2)] = False
    return boards


def states_equal(a: bb.PackedState, b: bb.PackedState) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def make_state(rng, n: int, L: int, M: int) -> bb.PackedState:
    boards = torch.as_tensor(adversarial_boards(rng, n), device=DEV)
    pieces = torch.as_tensor(rng.integers(0, 7, (n, M + 1)), device=DEV)
    return bb.make_state_batch(boards, pieces, L, M)


# -- phases --------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")


def phase_rollout_check(bank: ConfigBank) -> dict:
    rng = np.random.default_rng(0)
    K, L, M = 64, 2, 20
    err = 0

    def hold(n: int, what: str, seed=None) -> None:
        """Kernel vs plain version on n envs: scripted actions, or with a
        seed the kernel's Philox mode against philox_draws."""
        nonlocal err
        print(f"rollout kernel vs rollout_reference ({what}, N={n}, K={K})")
        state = make_state(rng, n, L, M)
        if seed is None:
            g = lambda lo, hi: torch.as_tensor(  # noqa: E731
                rng.integers(lo, hi, (K, n)), dtype=torch.int32, device=DEV)
            actions = (g(0, 8), g(-3, 13), g(0, bank.capacity))
            ker = rollout_ops.rollout_fused(state, bank.cols, bank.pieces, K,
                                            actions=actions)
        else:
            actions = rollout_ops.philox_draws(
                seed, n, K, bank.capacity, DEV).actions
            ker = rollout_ops.rollout_fused(state, bank.cols, bank.pieces, K,
                                            seed=seed)
        ref = rollout_ops.rollout_reference(state, bank.cols, bank.pieces, K,
                                            actions=actions)
        sync()
        check(states_equal(ker[0], ref[0]), "final state word-identical")
        check(int(ker[1]) == int(ref[1]) and int(ker[2]) == int(ref[2]),
              f"episodes {int(ker[1])} and wins {int(ker[2])} equal")
        check(int(ker[1]) > n // 8, "episodes end and reset in this check")
        err = max([err] + [int((x.long() - y.long()).abs().max())
                           for x, y in zip(ker[0], ref[0])])

    hold(8192, "scripted")
    hold(8192, "Philox mode against philox_draws", seed=12345)
    hold(8191, "scripted, ragged N")
    return {"max_abs_err": float(err)}


def phase_rollout_bench(bank: ConfigBank) -> dict:
    """The random-policy rollout path at the benchmark shape (counted)."""
    print("rollout path: Philox policy, N=8192, K=1024, L=2/M=20, bank 256")
    n, K, L, M = 8192, 1024, 2, 20
    idx = torch.arange(n, device=DEV) % bank.capacity
    state = bb.make_state_batch(bank.cols[idx], bank.pieces[idx], L, M)
    _build.reset_launch_counts()
    out, episodes, wins = rollout_ops.rollout_fused(
        state, bank.cols, bank.pieces, K, seed=1)
    launches = _build.LAUNCHES["rollout"]
    sync()
    check(launches > 0, f"rollout path launched the rollout kernel {launches}x")
    seeds = iter(range(2, 100))
    ms = cuda_ms(lambda: rollout_ops.rollout_fused(
        state, bank.cols, bank.pieces, K, seed=next(seeds)), reps=5)
    episodes = int(episodes)
    check(episodes > n, f"episodes {episodes} > N (the policy plays and resets)")
    moves = out.moves_used.cpu().numpy()
    check(len(np.unique(moves)) > 3, "move counters dispersed")
    # reset rows: an env that reset holds a bank row's piece sequence
    key = lambda p: p.cpu().numpy().view(np.uint8).reshape(p.shape[0], -1)  # noqa: E731
    rows = {r.tobytes(): i for i, r in enumerate(key(bank.pieces))}
    hits = np.bincount([rows[r.tobytes()] for r in key(out.pieces)
                        if r.tobytes() in rows], minlength=bank.capacity)
    mean = hits.sum() / bank.capacity
    check(hits.sum() > n // 2 and hits.min() > 0 and hits.max() < 3 * mean,
          f"reset rows spread over the bank (min {hits.min()}, max {hits.max()}, "
          f"mean {mean:.1f})")
    sps = n * K / (ms / 1e3)
    print(f"  rollout kernel {ms:.3f} ms per launch = {sps:.4e} env-steps/s")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    rollout_ops.rollout_reference(state, bank.cols, bank.pieces, K, generator=gen)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    p = bank.pieces.shape[1]
    state_bytes = n * (2 * (10 * 4 + p + 3 * 4 + 1) + 2 * 4)
    bank_bytes = bank.capacity * (10 * 4 + p)
    bytes_ms = (state_bytes + bank_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * K * STEP_INT_OPS / INT32_OP_PER_S * 1e3
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "env_steps_per_s": sps}


def exact_qnet(joint: bool, seed: int, L: int, M: int) -> QNetwork:
    """A QNetwork whose every partial sum is exact in float32: sparse +-1
    weights, biases on a 1/8 grid, so all values lie on the 1/8 grid; the
    bound on |any partial sum| (|W|^T propagated from the largest inputs)
    times 8 must stay below 2^24."""
    gen = np.random.default_rng(seed)
    net = QNetwork(joint=joint)
    x_max = np.ones(217)
    x_max[214], x_max[215] = L, M
    bound = x_max
    with torch.no_grad():
        for layer in net.dense:
            w = gen.choice([-1.0, 0.0, 1.0], size=tuple(layer.weight.shape),
                           p=[0.03, 0.94, 0.03])
            b = gen.integers(-8, 9, layer.out_features) / 8.0
            layer.weight.copy_(torch.as_tensor(w))
            layer.bias.copy_(torch.as_tensor(b))
            bound = np.abs(w) @ bound + np.abs(b)
            check(bound.max() * 8 < 2 ** 24,
                  f"exact-weight bound {bound.max():.0f} * 8 < 2^24")
    return net


def actor_draws(rng, K: int, n: int, bank: int):
    f = lambda hi: torch.as_tensor(  # noqa: E731
        rng.integers(0, hi, (K, n)), dtype=torch.int32, device=DEV)
    u = torch.as_tensor(rng.random((K, n)), dtype=torch.float32, device=DEV)
    return (u, f(4), f(10), f(bank))


def phase_actor_check(bank: ConfigBank) -> dict:
    n, K, L, M = 4096, 8, 2, 20
    window = (bank.cols[:256].contiguous(), bank.pieces[:256].contiguous())
    eps = dict(eps_start=0.25, eps_end=0.25, eps_decay=1000.0, n_steps=K)
    q_err = 0.0
    for joint in (False, True):
        head = 40 if joint else 14
        rng = np.random.default_rng(10 + head)
        state = make_state(rng, n, L, M)
        state = state._replace(cols=state.cols & ~0xFF)  # room to play
        draws = actor_draws(rng, K, n, 256)

        print(f"actor kernel vs actor_reference, head {head}, exact weights")
        net = exact_qnet(joint, head, L, M).to(DEV)
        ker = actor_ops.actor_rollout_fused(state, net, *window, 0, 0,
                                            draws=draws, return_q=True, **eps)
        ref = actor_ops.actor_reference(state, net, *window, 0, draws=draws,
                                        return_q=True, **eps)
        sync()
        check(states_equal(ker[0], ref[0]), "final state bit-identical")
        check(all(torch.equal(x, y) for x, y in zip(ker[1], ref[1])),
              "every transition field bit-identical")
        check(torch.equal(ker[4], ref[4]), "Q bit-identical")
        check(int(ker[2]) == int(ref[2]) and int(ker[3]) == int(ref[3]),
              f"episodes {int(ker[2])} and wins {int(ker[3])} equal")

        print(f"actor kernel Philox mode vs actor_reference fed by "
              f"philox_draws, head {head}, exact weights")
        seed = 1000 + head
        ker = actor_ops.actor_rollout_fused(state, net, *window, 0, seed,
                                            return_q=True, **eps)
        ref = actor_ops.actor_reference(
            state, net, *window, 0, return_q=True, **eps,
            draws=rollout_ops.philox_draws(seed, n, K, 256, DEV).draws)
        sync()
        check(states_equal(ker[0], ref[0]), "final state bit-identical")
        check(all(torch.equal(x, y) for x, y in zip(ker[1], ref[1])),
              "every transition field bit-identical")
        check(torch.equal(ker[4], ref[4]), "Q bit-identical")
        check(int(ker[2]) == int(ref[2]) and int(ker[3]) == int(ref[3]),
              f"episodes {int(ker[2])} and wins {int(ker[3])} equal")

        n_rag = 4001
        print(f"actor kernel vs actor_reference, head {head}, exact weights, "
              f"ragged N={n_rag}")
        st_rag = make_state(rng, n_rag, L, M)
        st_rag = st_rag._replace(cols=st_rag.cols & ~0xFF)
        dr_rag = actor_draws(rng, K, n_rag, 256)
        ker = actor_ops.actor_rollout_fused(st_rag, net, *window, 0, 0,
                                            draws=dr_rag, return_q=True, **eps)
        ref = actor_ops.actor_reference(st_rag, net, *window, 0, draws=dr_rag,
                                        return_q=True, **eps)
        sync()
        check(states_equal(ker[0], ref[0]), "final state bit-identical")
        check(all(torch.equal(x, y) for x, y in zip(ker[1], ref[1])),
              "every transition field bit-identical")
        check(torch.equal(ker[4], ref[4]), "Q bit-identical")
        check(int(ker[2]) == int(ref[2]) and int(ker[3]) == int(ref[3]),
              f"episodes {int(ker[2])} and wins {int(ker[3])} equal")

        print(f"actor kernel vs actor_reference, head {head}, lecun weights")
        net = QNetwork(joint=joint,
                       generator=torch.Generator().manual_seed(head)).to(DEV)
        ker = actor_ops.actor_rollout_fused(state, net, *window, 0, 0,
                                            draws=draws, return_q=True, **eps)
        ref = actor_ops.actor_reference(state, net, *window, 0, draws=draws,
                                        return_q=True, **eps)
        sync()
        # an env is comparable at step k while all its earlier actions agreed
        same = (ker[1].rot == ref[1].rot) & (ker[1].col == ref[1].col)
        in_sync = torch.ones(n, dtype=torch.bool, device=DEV)
        disagree = compared = 0
        for k in range(K):
            qk, qr = ker[4][k][in_sync], ref[4][k][in_sync]
            scale = qr.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
            rel = ((qk - qr).abs() / scale).max().item() if qk.numel() else 0.0
            check(rel <= 1e-5, f"step {k}: Q within 1e-5 relative ({rel:.2e})")
            q_err = max(q_err, (qk - qr).abs().max().item() if qk.numel() else 0.0)
            compared += int(in_sync.sum())
            disagree += int((in_sync & ~same[k]).sum())
            in_sync &= same[k]
        agree = 1.0 - disagree / max(compared, 1)
        print(f"  action disagreements: {disagree} of {compared} env-steps")
        check(agree >= 0.999, f"actions agree on {agree:.5f} >= 0.999 of env-steps")

    print("actor kernel Philox draws (epsilon 1: every action is a draw)")
    state = make_state(np.random.default_rng(3), n, L, M)
    net = QNetwork(generator=torch.Generator().manual_seed(0)).to(DEV)
    _, tr, _, _ = actor_ops.actor_rollout_fused(
        state, net, *window, 0, 7, eps_start=1.0, eps_end=1.0, eps_decay=1.0,
        n_steps=K)
    for name, lanes in (("rot", 4), ("col", 10)):
        c = torch.bincount(getattr(tr, name).flatten().long(), minlength=lanes)
        c = c.cpu().numpy() / (n * K / lanes)
        check(c.min() > 0.92 and c.max() < 1.08,
              f"random {name} uniform over {lanes} (ratios {c.min():.3f}..{c.max():.3f})")

    # times at the trainer's shape (Philox draws, head 14, 256-row window):
    # the wrapper's whole call, as the trainer pays it (input checks and
    # output buffers on the host; it prepares no weights), and the kernel
    # launch alone on buffers prepared before
    state = make_state(np.random.default_rng(4), n, L, M)
    kw = dict(eps_start=0.9, eps_end=0.05, eps_decay=1000.0, n_steps=K)
    ms = cuda_ms(lambda: actor_ops.actor_rollout_fused(
        state, net, *window, 0, 1, **kw), reps=20)
    launch, _ = actor_ops.prepare_actor_launch(state, net, *window, 0, 1, **kw)
    launch_ms = cuda_ms(launch, reps=50)
    gen = torch.Generator(device=DEV).manual_seed(0)
    plain_ms = cuda_ms(lambda: actor_ops.actor_reference(
        state, net, *window, 0, generator=gen, **kw), reps=5)
    flops = 2 * (217 * 128 + 3 * 128 * 128 + 128 * 14) * n * K
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    ops_ms = max(ACTOR_TF32_PASSES * flops / TF32_FLOP_PER_S,
                 n * K * STEP_INT_OPS / INT32_OP_PER_S) * 1e3
    p = bank.pieces.shape[1]
    weights = 4 * (217 * 128 + 3 * 128 * 128 + 128 * 14 + 4 * 128 + 14)
    io = n * (2 * (10 * 4 + p + 3 * 4 + 1) + 2 * 4) + K * n * (10 + 10 + 16) * 4
    bytes_ms = (weights + io + 256 * (40 + p)) / HBM_BYTES_PER_S * 1e3
    print(f"  actor kernel {ms:.3f} ms per wrapper call, {launch_ms:.3f} ms per "
          f"launch alone, plain {plain_ms:.3f} ms (N={n}, K={K}); bound "
          f"{max(ops_ms, bytes_ms):.4f} ms ({ACTOR_TF32_PASSES} TF32 passes on the "
          f"tensor cores), {fp32_ms:.4f} ms on the FP32 pipes")
    return {"max_abs_err": q_err, "ms": ms, "launch_ms": launch_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def train_config(fusion: int, chunks: int, log_every: int) -> TrainConfig:
    """The README's L=2/M=20 recipe at full width (4096 envs and bank)."""
    return TrainConfig(
        env=EnvConfig(L=2, M=20), dqn=DQNConfig(batch_size=128),
        actor_fusion=fusion, num_envs=4096, bank_capacity=4096,
        replay_capacity=131072, warmup_steps=1000,
        total_steps=chunks * log_every, log_every=log_every, seed=0)


def phase_trainer() -> dict:
    """The trainer path at full width with the fused actor (counted)."""
    print("trainer path: L=2 M=20, 4096 envs, bank 4096, replay 131072, "
          "batch 128, actor_fusion 8")
    K, chunks, log_every = 8, 4, 64
    cfg = train_config(K, chunks, log_every)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    bank = ConfigBank(2, 20, capacity=4096, seed=0, device=DEV).fill_device()
    sync()
    fill_s = time.perf_counter() - t0
    trainer = DQNTrainer(cfg, bank=bank, device=DEV)
    hist = trainer.train(log_fn=lambda m: print("  " + m))["history"]
    launches = _build.LAUNCHES["actor"]
    phases = chunks * log_every // K
    check(launches == phases, f"actor kernel launched {launches}x = {phases} phases")
    check(trainer.state.updates_done > 0,
          f"updates_done {trainer.state.updates_done} > 0")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["q_mean"]) for r in hist),
          "loss and Q finite")
    check(trainer.state.replay.size == min(131072, 4096 * chunks * log_every),
          f"replay holds {trainer.state.replay.size} transitions")
    last = hist[-1]
    print(f"  bank fill {fill_s:.2f} s; last chunk {last['steps_per_s']:.4e} "
          f"env-steps/s, learner share {last['learner_share']:.3f}")

    ev = trainer.evaluate(n_episodes=1024)
    check(ev["unfinished"] == 0.0 and ev["episodes"] == 1024,
          f"greedy evaluation over 1024 episodes (win rate {ev['win_rate']:.4f})")
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    try:
        save_train_state(str(ckpt), trainer.state)
        save_bank(str(ckpt), trainer.bank)
        fresh = DQNTrainer(cfg, bank=restore_bank(str(ckpt), DEV), device=DEV)
        fresh.restore_checkpoint(str(ckpt))
        check(all(torch.equal(a, b) for a, b in zip(
            trainer.state.net.parameters(), fresh.state.net.parameters()))
            and fresh.state.global_step == trainer.state.global_step
            and fresh.state.replay.size == trainer.state.replay.size,
            "checkpoint written and restored")
        check(fresh.evaluate(n_episodes=1024) == ev,
              "restored trainer evaluates identically")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"launches": launches, "env_steps_per_s": last["steps_per_s"],
            "learner_share": last["learner_share"], "win_rate": ev["win_rate"]}


def phase_trainer_per_step() -> dict:
    """For comparison: the same recipe on the per-step path (actor_fusion=0,
    plain PyTorch actor, one learner update per env step as in the fused
    path's K updates per K steps)."""
    print("per-step trainer (actor_fusion 0), same recipe")
    seen = []
    carve = device_carver.generate_batch_device

    def spy(*args, generator=None, **kw):
        seen.append(generator.initial_seed())
        return carve(*args, generator=generator, **kw)

    device_carver.generate_batch_device = spy
    try:
        bank = ConfigBank(2, 20, capacity=4096, seed=0, device=DEV).fill_device()
    finally:
        device_carver.generate_batch_device = carve
    fill_seed = random.Random(0).randint(0, 2**31 - 1)
    check(seen == [fill_seed], f"the bank's fill carved from a generator seeded "
          f"{seen}, one draw of the bank's random.Random(0): {fill_seed}")
    trainer = DQNTrainer(train_config(0, 2, 32), bank=bank, device=DEV)

    def first_resets(seed: int) -> torch.Tensor:
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return torch.randint(0, 4096, (4096,), generator=gen, device=DEV)

    trainer_seed = trainer.state.gen.initial_seed()
    check(trainer_seed != fill_seed
          and not torch.equal(first_resets(trainer_seed), first_resets(fill_seed)),
          f"the trainer's stream (seed {trainer_seed}) is not the fill's: its first "
          f"4096 reset rows differ from those the fill's generator would draw")
    last = trainer.train(log_fn=lambda m: print("  " + m))["history"][-1]
    check(np.isfinite(last["loss"]) and trainer.state.updates_done > 0,
          "per-step path trains")
    print(f"  last chunk {last['steps_per_s']:.4e} env-steps/s, "
          f"learner share {last['learner_share']:.3f}")
    return {"env_steps_per_s": last["steps_per_s"],
            "learner_share": last["learner_share"]}


def replay_status(cols, pieces, rots, locs, L: int, M: int):
    """Final state of recorded solutions played through ``bitboard.step``,
    finished envs frozen."""
    state = bb.make_state_batch(cols, pieces, L, M)
    for i in range(M):
        res = bb.step(state, rots[:, i], locs[:, i])
        state = bb.state_where(state.status != 0, state, res.state)
    return state


def forward_checks(fb, L: int, M: int, cap: int) -> None:
    win = fb.winnable
    idx = win.nonzero()[:, 0]
    st = replay_status(fb.boards[idx], fb.pieces[idx], fb.rotations[idx],
                       fb.locations[idx], L, M)
    n_moves = fb.n_moves[idx]
    check(bool((st.status == 1).all()) and bool((st.lines_cleared >= L).all())
          and torch.equal(st.moves_used, n_moves),
          f"all {idx.numel()} winners replay to WIN in their n_moves")
    # one move clears at most 4 lines
    lo, hi = int(n_moves.min()), int(n_moves.max())
    check(-(-L // 4) <= lo and hi <= M and not bool(fb.n_moves[~win].any()),
          f"winners' n_moves in [{lo}, {hi}] within [ceil(L/4), M]; losers 0")
    check(int((20 - bb._ctz20(fb.boards)).max()) <= cap,
          f"prefill heights <= {cap}")
    n_bags = (M + 1) // 7
    bags = fb.pieces[:, :7 * n_bags].reshape(-1, n_bags, 7).sort(dim=-1).values
    check(bool((bags == torch.arange(7, device=DEV, dtype=torch.int8)).all()),
          f"every 7-slot of the sequences is a permutation ({n_bags} bags)")


def phase_forward() -> dict:
    """The device forward generator and beam prover (no kernel of its own:
    plain PyTorch, as the JAX package's is XLA)."""
    out = {}
    gen = torch.Generator(device=DEV).manual_seed(0)
    for L, M in ((2, 20), (10, 30)):
        n, cap, beam = 1024, 4, 8
        print(f"forward generator: n={n}, L={L}/M={M}, height {cap}, beam {beam}")
        times, yields = [], []
        for rep in range(4):
            sync()
            t0 = time.perf_counter()
            fb = device_forward.generate_batch_device(
                n, L, M, cap, beam, generator=gen, device=DEV)
            sync()
            if rep:  # the first call is the warm-up
                times.append(time.perf_counter() - t0)
            yields.append(float(fb.winnable.float().mean()))
        ms = float(np.median(times)) * 1e3
        print(f"  {ms:.1f} ms per chunk (median of {times}); yields {yields}")
        forward_checks(fb, L, M, cap)
        cand = (fb.boards[:256], fb.pieces[:256])
        for b in (8, 1):
            card = device_forward.prove_batch_device(*cand, L, M, beam_width=b)
            cpu = device_forward.prove_batch_device(
                cand[0].cpu(), cand[1].cpu(), L, M, beam_width=b)
            check(all(torch.equal(x.cpu(), y) for x, y in zip(card, cpu)),
                  f"beam {b}: card and CPU provers identical on 256 candidates "
                  f"({int(cpu[0].sum())} proven)")
        out[f"L{L}_M{M}"] = {"chunk_ms": ms, "chunk_ms_all": [t * 1e3 for t in times],
                             "yields": yields}
    return out


def phase_trainer_forward() -> dict:
    """The trainer on a 25% forward-family bank refreshed every chunk, then
    the held-out bank (counted)."""
    print("trainer path, forward bank: L=2 M=20, 4096 envs, bank 4096 with 25% "
          "forward rows, refresh every chunk, actor_fusion 8")
    K, chunks, log_every = 8, 4, 64
    cfg = train_config(K, chunks, log_every)
    sync()
    t0 = time.perf_counter()
    bank = ConfigBank(2, 20, capacity=4096, seed=0, device=DEV).fill_device(
        forward_fraction=0.25)
    sync()
    fill_s = time.perf_counter() - t0
    check(bank.family_counts["forward"] >= 0.98 * 1024,
          f"fill: {bank.family_counts}")
    refresh_s, forward_rows = [], []
    refresh = bank.refresh_device

    def timed_refresh(*args, **kw):
        sync()
        t = time.perf_counter()
        out = refresh(*args, **kw)
        sync()
        refresh_s.append(time.perf_counter() - t)
        forward_rows.append(bank.family_counts["forward"])
        return out

    bank.refresh_device = timed_refresh
    trainer = DQNTrainer(cfg, bank=bank, device=DEV)
    _build.reset_launch_counts()
    hist = trainer.train(log_fn=lambda m: print("  " + m), device_refresh_every=1,
                         device_forward_fraction=0.25)["history"]
    launches = _build.LAUNCHES["actor"]
    phases = chunks * log_every // K
    check(launches == phases, f"actor kernel launched {launches}x = {phases} phases")
    check(len(refresh_s) == chunks - 1
          and all(f >= 0.98 * 1024 for f in forward_rows),
          f"{len(refresh_s)} refreshes, forward rows {forward_rows} >= 98% of 1024")
    check(all(np.isfinite(r["loss"]) for r in hist), "loss finite")
    last = hist[-1]
    print(f"  bank fill {fill_s:.2f} s; refreshes {refresh_s} s; last chunk "
          f"{last['steps_per_s']:.4e} env-steps/s (refresh inside), learner share "
          f"{last['learner_share']:.3f}")

    sync()
    t0 = time.perf_counter()
    holdout = make_holdout_bank(2, 20, 1024, train_bank=trainer.bank,
                                forward_seed_budget=100, device=DEV)
    sync()
    holdout_s = time.perf_counter() - t0
    fams = holdout.family_counts
    check(not (holdout.row_keys() & trainer.bank.row_keys())
          and fams["carve"] > 0 and fams["forward"] > 0,
          f"holdout built in {holdout_s:.2f} s, disjoint from training, {fams}")
    evals = {}
    for name, b in (("holdout", holdout),
                    ("holdout_carve", holdout.subset(FAMILY_CARVE)),
                    ("holdout_forward", holdout.subset(FAMILY_FORWARD))):
        ev = trainer.evaluate(n_episodes=1024, bank=b)
        check(ev["unfinished"] == 0.0, f"{name}: win rate {ev['win_rate']:.4f}")
        evals[name] = ev["win_rate"]
    return {"fill_s": fill_s, "refresh_s": refresh_s, "forward_rows": forward_rows,
            "env_steps_per_s": last["steps_per_s"],
            "learner_share": last["learner_share"], "holdout_s": holdout_s,
            "holdout_families": fams, "win_rates": evals, "launches": launches}


# -- the learner and the training recipe (no kernel of their own) --------------

def flax_tree(net: convnet.ConvQNetwork, impl: str) -> dict:
    """``net``'s weights as the JAX package's parameter tree of ``impl``
    (numpy), the layout ``convnet.params_from_flax`` reads."""
    sd = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    dense = lambda w, b: {"kernel": w.T.copy(), "bias": b}  # noqa: E731
    hwio = lambda w, b: {"kernel": w.transpose(2, 3, 1, 0).copy(), "bias": b}  # noqa: E731
    p, n = {}, len(net.channels)
    for i in range(n):
        w, b = sd[f"convs.{i}.weight"], sd[f"convs.{i}.bias"]
        if impl == "im2col":   # patch features ordered (c, kh, kw)
            p[f"Dense_{i}"] = dense(w.reshape(w.shape[0], -1), b)
        else:
            p[f"Conv_{i}"] = hwio(w, b)
    if net.bottleneck:
        p["Conv_0" if impl == "im2col" else f"Conv_{n}"] = hwio(
            sd["narrow.weight"], sd["narrow.bias"])
    d = n if impl == "im2col" else 0
    heads = ("value", "adv") if net.dueling else ("out",)
    names = ["dense.0", "dense.1"] + [f"head.{h}" for h in heads]
    for k, name in enumerate(names):
        p[f"Dense_{d + k}"] = dense(sd[f"{name}.weight"], sd[f"{name}.bias"])
    return {"params": p}


def flagship_net(seed: int, **kw) -> convnet.ConvQNetwork:
    """The README's flagship net: conv (32, 64) + dueling + joint."""
    return convnet.ConvQNetwork(channels=(32, 64), dueling=True, joint=True,
                                generator=torch.Generator().manual_seed(seed), **kw)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place (same-sign values)."""
    ia = a.view(torch.int16).int().cpu()
    ib = b.view(torch.int16).int().cpu()
    return int((ia - ib).abs().max())


def random_transitions(rng, n: int) -> list:
    """One step's packed transition fields (numpy), ~1 in 5 terminal."""
    boards = adversarial_boards(rng, 2 * n)
    w = (1 << np.arange(20, dtype=np.int64))[:, None]
    cols = (boards.astype(np.int64) * w).sum(axis=-2).astype(np.int32)
    i8 = lambda hi: rng.integers(0, hi, n).astype(np.int8)  # noqa: E731
    i32 = lambda hi: rng.integers(0, hi, n).astype(np.int32)  # noqa: E731
    return [cols[:n], i8(7), i8(7), i32(11), i32(31), i8(4), i8(10),
            rng.choice([-10.0, 0.0, 1.0, 10.0], n).astype(np.float32),
            rng.random(n) < 0.2, cols[n:], i8(7), i8(7), i32(11), i32(31), i8(3)]


def phase_learner_checks() -> dict:
    """Card against CPU on identical inputs, TF32 off: the conv net, the
    bf16-moment optimizer, the demo rollout and the n-step/PER sampler."""
    out = {}
    rng = np.random.default_rng(21)
    obs = bb.observe(make_state(rng, 1024, 10, 30))
    q_err = {}
    for dueling in (False, True):
        for joint in (False, True):
            base = convnet.ConvQNetwork(
                dueling=dueling, joint=joint,
                generator=torch.Generator().manual_seed(2 * dueling + joint))
            with torch.no_grad():   # nonzero biases
                gen = torch.Generator().manual_seed(7)
                for name, prm in base.named_parameters():
                    if name.endswith("bias"):
                        prm.normal_(0.0, 0.05, generator=gen)
                want = base(obs.cpu())
            for impl in ("conv", "im2col"):
                net = convnet.ConvQNetwork(dueling=dueling, joint=joint, impl=impl)
                net.load_state_dict(convnet.params_from_flax(flax_tree(base, impl), net))
                with torch.no_grad():
                    check(torch.equal(net(obs.cpu()), want),
                          f"conv net from the {impl} tree (dueling={dueling}, "
                          f"joint={joint}) equals its source on the CPU")
                    got = net.to(DEV)(obs)
                err = float((got.cpu() - want).abs().max())
                q_err[f"{impl}_d{int(dueling)}_j{int(joint)}"] = err
                check(err <= 1e-4, f"conv net {impl} dueling={dueling} joint={joint}: "
                      f"card Q within 1e-4 of the CPU ({err:.2e})")
    half = convnet.ConvQNetwork(dueling=True, joint=True, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = half(obs.cpu())
        err = float((half.to(DEV)(obs).cpu() - want).abs().max())
    check(err <= 5e-2, f"bf16 torso: card Q within 5e-2 of the CPU ({err:.2e})")
    out["conv_q_max_abs_err"], out["conv_bf16_q_max_abs_err"] = q_err, err

    # three bf16-moment optimizer steps on the same gradients
    cfg = DQNConfig(opt_state_bf16=True)
    nets = [flagship_net(4) for _ in range(2)]
    nets[1].to(DEV)
    opts = [agent_lib.make_optimizer(n, cfg) for n in nets]
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        for prm_c, prm_d in zip(nets[0].parameters(), nets[1].parameters()):
            g = torch.randn(prm_c.shape, generator=gen) * 10.0 ** torch.randint(
                -4, 1, prm_c.shape, generator=gen)
            prm_c.grad, prm_d.grad = g, g.to(DEV)
        for o in opts:
            o.step()
    ulps = max(bf16_ulps(a, b.cpu()) for f in ("mu", "nu", "nu_max")
               for a, b in zip(getattr(opts[0], f), getattr(opts[1], f)))
    check(ulps <= 1 and all(m.dtype == torch.bfloat16 for m in opts[1].mu),
          f"bf16 moments after 3 steps: card = CPU within {ulps} bf16 ulp")
    p_err = max(float((a - b.cpu()).detach().abs().max())
                for a, b in zip(nets[0].parameters(), nets[1].parameters()))
    check(p_err <= 1e-6, f"parameters within 1e-6 ({p_err:.2e})")
    out["bf16_moment_ulps"], out["bf16_param_max_abs_err"] = ulps, p_err

    # the demo rollout of one prover batch, word for word
    L, M = 10, 30
    fb = device_forward.generate_batch_device(
        256, L, M, 8, 8, generator=torch.Generator(device=DEV).manual_seed(6), device=DEV)
    bank = ConfigBank(L, M, capacity=64, seed=0, device=DEV).fill_device()
    cfg = TrainConfig(env=EnvConfig(L=L, M=M), num_envs=64, bank_capacity=64,
                      replay_capacity=1024, demo_every=1, demo_capacity=8192, seed=0)
    bufs = []
    for dev, b in ((DEV, bank), ("cpu", ConfigBank.from_rows(
            L, M, bank.cols.cpu(), bank.pieces.cpu()))):
        tr = DQNTrainer(cfg, bank=b, device=dev)
        tr._demo_rollout(*(x.to(dev) for x in (fb.boards, fb.pieces, fb.rotations,
                                               fb.locations, fb.n_moves)))
        bufs.append(tr._demo.buf)
    check(all(torch.equal(bufs[0][k].cpu(), bufs[1][k]) for k in bufs[1]),
          f"demo rollout of 256 candidates at L={L}/M={M} "
          f"({int(fb.winnable.sum())} proven): card = CPU word for word")

    # the n-step / PER sample from given base indices, and the write-back
    cap, gap, B = 32768, 4096, 128
    rpls = [ReplayBuffer(cap, DEV), ReplayBuffer(cap, "cpu")]
    for _ in range(cap // gap):
        f = random_transitions(rng, gap)
        for r in rpls:
            r.add_fields(*(torch.as_tensor(x, device=r.device) for x in f))
    prio = rng.gamma(1.0, 1.0, cap).astype(np.float32) + 1e-3
    for r in rpls:
        r.priority.copy_(torch.as_tensor(prio))
    idx0 = torch.as_tensor(rng.integers(0, cap - 2 * gap, B))
    kw = dict(gamma=0.99, n_step=3, step_gap=gap, alpha=0.6, beta=0.4)
    bd, _ = rpls[0].sample_ext(B, prioritized=True, idx0=idx0.to(DEV), **kw)
    bc, _ = rpls[1].sample_ext(B, prioritized=True, idx0=idx0, **kw)
    check(all(torch.equal(getattr(bd, f).cpu(), getattr(bc, f)) for f in
              ("obs", "next_obs", "rot", "col", "reward", "done", "discount")),
          "n-step PER sample from given bases: card = CPU (all but the weights)")
    w_err = float((bd.weight.cpu() - bc.weight).abs().max())
    check(w_err <= 1e-6, f"importance weights within 1e-6 ({w_err:.2e})")
    idx = torch.as_tensor(rng.integers(0, 50, B))   # many duplicates
    td = torch.as_tensor(rng.random(B).astype(np.float32))
    for r in rpls:
        r.update_priority(idx.to(r.device), td.to(r.device), 1e-3)
    check(torch.equal(rpls[0].priority.cpu(), rpls[1].priority)
          and float(rpls[0].max_prio) == float(rpls[1].max_prio),
          "priority write-back with duplicate indices: card = CPU")
    out["per_weight_max_abs_err"] = w_err
    return out


class cudnn_tf32:
    """cuDNN's TF32 as the trainer runs it (PyTorch's default, on) inside a
    training phase; the checks around it keep TF32 off."""

    def __enter__(self):
        self.old = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.old


def timed(obj, name: str, log: list, after=None) -> None:
    """Wrap ``obj.name`` so every call's synchronised wall time (and
    ``after()``'s reading) is appended to ``log``."""
    fn = getattr(obj, name)

    def run(*args, **kw):
        sync()
        t = time.perf_counter()
        res = fn(*args, **kw)
        sync()
        log.append((time.perf_counter() - t, after() if after else None))
        return res

    setattr(obj, name, run)


def recipe_config(L: int, M: int, chunks: int, log_every: int, dqn=None,
                  **kw) -> TrainConfig:
    """``tools/round5d.sh``'s flag set: 2048 envs, bank 4096, replay 131072,
    batch 128, 4 updates per step."""
    return TrainConfig(
        env=EnvConfig(L=L, M=M), dqn=dqn or DQNConfig(batch_size=128),
        num_envs=2048, bank_capacity=4096, replay_capacity=131072,
        warmup_steps=1000, updates_per_step=4,
        total_steps=chunks * log_every, log_every=log_every, seed=0, **kw)


def learner_ms_per_update(row: dict, num_envs: int, n_steps: int) -> float:
    chunk_ms = n_steps * num_envs / row["steps_per_s"] * 1e3
    return row["learner_share"] * chunk_ms / max(row["updates"], 1)


def checkpoint_round_trip(trainer: DQNTrainer, make, episodes: int) -> None:
    """Save the trainer and its bank, restore both into ``make(bank)``, and
    check weights, optimizer state and a greedy evaluation agree."""
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    try:
        save_train_state(str(ckpt), trainer.state)
        save_bank(str(ckpt), trainer.bank)
        fresh = make(restore_bank(str(ckpt), DEV))
        fresh.restore_checkpoint(str(ckpt))
        a, b = trainer.state, fresh.state
        check(all(torch.equal(x, y) for x, y in zip(a.net.parameters(), b.net.parameters()))
              and all(torch.equal(x, y) for f in ("mu", "nu", "nu_max")
                      for x, y in zip(getattr(a.opt, f), getattr(b.opt, f)))
              and a.opt.count == b.opt.count and a.global_step == b.global_step,
              f"checkpoint restores weights and {a.opt.mu[0].dtype} moments")
        check(fresh.evaluate(episodes, seed=9) == trainer.evaluate(episodes, seed=9),
              "restored trainer evaluates identically")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def phase_flagship_demo() -> dict:
    """Round 5's D2 recipe at full width (counted: no kernel runs on it)."""
    L, M, chunks, log_every = 10, 30, 3, 64
    print(f"flagship demo trainer: L={L} M={M}, conv (32,64) + dueling + joint, "
          "2048 envs, bank 4096, replay 131072, batch 128, updates 4, 25% "
          "forward, refresh 1, height 8:4, demos 1024 rows every chunk, "
          "ratio 0.25, margin 0.8")
    cfg = recipe_config(L, M, chunks, log_every, demo_every=1, demo_ratio=0.25,
                        demo_rows=1024, demo_margin=0.8)
    with cudnn_tf32():
        sync()
        t0 = time.perf_counter()
        bank = ConfigBank(L, M, capacity=4096, seed=0, device=DEV).fill_device(
            forward_fraction=0.25, initial_height_max=8)
        sync()
        fill_s = time.perf_counter() - t0
        n_fwd = int(bank.capacity * 0.25)
        check(bank.family_counts["forward"] >= 0.98 * n_fwd, f"fill: {bank.family_counts}")
        trainer = DQNTrainer(cfg, bank=bank, net=flagship_net(0), device=DEV)
        refreshes, demos = [], []
        timed(bank, "refresh_device", refreshes,
              after=lambda: bank.family_counts["forward"])
        timed(trainer, "_refresh_demo", demos,
              after=lambda: (trainer._demo.size, bool(trainer._demo.buf["done"].all())))
        hist = trainer.train(log_fn=lambda m: print("  " + m), device_refresh_every=1,
                             device_forward_fraction=0.25, device_height=(8, 4))["history"]
    full = (cfg.demo_capacity, True)
    check(len(demos) == chunks and all(d == full for _, d in demos),
          f"{len(demos)} demo refreshes, each leaving {[d for _, d in demos]} "
          f"(rows, all done) = {full}")
    check(len(refreshes) == chunks - 1 and all(f >= 0.98 * n_fwd for _, f in refreshes),
          f"{len(refreshes)} bank refreshes, forward rows "
          f"{[f for _, f in refreshes]} >= 98% of {n_fwd}")
    check(all(np.isfinite(r["loss"]) for r in hist), "loss finite")
    # learning starts once the replay holds max(warmup, batch) transitions
    idle = -(-max(cfg.warmup_steps, 128) // cfg.num_envs) - 1
    n_upd = trainer.state.updates_done
    check(n_upd == 4 * (chunks * log_every - idle),
          f"updates_done {n_upd} = 4 per step once learning starts (step {idle})")
    last = hist[-1]
    upd_ms = learner_ms_per_update(last, cfg.num_envs, log_every)
    demo_s, refresh_s = [d[0] for d in demos], [r[0] for r in refreshes]
    print(f"  bank fill {fill_s:.2f} s; bank refreshes {refresh_s} s; demo "
          f"refreshes {demo_s} s; last chunk {last['steps_per_s']:.4e} "
          f"env-steps/s, learner share {last['learner_share']:.3f}, "
          f"{upd_ms:.3f} ms per update")

    sync()
    t0 = time.perf_counter()
    holdout = make_holdout_bank(L, M, 2048, train_bank=trainer.bank,
                                forward_seed_budget=0, device=DEV)
    sync()
    holdout_s = time.perf_counter() - t0
    fams = holdout.family_counts
    check(not (holdout.row_keys() & trainer.bank.row_keys())
          and fams["carve"] > 0 and fams["forward"] > 0,
          f"holdout built in {holdout_s:.2f} s, disjoint from training, {fams}")
    evals = {}
    for name, b in (("holdout", holdout),
                    ("holdout_carve", holdout.subset(FAMILY_CARVE)),
                    ("holdout_forward", holdout.subset(FAMILY_FORWARD))):
        ev = trainer.evaluate(n_episodes=2048, bank=b)
        check(ev["unfinished"] == 0.0, f"{name}: win rate {ev['win_rate']:.4f}")
        evals[name] = ev["win_rate"]
    checkpoint_round_trip(
        trainer, lambda b: DQNTrainer(cfg, bank=b, net=flagship_net(1), device=DEV), 1024)
    return {"fill_s": fill_s, "bank_refresh_s": refresh_s, "demo_refresh_s": demo_s,
            "env_steps_per_s": last["steps_per_s"],
            "learner_share": last["learner_share"], "learner_ms_per_update": upd_ms,
            "holdout_s": holdout_s, "holdout_families": fams, "win_rates": evals}


def phase_adaptive_bf16() -> dict:
    """Round 5's V recipe with bf16 moments (E1) at L=5/M=25."""
    L, M, chunks, log_every = 5, 25, 3, 64
    print(f"adaptive-share trainer: L={L} M={M}, the flagship flags, 50% forward, "
          "adaptive share (rule v2, every chunk), bf16 moments")
    cfg = recipe_config(L, M, chunks, log_every,
                        dqn=DQNConfig(batch_size=128, opt_state_bf16=True))
    with cudnn_tf32():
        bank = ConfigBank(L, M, capacity=4096, seed=0, device=DEV).fill_device(
            forward_fraction=0.5)
        trainer = DQNTrainer(cfg, bank=bank, net=flagship_net(0), device=DEV)
        probes = []
        timed(trainer, "evaluate", probes)
        hist = trainer.train(log_fn=lambda m: print("  " + m), device_refresh_every=1,
                             device_forward_fraction=0.5, adaptive_share=True,
                             adapt_every=1, adapt_rule="v2")["history"]
    share = 0.5
    for r in hist[1:]:
        share = adapt_share_v2(share, r["probe_carve"], r["probe_forward"])
        check(r["forward_share"] == round(share, 4),
              f"share {r['forward_share']} = adapt_share_v2 of probes "
              f"({r['probe_carve']:.4f}, {r['probe_forward']:.4f})")
    check(len(probes) == 2 * (chunks - 1), f"{len(probes)} probe evaluations")
    opt = trainer.state.opt
    check(isinstance(opt, agent_lib.AmsgradBf16)
          and all(m.dtype == torch.bfloat16 for m in opt.mu + opt.nu + opt.nu_max),
          "moments stored in bfloat16")
    check(all(np.isfinite(r["loss"]) for r in hist), "loss finite")
    last = hist[-1]
    upd_ms = learner_ms_per_update(last, cfg.num_envs, log_every)
    probe_s = [p[0] for p in probes]
    print(f"  probe evaluations {probe_s} s; last chunk {last['steps_per_s']:.4e} "
          f"env-steps/s, learner share {last['learner_share']:.3f}, {upd_ms:.3f} ms "
          "per update")
    checkpoint_round_trip(
        trainer, lambda b: DQNTrainer(cfg, bank=b, net=flagship_net(1), device=DEV), 1024)
    return {"shares": [r.get("forward_share") for r in hist],
            "probes": [(r.get("probe_carve"), r.get("probe_forward")) for r in hist],
            "probe_eval_s": probe_s, "env_steps_per_s": last["steps_per_s"],
            "learner_share": last["learner_share"], "learner_ms_per_update": upd_ms}


def phase_nstep_per() -> dict:
    """phase_trainer's fused-actor recipe with 3-step returns and
    prioritized replay (counted: the actor kernel runs every phase)."""
    K, chunks, log_every = 8, 2, 32
    # warmup raised so that the n-step threshold, 30000 + 2 * 4096 = 38192
    # transitions, falls between the first phase (32768) and the second
    warmup = 30000
    print("n-step/PER trainer: L=2 M=20, 4096 envs, bank 4096, replay 131072, "
          f"batch 128, actor_fusion 8, n_step 3, PER, warmup {warmup}")
    cfg = TrainConfig(
        env=EnvConfig(L=2, M=20),
        dqn=DQNConfig(batch_size=128, n_step=3, prioritized=True),
        actor_fusion=K, num_envs=4096, bank_capacity=4096, replay_capacity=131072,
        warmup_steps=warmup, total_steps=chunks * log_every, log_every=log_every,
        seed=0)
    bank = ConfigBank(2, 20, capacity=4096, seed=0, device=DEV).fill_device()
    trainer = DQNTrainer(cfg, bank=bank, device=DEV)
    rpl = trainer.state.replay
    writes = []
    write = rpl.update_priority

    def logged(idx, td, eps):
        writes.append((idx.clone(), td.clone()))
        return write(idx, td, eps)

    rpl.update_priority = logged
    _build.reset_launch_counts()
    hist = trainer.train(log_fn=lambda m: print("  " + m))["history"]
    launches = _build.LAUNCHES["actor"]
    phases = chunks * log_every // K
    check(launches == phases, f"actor kernel launched {launches}x = {phases} phases")
    n_upd = trainer.state.updates_done
    check(n_upd == (phases - 1) * K,
          f"updates_done {n_upd}: learning from the second phase "
          f"(threshold {max(warmup, 128) + 2 * 4096} transitions)")
    idx, td = writes[-1]
    last = {}
    for i, v in zip(idx.tolist(), (td + cfg.dqn.per_eps).tolist()):
        last[i] = v
    keys = torch.as_tensor(list(last), device=DEV)
    vals = torch.as_tensor(list(last.values()), device=DEV)
    check(len(writes) == n_upd and torch.equal(rpl.priority[keys], vals),
          f"{len(writes)} priority write-backs; the last one's {keys.numel()} slots "
          "hold |td| + eps (last duplicate wins)")
    check(all(np.isfinite(r["loss"]) for r in hist), "loss finite")
    row = hist[-1]
    upd_ms = learner_ms_per_update(row, cfg.num_envs, log_every)
    print(f"  last chunk {row['steps_per_s']:.4e} env-steps/s, learner share "
          f"{row['learner_share']:.3f}, {upd_ms:.3f} ms per update")
    return {"launches": launches, "env_steps_per_s": row["steps_per_s"],
            "learner_share": row["learner_share"], "learner_ms_per_update": upd_ms}


# -- the host generators, the default bank, the array engine, the curriculum --

def phase_host_carves() -> dict:
    """Host carves with recorded solutions, uploaded as the bank uploads its
    rows, read back, and replayed to WIN by the card's step."""
    L, M, n = 2, 20, 256
    print(f"host carver: {n} carves with solutions at L={L}/M={M}, uploaded")
    rng = random.Random(7)
    t0 = time.perf_counter()
    carves = [CarvingGenerator(L, M, rng=rng, record_solution=True).generate()
              for _ in range(n)]
    carve_s = time.perf_counter() - t0
    cols_h, pieces_h = pack_host_rows([(b, p) for b, p, _ in carves], M + 1)
    cols, pieces = cols_h.to(DEV), pieces_h.to(DEV)
    boards = np.stack([b for b, _, _ in carves])
    check(torch.equal(cols.cpu(), cols_h) and torch.equal(pieces.cpu(), pieces_h)
          and np.array_equal(bb.unpack_board(cols).cpu().numpy(), boards),
          "upload round trip: packed rows and unpacked boards word for word")
    moves = np.zeros((n, M, 2), np.int64)
    n_moves = torch.as_tensor([len(sol) for _, _, sol in carves], device=DEV)
    for i, (_, _, sol) in enumerate(carves):
        moves[i, :len(sol)] = sol
    moves = torch.as_tensor(moves, device=DEV)
    st = replay_status(cols, pieces, moves[..., 0], moves[..., 1], L, M)
    check(bool((st.status == 1).all()) and bool((st.lines_cleared >= L).all())
          and torch.equal(st.moves_used, n_moves.to(torch.int32)),
          f"all {n} recorded solutions replay to WIN on the card in their "
          f"{int(n_moves.min())}..{int(n_moves.max())} moves")
    print(f"  {carve_s / n * 1e3:.3f} ms per host carve")
    return {"host_carve_ms": carve_s / n * 1e3}


def phase_default_bank_trainer() -> dict:
    """The trainer with no bank given (the host fill), training with the
    fused actor while the producer processes refresh the bank (counted)."""
    K, chunks, log_every, cap = 8, 16, 128, 1024
    print(f"default-bank trainer: L=2 M=20, 4096 envs, host-filled bank {cap} "
          "(75% carves), replay 131072, batch 128, actor_fusion 8, refresh_bank")
    cfg = dataclasses.replace(train_config(K, chunks, log_every), bank_capacity=cap)
    t0 = time.perf_counter()
    trainer = DQNTrainer(cfg, device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    print(f"  trainer init (the host fill) {init_s:.2f} s")
    bank = trainer.bank
    check(bank.family_counts == {"carve": 768, "forward": 256},
          f"default bank families {bank.family_counts}")
    rng = random.Random(cfg.seed)
    carves = [CarvingGenerator(2, 20, rng=rng).generate() for _ in range(768)]
    cols_h, pieces_h = pack_host_rows(carves, 21)
    check(torch.equal(bank.cols[:768].cpu(), cols_h)
          and torch.equal(bank.pieces[:768].cpu(), pieces_h),
          "the bank's 768 carve rows read back equal to the host carver's")
    swaps = []
    swap = bank._swap_rows

    def timed_swap(fresh, family):
        t = time.perf_counter()
        swap(fresh, family)
        swaps.append((time.perf_counter() - t, len(fresh), family, t - t0))

    bank._swap_rows = timed_swap
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    hist = trainer.train(log_fn=lambda m: print("  " + m), refresh_bank=True)["history"]
    wall = time.perf_counter() - t0
    launches = _build.LAUNCHES["actor"]
    phases = chunks * log_every // K
    check(launches == phases, f"actor kernel launched {launches}x = {phases} phases")
    writes = bank.refresh_writes
    first = swaps[0][3] if swaps else float("nan")
    check(writes > 0 and writes == sum(s[1] for s in swaps),
          f"the refresh wrote {writes} rows in {len(swaps)} swaps, the first "
          f"{first:.2f} s into the {wall:.2f} s run")
    check(all(r["bank_families"]["forward"] <= cap // 4 for r in hist)
          and bank.family_counts["forward"] <= cap // 4,
          f"forward share at or below the cap of {cap // 4} rows: "
          f"{[r['bank_families']['forward'] for r in hist]}")
    check(not bank._pool.slots and not multiprocessing.active_children(),
          "no producer process left alive")
    cols, pieces = bank.rows
    check(int(pieces.min()) >= 0 and int(pieces.max()) <= 6
          and int((cols >> 20).abs().sum()) == 0, "bank rows stay well formed")
    check(all(np.isfinite(r["loss"]) for r in hist), "loss finite")
    swap_s = sum(s[0] for s in swaps)
    on = hist[-1]
    off = trainer.train(total_steps=2 * log_every, log_fn=lambda m: print("  " + m))[
        "history"][-1]
    print(f"  {writes / (wall - first):.1f} refresh rows/s from the first write "
          f"on ({len(swaps)} swaps, {swap_s:.3f} s in "
          f"_swap_rows); last chunk {on['steps_per_s']:.4e} env-steps/s with the "
          f"refresh, {off['steps_per_s']:.4e} without; learner share "
          f"{on['learner_share']:.3f} / {off['learner_share']:.3f}")
    ckpt = ROOT / "build" / "chip_smoke_default_ckpt"
    trainer.save_checkpoint(str(ckpt))
    return {"launches": launches, "init_fill_s": init_s, "refresh_writes": writes,
            "refresh_rows_per_s": writes / (wall - first), "train_wall_s": wall,
            "first_write_s": first,
            "swaps": len(swaps), "swap_s": swap_s,
            "env_steps_per_s_refresh": on["steps_per_s"],
            "env_steps_per_s_no_refresh": off["steps_per_s"],
            "learner_share_refresh": on["learner_share"],
            "learner_share_no_refresh": off["learner_share"], "ckpt": str(ckpt)}


def phase_array_engine() -> dict:
    """The readable array engine on the card against the bitboard step on
    the card (and the array engine on the CPU), word for word."""
    n, L, M = 4096, 2, 20
    print(f"array engine vs bitboard on the card: N={n}, L={L}/M={M}, garbage actions")
    rng = np.random.default_rng(5)
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1))
    st_a = array_engine.make_state_batch(torch.as_tensor(boards, device=DEV),
                                         torch.as_tensor(pieces, device=DEV), L, M)
    st_c = array_engine.make_state_batch(torch.as_tensor(boards),
                                         torch.as_tensor(pieces), L, M)
    st_b = bb.make_state_batch(torch.as_tensor(boards, device=DEV),
                               torch.as_tensor(pieces, device=DEV), L, M)
    lines = 0
    for k in range(M + 4):
        rot = rng.integers(-3, 1000, n)
        loc = rng.integers(-6, 16, n)
        args = [torch.as_tensor(a, device=DEV) for a in (rot, loc)]
        ra, rb = array_engine.step(st_a, *args), bb.step(st_b, *args)
        rc = array_engine.step(st_c, torch.as_tensor(rot), torch.as_tensor(loc))
        if not (states_equal(bb.from_env_state(ra.state), rb.state)
                and torch.equal(array_engine.observe(st_a), bb.observe(st_b))
                and all(torch.equal(x.cpu(), y) for x, y in zip(ra.state, rc.state))):
            check(False, f"step {k}: array engine equals the bitboard and the CPU")
        lines += int(ra.lines_delta.sum())
        st_a, st_b, st_c = ra.state, rb.state, rc.state
    check(lines > 0, f"{M + 4} steps word for word (card array = card bitboard = "
          f"CPU array; {lines} lines cleared)")
    return {"steps": M + 4, "envs": n}


@contextlib.contextmanager
def fed_draws(gen: torch.Generator, draws: list, record: bool):
    """Inside, ``torch.rand`` / ``torch.randint`` from ``gen`` append what
    they draw to ``draws`` (``record``), or return its items in order, on
    the device asked for: the same drawn inputs for two runs."""
    rand, randint = torch.rand, torch.randint

    def fed(fn):
        def call(*args, generator=None, device=None, **kw):
            if generator is not gen:
                return fn(*args, generator=generator, device=device, **kw)
            if record:
                draws.append(fn(*args, generator=generator, device=device, **kw).cpu())
                return draws[-1].to(device)
            return draws.pop(0).to(device)
        return call

    torch.rand, torch.randint = fed(rand), fed(randint)
    try:
        yield
    finally:
        torch.rand, torch.randint = rand, randint


def curriculum_chunk_card_vs_cpu(levels, bank, bank_cpu) -> float:
    """One ``run_chunk`` on the card and on the CPU from one fresh state
    (1024 envs, a mixed level array, the replay filling past the warmup at
    step 2), on the card's draws fed to both. Returns the weights' largest
    difference."""
    steps = 24
    cfg = TrainConfig(env=EnvConfig(L=1, M=10), dqn=DQNConfig(batch_size=128),
                      num_envs=1024, bank_capacity=1024, replay_capacity=131072,
                      warmup_steps=2000, seed=1)
    build = cur_lib.build_curriculum_bank
    try:
        cur_lib.build_curriculum_bank = lambda *a, device=None, **k: (
            bank if torch.device(device).type == "cuda" else bank_cpu)
        card = CurriculumTrainer(levels, cfg=cfg, seed=1, device=DEV)
        host = CurriculumTrainer(levels, cfg=cfg, seed=1, device="cpu")
    finally:
        cur_lib.build_curriculum_bank = build
    level = np.random.default_rng(3).integers(0, 3, 1024)
    card.level = host.level = level
    host.state.env = bb.PackedState(*(x.cpu() for x in card.state.env))
    check(all(torch.equal(a.cpu(), b) for a, b in zip(
        card.state.net.state_dict().values(), host.state.net.state_dict().values())),
        "curriculum chunk: the card's and the CPU's trainers start from one state")
    w0 = card.state.net.state_dict()["dense.0.weight"].clone()
    draws: list = []
    with fed_draws(card.state.gen, draws, record=True):
        c_eps, c_wins, c_loss = card.run_chunk(steps)
    n_draws = len(draws)
    with fed_draws(host.state.gen, draws, record=False):
        h_eps, h_wins, h_loss = host.run_chunk(steps)
    check(not draws and n_draws == 4 * steps + steps - 1,
          f"curriculum chunk: the CPU took the card's {n_draws} draws, "
          f"{steps - 1} steps of updates")
    env_ok = all(torch.equal(a.cpu(), b) for a, b in zip(card.state.env, host.state.env))
    cr, hr = card.state.replay, host.state.replay
    ring_ok = (cr.pos, cr.size) == (hr.pos, hr.size) and all(
        torch.equal(cr.buf[k].cpu(), hr.buf[k]) for k in cr.buf)
    tally_ok = torch.equal(c_eps.cpu(), h_eps) and torch.equal(c_wins.cpu(), h_wins)
    err = max(float((a.cpu() - b).abs().max()) for net in ("net", "target_net")
              for a, b in zip(getattr(card.state, net).state_dict().values(),
                              getattr(host.state, net).state_dict().values()))
    moved = float((card.state.net.state_dict()["dense.0.weight"] - w0).abs().max())
    check(env_ok and ring_ok and tally_ok and err <= 1e-4 and moved > 0
          and bool((h_eps > 0).all()),
          f"curriculum chunk, {steps} steps at levels {np.bincount(level).tolist()}: "
          f"card = CPU word for word in envs, ring ({hr.size} rows) and tallies "
          f"(episodes {h_eps.long().tolist()}, wins {h_wins.long().tolist()}); "
          f"weights and target within {err:.3e} (<= 1e-4); loss {float(c_loss):.6f} / "
          f"{float(h_loss):.6f}")
    return err


def phase_curriculum() -> dict:
    """The curriculum trainer at full width (no kernel of its own: the JAX
    curriculum runs the XLA step too)."""
    levels = [(1, 10), (2, 15), (3, 20)]
    chunks, chunk = 3, 100
    print("curriculum trainer: levels 1:10,2:15,3:20, 1024 envs, bank 1024 per "
          f"level, replay 131072, batch 128, {chunks} chunks of {chunk} steps")
    cfg = TrainConfig(env=EnvConfig(L=1, M=10), dqn=DQNConfig(batch_size=128),
                      num_envs=1024, bank_capacity=1024, replay_capacity=131072,
                      warmup_steps=1000, seed=0)
    seen = []
    carve = cur_lib.generate_batch_device

    def spy(*args, generator=None, **kw):
        seen.append(generator.initial_seed())
        return carve(*args, generator=generator, **kw)

    cur_lib.generate_batch_device = spy
    try:
        sync()
        t0 = time.perf_counter()
        tr = CurriculumTrainer(levels, cfg=cfg, seed=0, device=DEV)
        sync()
        bank_s = time.perf_counter() - t0
    finally:
        cur_lib.generate_batch_device = carve
    bank = tr.bank
    seeds = cur_lib.level_seeds(0, len(levels))
    check(seen == seeds, f"the levels' banks carved from generators seeded {seen}, "
          f"one draw each of random.Random(0): {seeds}")
    P = bank.pieces.shape[2]
    for k, (L, M) in enumerate(levels):
        gen = torch.Generator(device=DEV).manual_seed(seeds[k])
        again = carve(1024, L, M, generator=gen, device=DEV)
        pad = torch.randint(0, 7, (1024, P - M - 1), generator=gen, device=DEV)
        check(torch.equal(again.boards, bank.boards[k])
              and torch.equal(again.pieces, bank.pieces[k, :, :M + 1])
              and torch.equal(pad.to(torch.int8), bank.pieces[k, :, M + 1:]),
              f"level {k}'s bank carved again on the card from seed {seeds[k]}: "
              "the same boards and pieces")

    def first_resets(seed: int) -> torch.Tensor:
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return torch.randint(0, 1024, (1024,), generator=gen, device=DEV)

    trainer_seed = tr.state.gen.initial_seed()
    rows = first_resets(trainer_seed)
    check(tr.state.gen.device.type == bank.boards.device.type == DEV.type
          and torch.equal(tr.state.env.cols, bank.boards[0, rows])
          and trainer_seed not in seen
          and not any(torch.equal(rows, first_resets(x)) for x in seen),
          f"the trainer's stream on the card (seed {trainer_seed}) is no level's: "
          "its first 1024 reset rows differ from those each level's generator "
          "would draw")
    bank_cpu = cur_lib.CurriculumBank(*(x.cpu() for x in bank))
    rng = np.random.default_rng(2)
    level = torch.as_tensor(rng.integers(0, 3, 1024))
    idx = torch.as_tensor(rng.integers(0, 1024, 1024))
    st = cur_lib.make_states(bank, level.to(DEV), idx.to(DEV))
    st_c = cur_lib.make_states(bank_cpu, level, idx)
    dones = 0
    for k in range(24):
        rot, loc, ridx = (torch.as_tensor(rng.integers(0, hi, 1024)) for hi in (4, 10, 1024))
        st, res = cur_lib.step_autoreset_curriculum(
            st, rot.to(DEV), loc.to(DEV), bank, level.to(DEV), ridx.to(DEV))
        st_c, _ = cur_lib.step_autoreset_curriculum(st_c, rot, loc, bank_cpu, level, ridx)
        if not all(torch.equal(x.cpu(), y) for x, y in zip(st, st_c)):
            check(False, f"step {k}: card and CPU step_autoreset_curriculum agree")
        dones += int(res.done.sum())
    check(dones > 1024, f"24 steps word for word, card against CPU ({dones} resets)")
    chunk_err = curriculum_chunk_card_vs_cpu(levels, bank, bank_cpu)
    hist = tr.train(total_steps=chunks * chunk, chunk=chunk,
                    log_fn=lambda m: print("  " + m))
    check(all(np.isfinite(r["loss"]) for r in hist) and hist[-1]["loss"] > 0,
          "loss finite, learning on")
    check(sum(hist[-1]["level_distribution"]) == 1024, "every env has a level")
    t0 = time.perf_counter()
    ev = tr.evaluate_levels(episodes_per_level=256)
    eval_s = time.perf_counter() - t0
    check(all(r["win_rate"] + r["loss_rate"] == 1.0 for r in ev),
          f"greedy evaluation per level ends every episode: "
          f"{[round(r['win_rate'], 4) for r in ev]}")
    last = hist[-1]
    print(f"  bank {bank_s:.2f} s; last chunk {last['steps_per_s']:.4e} env-steps/s; "
          f"evaluation {eval_s:.2f} s")
    return {"bank_s": bank_s, "env_steps_per_s": last["steps_per_s"],
            "train_win_rates": [r["win_rate_per_level"] for r in hist],
            "level_distribution": last["level_distribution"],
            "eval_win_rates": [r["win_rate"] for r in ev], "eval_s": eval_s,
            "chunk_card_vs_cpu_max_abs_err": chunk_err}


def phase_per_env_goals() -> dict:
    """``make_state_batch`` with per-env goals and limits (numpy on one side,
    tensors on the card on the other), card against CPU word for word."""
    n, M = 4096, 20
    print(f"per-env goals: N={n}, goals 1..5, limits 4..19, both engines, card vs CPU")
    rng = np.random.default_rng(6)
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1))
    goals = np.arange(n) % 5 + 1
    limits = np.arange(n) % 16 + 4
    ended = 0
    for name, mod in (("bitboard", bb), ("array", array_engine)):
        card = mod.make_state_batch(torch.as_tensor(boards, device=DEV),
                                    torch.as_tensor(pieces, device=DEV),
                                    torch.as_tensor(goals, device=DEV),
                                    torch.as_tensor(limits, device=DEV))
        cpu = mod.make_state_batch(torch.as_tensor(boards), torch.as_tensor(pieces),
                                   goals, limits)
        check(torch.equal(card.lines_goal.cpu(), torch.as_tensor(goals, dtype=torch.int32))
              and torch.equal(card.move_limit.cpu(), torch.as_tensor(limits, dtype=torch.int32)),
              f"{name}: per-env goals and limits on the card")
        for _ in range(8):
            rot, loc = rng.integers(0, 4, n), rng.integers(0, 10, n)
            card = mod.step(card, torch.as_tensor(rot, device=DEV),
                            torch.as_tensor(loc, device=DEV)).state
            cpu = mod.step(cpu, torch.as_tensor(rot), torch.as_tensor(loc)).state
        check(all(torch.equal(x.cpu(), y) for x, y in zip(card, cpu)),
              f"{name}: 8 steps, card = CPU word for word")
        ended = int((cpu.status != 0).sum())
    return {"envs": n, "ended_after_8_steps": ended}


def phase_profile_mfu() -> dict:
    """The training benchmark at full width, its chunk cut from 512 steps to
    32, then a profiled tiny ``cli train`` (no kernel of the port runs:
    ``measure`` is the per-step path, ``actor_fusion=0``, as in JAX)."""
    from tetris_piclim_tpu_torch import bench_mfu
    from tetris_piclim_tpu_torch.utils import mfu as mfu_lib

    scan, updates = 32, 4
    print(f"bench_mfu.measure: 2048 envs, conv (32,64) dueling joint, bf16 "
          f"torso, L=5/M=25, bank 1024, {updates} updates per step; the chunk "
          f"cut from 512 steps to {scan}")
    peak = mfu_lib.peak_flops(DEV)
    check(peak is not None, f"BF16 peak of {torch.cuda.get_device_name(0)}: {peak}")
    with cudnn_tf32():
        mm = bench_mfu.measure(num_envs=2048, scan=scan, updates=updates,
                               bf16=True, device=DEV)
    for k in ("chunk_mfu", "learner_mfu", "actor_mfu"):
        check(mm[k] is not None and 0 < mm[k] <= 1, f"{k} = {mm[k]} in (0, 1]")
    check(0 < mm["learner_share_of_chunk"] <= 1.05,
          f"learner share of the chunk {mm['learner_share_of_chunk']} in (0, 1.05]")
    ms_per_update = mm["learner_s_per_chunk_equiv"] / (scan * updates) * 1e3
    print(f"  {mm['chunk_env_steps_per_s']:.4e} env-steps/s, chunk MFU "
          f"{mm['chunk_mfu']}, learner {ms_per_update:.3f} ms per update "
          f"({mm['learner_gflops_per_update']} GFLOP), actor forward "
          f"{mm['actor_forward_us']} us")

    logdir = ROOT / "build" / "chip_smoke_trace"
    shutil.rmtree(logdir, ignore_errors=True)
    print("cli train --profile-dir: L=1/M=8, 64 envs, 8 steps")
    try:
        run_cli(["train", "-L", "1", "-M", "8", "--num-envs", "64", "--bank", "64",
                 "--device-bank", "--replay", "1024", "--warmup", "64", "--steps",
                 "8", "--log-every", "4", "--eval-episodes", "64",
                 "--profile-dir", str(logdir)])
        traces = list(logdir.glob("*.json"))
        check(len(traces) == 1, f"one trace written: {[t.name for t in traces]}")
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        check(kernels > 0, f"the trace parses: {len(events)} events, "
              f"{kernels} CUDA kernel events")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return {"measure": mm, "scan_cut_from": 512, "learner_ms_per_update": ms_per_update,
            "trace_events": len(events), "trace_kernel_events": kernels}


# -- phase 16: data-parallel training (parallel/) --------------------------------

MULTIGPU_DIR = ROOT / "build" / "chip_smoke_multigpu"
MULTIGPU_TIMEOUT = 420.0   # seconds a launch of the ranks may take


def multigpu_recipes() -> dict:
    """(a)'s recipes: name -> (config, net maker)."""
    return {"mlp_fused": (train_config(8, 2, 64), lambda: None),
            "flagship_per_step": (recipe_config(5, 25, 2, 32), lambda: flagship_net(0))}


def config_bank(cfg: TrainConfig) -> ConfigBank:
    return ConfigBank(cfg.env.L, cfg.env.M, capacity=cfg.bank_capacity, seed=0,
                      device=DEV).fill_device()


def deterministic_card() -> None:
    """TF32 off, as in main(), and cuDNN's and PyTorch's deterministic
    algorithms, so that two runs of one program agree bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def metrics_of(row: dict) -> dict:
    return {k: row[k] for k in ("episodes", "win_rate", "lines", "reward", "loss",
                                "q_mean", "updates")}


def worker_one_rank_nccl(out: Path) -> dict:
    """(a), in a child: each recipe trained without a mesh and on a
    one-rank NCCL mesh from the same seed, in turns (plain, mesh, mesh,
    plain, since the host's speed drifts within a process); every run must
    agree word for word with the first."""
    from tetris_piclim_tpu_torch.parallel import init_distributed, make_mesh

    deterministic_card()
    info = init_distributed(device=DEV)
    mesh = make_mesh(device=DEV)
    res = {"backend": info["backend"], "world": mesh.size, "recipes": {}}
    for name, (cfg, make_net) in multigpu_recipes().items():
        bank = config_bank(cfg)
        runs = []
        for label, m in (("plain", None), ("mesh", mesh), ("mesh", mesh),
                         ("plain", None)):
            trainer = DQNTrainer(cfg, bank=bank, net=make_net(), device=DEV, mesh=m)
            _build.reset_launch_counts()
            hist = trainer.train(log_fn=None)["history"]
            sync()
            runs.append((label, trainer.state, hist, _build.LAUNCHES["actor"]))
        _, a, ha, _ = runs[0]
        same = {"params_equal": True, "env_equal": True, "metrics_equal": True}
        for _, b, hb, _ in runs[1:]:
            same["params_equal"] &= all(torch.equal(x, y) for x, y in zip(
                a.net.state_dict().values(), b.net.state_dict().values()))
            same["env_equal"] &= all(torch.equal(x, y) for x, y in zip(a.env, b.env))
            same["metrics_equal"] &= ([metrics_of(x) for x in ha]
                                      == [metrics_of(y) for y in hb])
        rate = {label: [] for label in ("plain", "mesh")}
        ms = {label: [] for label in ("plain", "mesh")}
        for label, _, h, _ in runs:
            rate[label].append(h[-1]["steps_per_s"])
            ms[label].append(learner_ms_per_update(h[-1], cfg.num_envs, cfg.log_every))
        res["recipes"][name] = {
            **same, "updates": runs[1][1].updates_done,
            "actor_launches_mesh": runs[1][3], "episodes": ha[-1]["episodes"],
            "env_steps_per_s": rate, "ms_per_update": ms}
    return res


def two_rank_configs() -> tuple:
    """(b)'s per-step and fused configs: the L=2/M=20 recipe at full width,
    3 learning steps, and one fused phase of 8 steps."""
    per_step = dataclasses.replace(train_config(0, 1, 3), warmup_steps=1)
    return per_step, train_config(8, 1, 8)


def worker_two_ranks_gloo(out: Path, n_mesh=None) -> dict:
    """(b), in each of two children on the one card: the per-step chunk and
    a fused phase on a 2-rank gloo mesh; rank 0 writes what the parent
    checks against one process. With ``n_mesh=2`` (phase 17 (b), three
    children) the mesh is ``make_mesh(2)``, and the third rank gets none
    and only reports."""
    from tetris_piclim_tpu_torch.parallel import init_distributed, make_mesh
    from tetris_piclim_tpu_torch.parallel.mesh import all_gather

    deterministic_card()
    info = init_distributed(device=DEV)
    mesh = make_mesh(n_mesh, device=DEV)
    if mesh is None:
        return {"backend": info["backend"], "world": None,
                "rank": torch.distributed.get_rank()}
    per_step, fused = two_rank_configs()
    bank = config_bank(per_step)
    dumps = {}
    for name, cfg, steps in (("per_step", per_step, 3), ("fused", fused, 8)):
        trainer = DQNTrainer(cfg, bank=bank, device=DEV, mesh=mesh)
        m = trainer.run_chunk(steps)
        env = {k: all_gather(mesh, v).flatten(0, 1).cpu()
               for k, v in trainer.state.env._asdict().items()}
        dumps[name] = {"episodes": int(m.episodes), "wins": int(m.wins),
                       "reward": float(m.reward), "env": env,
                       "updates": trainer.state.updates_done,
                       "net": {k: v.cpu() for k, v in trainer.state.net.state_dict().items()}}
    if mesh.is_root:
        torch.save(dumps, out / "two_ranks.pt")
    return {"backend": info["backend"], "world": mesh.size,
            "device": info["device"]}


def phase_multigpu() -> dict:
    """Data-parallel training over torch.distributed (A18). One card holds
    one NCCL rank, so (a) a one-rank NCCL mesh in a child process, word for
    word against the trainer without a mesh, and (b) two gloo ranks in two
    children sharing the card, against one process. No scaling is measured."""
    from tetris_piclim_tpu_torch.parallel.distributed import launch_local

    shutil.rmtree(MULTIGPU_DIR, ignore_errors=True)
    MULTIGPU_DIR.mkdir(parents=True)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"   # for the children
    try:
        print("multi-GPU (a): one NCCL rank, L=2/M=20 MLP fused (4096 envs, 2x64 "
              "steps) and the flagship per-step net (L=5/M=25, 2048 envs, 4 "
              "updates, 2x32 steps), each against no mesh, in turns")
        t0 = time.perf_counter()
        out = launch_local(1, [ROOT / "chip_smoke.py", "--multigpu-worker", "nccl1",
                               MULTIGPU_DIR], timeout=MULTIGPU_TIMEOUT)
        a = json.loads(out[0].strip().splitlines()[-1])
        check(a["backend"] == "nccl" and a["world"] == 1,
              f"child joined a one-rank {a['backend']} group "
              f"({time.perf_counter() - t0:.1f} s)")
        for name, r in a["recipes"].items():
            check(r["params_equal"] and r["env_equal"] and r["metrics_equal"],
                  f"{name}: one-rank NCCL mesh = no mesh, word for word "
                  f"(parameters, env state, chunk metrics; {r['updates']} updates)")
            rate, ms = r["env_steps_per_s"], r["ms_per_update"]
            print(f"  {name}: env-steps/s {rate['plain']} without a mesh, "
                  f"{rate['mesh']} with it; ms per update {ms['plain']} and "
                  f"{ms['mesh']}")
        phases = 2 * 64 // 8
        launches = a["recipes"]["mlp_fused"]["actor_launches_mesh"]
        check(launches == phases,
              f"actor kernel launched {launches}x = {phases} phases under the mesh")

        print("multi-GPU (b): two gloo ranks on one card, L=2/M=20, 4096 envs: "
              "3 per-step steps, one fused phase of 8")
        t0 = time.perf_counter()
        outs = launch_local(2, [ROOT / "chip_smoke.py", "--multigpu-worker", "gloo2",
                                MULTIGPU_DIR], timeout=MULTIGPU_TIMEOUT)
        b = json.loads(outs[0].strip().splitlines()[-1])
        check(b["backend"] == "gloo" and b["world"] == 2,
              f"two ranks joined a gloo group on {b['device']} "
              f"({time.perf_counter() - t0:.1f} s)")
        got = torch.load(MULTIGPU_DIR / "two_ranks.pt", weights_only=False)
        check_two_ranks(got)
        return {"one_rank_nccl": a["recipes"], "two_rank_gloo_s": time.perf_counter() - t0}
    finally:
        shutil.rmtree(MULTIGPU_DIR, ignore_errors=True)


def check_two_ranks(got: dict) -> None:
    """(b)'s checks, against one process on the card: the per-step chunk as
    ``tests/test_parallel.py`` holds JAX's sharded chunk (episodes and wins
    exact, reward rtol 1e-5, parameters atol 1e-5), the fused phase word for
    word against the actor on each half with seed and seed + 7919."""
    per_step, fused = two_rank_configs()
    bank = config_bank(per_step)
    one = DQNTrainer(per_step, bank=bank, device=DEV)
    m = one.run_chunk(3)
    g = got["per_step"]
    check(g["updates"] == one.state.updates_done > 0
          and g["episodes"] == int(m.episodes) and g["wins"] == int(m.wins),
          f"per-step: {g['updates']} updates, episodes {g['episodes']} and wins "
          f"{g['wins']} as one process")
    check(abs(g["reward"] - float(m.reward)) <= 1e-5 * abs(float(m.reward)),
          f"per-step: reward {g['reward']} vs {float(m.reward)} (rtol 1e-5)")
    diff = max(float((g["net"][k] - v.cpu()).abs().max())
               for k, v in one.state.net.state_dict().items())
    check(diff <= 1e-5, f"per-step: parameters within {diff:.3g} <= 1e-5")
    check(all(torch.equal(g["env"][k], v.cpu()) for k, v in one.state.env._asdict().items()),
          "per-step: env state equal")

    one = DQNTrainer(fused, bank=bank, device=DEV)
    ts, dqn, K = one.state, fused.dqn, fused.actor_fusion
    cols, pieces = bank.rows
    kb = min(256, cols.shape[0])
    off = int(torch.randint(0, cols.shape[0] - kb + 1, (), generator=ts.host_gen))
    seed = int(torch.randint(0, 2**31 - 1, (), generator=ts.host_gen))
    half = fused.num_envs // 2
    halves, episodes, wins = [], 0, 0
    for r in range(2):
        env = bb.PackedState(*[f[r * half:(r + 1) * half].contiguous() for f in ts.env])
        env, _, e, w = actor_ops.actor_rollout_fused(
            env, ts.net, cols[off:off + kb], pieces[off:off + kb], 0, seed + r * 7919,
            eps_start=dqn.eps_start, eps_end=dqn.eps_end, eps_decay=dqn.eps_decay,
            n_steps=K)
        halves.append(env)
        episodes, wins = episodes + int(e), wins + int(w)
    g = got["fused"]
    check(all(torch.equal(g["env"][k], torch.cat([h[i] for h in halves]).cpu())
              for i, k in enumerate(bb.PackedState._fields)),
          "fused: each rank's envs = the actor kernel on its half with seed + rank*7919")
    check((g["episodes"], g["wins"]) == (episodes, wins),
          f"fused: episodes {g['episodes']} and wins {g['wins']} summed over the ranks")


# -- phase 17: the mesh's host refresh, a sub-mesh, entry() ----------------------

MESH_REFRESH_CHUNKS, MESH_REFRESH_STEPS = 4, 128
PRODUCER_WAIT_S = 120.0   # the producers' first rows take 7-9 s on the H100's host


def mesh_refresh_config() -> TrainConfig:
    """``cli train``'s default-bank recipe as phase 10 runs it: L=2/M=20,
    4096 envs, a 1024-row host bank, ``actor_fusion=8``."""
    return dataclasses.replace(
        train_config(8, MESH_REFRESH_CHUNKS, MESH_REFRESH_STEPS), bank_capacity=1024)


def worker_mesh_refresh(out: Path) -> dict:
    """(a), in each of two children sharing the card over gloo: the trainer
    with no bank given (rank 0 fills it) and ``refresh_bank=True``. Each
    rank writes the rows every chunk read and times each chunk's bank
    broadcast (synchronised); rank 0 waits before the last chunk until the
    producers' first rows have landed."""
    from tetris_piclim_tpu_torch.dqn import train as train_mod
    from tetris_piclim_tpu_torch.parallel import init_distributed, make_mesh
    from tetris_piclim_tpu_torch.parallel.mesh import STAGED

    info = init_distributed(device=DEV)
    mesh = make_mesh(device=DEV)
    cfg = mesh_refresh_config()
    t0 = time.perf_counter()
    trainer = DQNTrainer(cfg, device=DEV, mesh=mesh)
    sync()
    init_s = time.perf_counter() - t0
    shard, bcast_ms = train_mod.shard_bank, []

    def timed_shard(m, bank):
        sync()
        t = time.perf_counter()
        shard(m, bank)
        sync()
        bcast_ms.append((time.perf_counter() - t) * 1e3)
        return bank

    train_mod.shard_bank = timed_shard
    run, rows_read, waited = trainer.run_chunk, [], []

    def recorded(n, rows=None):
        rows_read.append(tuple(t.to("cpu", copy=True) for t in rows))
        m = run(n, rows)
        if mesh.is_root and len(rows_read) == MESH_REFRESH_CHUNKS - 1:
            t = time.perf_counter()
            while (trainer.bank.refresh_writes == 0
                   and time.perf_counter() - t < PRODUCER_WAIT_S):
                time.sleep(0.05)
            waited.append(time.perf_counter() - t)
        return m

    trainer.run_chunk = recorded
    staged0 = STAGED["broadcasts"]
    _build.reset_launch_counts()
    hist = trainer.train(log_fn=None, refresh_bank=True)["history"]
    sync()
    launches = _build.LAUNCHES["actor"]
    torch.save(rows_read, out / f"refresh_rank{mesh.rank}.pt")
    pool = trainer.bank._pool
    return {"backend": info["backend"], "world": mesh.size, "rank": mesh.rank,
            "init_s": init_s, "launches": launches, "bcast_ms": bcast_ms,
            "waited_s": waited, "staged": STAGED["broadcasts"] - staged0,
            "started_producers": pool is not None,
            "producers_alive": bool(pool is not None and pool.slots),
            "children": len(multiprocessing.active_children()),
            "writes": [r["bank_writes"] for r in hist],
            "families": [r["bank_families"] for r in hist],
            "env_steps_per_s": [r["steps_per_s"] for r in hist],
            "loss_finite": all(np.isfinite(r["loss"]) for r in hist)}


def phase_mesh_extras() -> dict:
    """(a) the host refresh on a two-rank gloo mesh sharing the card, (b) a
    two-rank sub-mesh of three gloo ranks against one process, (c)
    ``entry()`` on the card against the CPU."""
    from tetris_piclim_tpu_torch.parallel.distributed import launch_local

    shutil.rmtree(MULTIGPU_DIR, ignore_errors=True)
    MULTIGPU_DIR.mkdir(parents=True)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"   # for the children
    try:
        print(f"mesh (a): two gloo ranks on one card, refresh_bank, L=2/M=20, 4096 "
              f"envs, host bank 1024, actor_fusion 8, {MESH_REFRESH_CHUNKS} chunks "
              f"of {MESH_REFRESH_STEPS} steps")
        t0 = time.perf_counter()
        outs = launch_local(2, [ROOT / "chip_smoke.py", "--multigpu-worker", "refresh2",
                                MULTIGPU_DIR], timeout=MULTIGPU_TIMEOUT)
        a = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        check(all(r["backend"] == "gloo" and r["world"] == 2 for r in a),
              f"two ranks trained on a gloo mesh ({time.perf_counter() - t0:.1f} s; "
              f"rank 0's init with the host fill {a[0]['init_s']:.2f} s, rank 1's "
              f"{a[1]['init_s']:.2f} s)")
        rows = [torch.load(MULTIGPU_DIR / f"refresh_rank{r}.pt") for r in range(2)]
        check(len(rows[0]) == len(rows[1]) == MESH_REFRESH_CHUNKS
              and all(torch.equal(x, y) for c0, c1 in zip(*rows) for x, y in zip(c0, c1)),
              "every chunk read the same bank rows on both ranks, word for word")
        check(a[0]["writes"][-1] > 0 and a[0]["writes"] == a[1]["writes"]
              and a[0]["families"] == a[1]["families"],
              f"the producers wrote {a[0]['writes']} rows by each chunk's end "
              f"(rank 0 waited {a[0]['waited_s'][0]:.2f} s before the last "
              f"chunk); both ranks log {a[0]['families'][-1]}")
        check(not all(torch.equal(x, y) for x, y in zip(rows[0][0], rows[0][-1])),
              "the last chunk stepped on the producers' rows")
        check(a[0]["started_producers"] and not a[1]["started_producers"]
              and not a[0]["producers_alive"] and a[0]["children"] == a[1]["children"] == 0,
              "rank 0 alone ran producers, and none outlived the call")
        phases = MESH_REFRESH_CHUNKS * MESH_REFRESH_STEPS // 8
        check(all(r["launches"] == phases for r in a),
              f"actor kernel launched {[r['launches'] for r in a]}x = {phases} "
              "phases on each rank")
        check(all(r["staged"] == 0 for r in a) and all(r["loss_finite"] for r in a),
              "no broadcast staged through the card; loss finite")
        print(f"  bank broadcast ms per chunk (1024 rows, synchronised): rank 0 "
              f"{a[0]['bcast_ms']}, rank 1 {a[1]['bcast_ms']}; env-steps/s "
              f"{a[0]['env_steps_per_s']}")

        print("mesh (b): three gloo ranks on one card, make_mesh(2): the two-rank "
              "trainer (3 per-step steps, one fused phase) against one process")
        t0 = time.perf_counter()
        outs = launch_local(3, [ROOT / "chip_smoke.py", "--multigpu-worker", "submesh3",
                                MULTIGPU_DIR], timeout=MULTIGPU_TIMEOUT)
        b = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        check([r["world"] for r in b] == [2, 2, None],
              f"ranks 0-1 got a two-rank mesh, rank 2 none "
              f"({time.perf_counter() - t0:.1f} s)")
        check_two_ranks(torch.load(MULTIGPU_DIR / "two_ranks.pt", weights_only=False))
        ent = phase_entry()
        return {"refresh": {"bcast_ms": [r["bcast_ms"] for r in a],
                            "writes": a[0]["writes"], "waited_s": a[0]["waited_s"],
                            "init_s": [r["init_s"] for r in a],
                            "env_steps_per_s": a[0]["env_steps_per_s"],
                            "launches": [r["launches"] for r in a]},
                "submesh_s": time.perf_counter() - t0, "entry": ent}
    finally:
        shutil.rmtree(MULTIGPU_DIR, ignore_errors=True)


def phase_entry() -> dict:
    """``entry()`` on the card against the same steps on the CPU (TF32 is
    off, as main() sets it): the same weights, the card's draws; Q within
    1e-4, and actions and env state equal wherever an env explores or its
    top two Q values differ by more than 1e-4; three chained steps."""
    from tetris_piclim_tpu_torch import entry

    print("entry(): the flagship net on 256 envs, epsilon 0.05, card against CPU")
    step, (net, states, explore, rrot, rcol) = entry(DEV)
    _, (cnet, cstates, *_) = entry(device="cpu")
    check(all(torch.equal(a.cpu(), b) for a, b in zip(net.state_dict().values(),
                                                      cnet.state_dict().values()))
          and states_equal(bb.PackedState(*[f.cpu() for f in states]), cstates),
          "entry() gives the same weights and states on the card and the CPU")
    gen = torch.Generator(device=DEV).manual_seed(1)
    q_err, compared = 0.0, 0
    for k in range(3):
        with torch.no_grad():
            q = net(bb.observe_batch(states)).cpu()
            cs = bb.PackedState(*[f.cpu() for f in states])
            cq = cnet(bb.observe_batch(cs))
        q_err = max(q_err, float((q - cq).abs().max()))
        top2 = cq.topk(2, dim=1).values
        sure = ((top2[:, 0] - top2[:, 1]) > 1e-4) | (explore.cpu() < 0.05)
        new, lines, done = step(net, states, explore, rrot, rcol)
        cnew, clines, cdone = step(cnet, cs, explore.cpu(), rrot.cpu(), rcol.cpu())
        check(all(torch.equal(f.cpu()[sure], g[sure]) for f, g in zip(new, cnew)),
              f"step {k}: env state equal on {int(sure.sum())} of 256 envs "
              f"(Q within {q_err:.3g})")
        if bool(sure.all()):
            check(int(lines) == int(clines) and int(done) == int(cdone),
                  f"step {k}: lines {int(lines)} and dones {int(done)} as on the CPU")
        compared += int(sure.sum())
        states = new
        explore = torch.rand((256,), generator=gen, device=DEV)
        rrot = torch.randint(0, 4, (256,), generator=gen, device=DEV)
        rcol = torch.randint(0, 10, (256,), generator=gen, device=DEV)
    check(q_err <= 1e-4, f"Q within {q_err:.3g} <= 1e-4 over three steps")
    args = (net, states, explore, rrot, rcol)
    ms = cuda_ms(lambda: step(*args), 20)
    print(f"  entry forward_step {ms:.4f} ms on the card (256 envs)")
    return {"q_max_abs_err": q_err, "envs_compared": compared, "step_ms": ms}


TPU_PARAMS = ROOT / "results" / "tpu_L2M20_v2_params.npz"
TPU_EVAL = ROOT / "results" / "tpu_L2M20_v2_eval.npz"
TPU_GREEDY = 0.5632  # the TPU run's own greedy win rate (train_L2M20_v2_summary.json)


def tpu_net(device) -> QNetwork:
    net = QNetwork()
    net.load_state_dict(load_flax_npz(str(TPU_PARAMS), "cpu")[0])
    return net.to(device).eval()


def carried_status(net: QNetwork, ev: dict, device) -> np.ndarray:
    """Each episode's final status of the greedy policy on the carried rows
    at the carried draws."""
    idx = torch.as_tensor(ev["idx"], dtype=torch.long, device=device)
    cols = bb.pack_board(torch.as_tensor(ev["boards"], device=device))
    pieces = torch.as_tensor(ev["pieces"], device=device)
    env = bb.make_state_batch(cols[idx], pieces[idx], 2, 20)
    return agent_lib.greedy_rollout(net, env, 21, bb).status.cpu().numpy()


def top2_gap(q: torch.Tensor) -> torch.Tensor:
    top2 = q.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def phase_tpu_policy() -> dict:
    """The TPU-trained policy on the card: (i) the carried greedy
    evaluation, (ii) a fresh bank, (iii) the actor kernel on its weights."""
    with np.load(TPU_EVAL) as z:
        ev = {k: z[k] for k in z.files}
    net = tpu_net(DEV)

    print("TPU policy (i): greedy evaluation on the 4096 carried rows and draws, "
          "card against the port on the CPU")
    t0 = time.perf_counter()
    status = carried_status(net, ev, DEV)
    sync()
    card_s = time.perf_counter() - t0
    cpu_status = carried_status(tpu_net("cpu"), ev, "cpu")
    apart = int((status != cpu_status).sum())
    jax_apart = int((status != ev["status"]).sum())
    carried_wr = float((status == 1).mean())
    check(apart <= 2, f"{apart} of 4096 episodes end otherwise than on the CPU (<= 2); "
                      f"win rate {carried_wr} (CPU {float((cpu_status == 1).mean())}, "
                      f"JAX {float(ev['win_rate'])}, {jax_apart} episodes apart from "
                      f"JAX's; {card_s:.2f} s on the card)")

    print("TPU policy (ii): warm_start from the file, evaluate 4096 episodes of a "
          "fresh device-carved 4096-row bank (seed 5)")
    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=256, bank_capacity=4096,
                      replay_capacity=8192, seed=5)
    t0 = time.perf_counter()
    bank = ConfigBank(2, 20, capacity=4096, seed=5, device=DEV).fill_device()
    trainer = DQNTrainer(cfg, bank=bank, device=DEV)
    trainer.warm_start(str(TPU_PARAMS))
    fresh = trainer.evaluate(n_episodes=4096)
    fresh_s = time.perf_counter() - t0
    check(abs(fresh["win_rate"] - TPU_GREEDY) <= 0.03,
          f"win rate {fresh['win_rate']} within 0.03 of the TPU run's {TPU_GREEDY} "
          f"(bank fill and evaluation {fresh_s:.2f} s)")

    print("TPU policy (iii): actor kernel vs actor_reference on the trained weights, "
          "epsilon 0, N=4096, K=8, head 14, from the fresh bank's rows")
    n, K = 4096, 8
    window = (bank.cols[:256].contiguous(), bank.pieces[:256].contiguous())
    state = bb.make_state_batch(bank.cols, bank.pieces, 2, 20)
    draws = actor_draws(np.random.default_rng(18), K, n, 256)
    eps = dict(eps_start=0.0, eps_end=0.0, eps_decay=1000.0, n_steps=K)
    ker = actor_ops.actor_rollout_fused(state, net, *window, 0, 0, draws=draws,
                                        return_q=True, **eps)
    ref = actor_ops.actor_reference(state, net, *window, 0, draws=draws,
                                    return_q=True, **eps)
    sync()
    # an env is comparable at step k while all its earlier actions agreed
    in_sync = torch.ones(n, dtype=torch.bool, device=DEV)
    disagree = compared = 0
    q_err = worst_gap = 0.0
    for k in range(K):
        qk, qr = ker[4][k], ref[4][k]
        q_err = max(q_err, float((qk - qr).abs()[in_sync].max()))
        rot_off = ker[1].rot[k] != ref[1].rot[k]
        col_off = ker[1].col[k] != ref[1].col[k]
        off = in_sync & (rot_off | col_off)
        gap = torch.maximum(torch.where(rot_off, top2_gap(qr[:, :4]), 0.0),
                            torch.where(col_off, top2_gap(qr[:, 4:]), 0.0))
        if bool(off.any()):
            worst_gap = max(worst_gap, float(gap[off].max()))
        compared += int(in_sync.sum())
        disagree += int(off.sum())
        in_sync &= ~off
    agree = 1.0 - disagree / max(compared, 1)
    check(agree >= 0.999, f"actions agree on {agree:.6f} >= 0.999 of {compared} "
                          f"env-steps ({disagree} disagree; Q within {q_err:.3g})")
    check(worst_gap < 1e-4, f"every disagreement a near-tie: largest top-two gap "
                            f"{worst_gap:.3g} < 1e-4")
    return {"carried_win_rate": carried_wr, "carried_apart_from_cpu": apart,
            "carried_apart_from_jax": jax_apart, "carried_card_s": card_s,
            "fresh_bank_win_rate": fresh["win_rate"], "fresh_s": fresh_s,
            "actor_agree": agree, "actor_disagreements": disagree,
            "actor_env_steps_compared": compared, "actor_q_max_abs_err": q_err,
            "actor_largest_tie_gap": worst_gap}


# the port's flagship policies: the 175k-step one, and the 100k-step ones
# of unbroken runs at training seeds 0 and 1, whose replayed held-out
# win rates stand beside JAX's reading of its own 100k checkpoint
# (results/eval_r3_L5df.json), each with its band and whether the phase
# holds it: (JAX's win rate, band, held). A row is held where the run that
# made the file read inside its band, and reported otherwise: seed 0's
# forward row lies 0.0522 below JAX's, and its bank among ordinary draws of
# the held-out bank (phase 21; C-1 in ROADMAP.md section C).
FLAGSHIP_100K = {"flagship_L5M25_100k_h100_policy.npz": 0,
                 "flagship_L5M25_100k_seed1_h100_policy.npz": 1}
FLAGSHIP_POLICY = (ROOT / "results" / "flagship_L5M25_h100_policy.npz",
                   *(ROOT / "results" / name for name in FLAGSHIP_100K))
JAX_100K_BANDS = {"holdout": (0.7978515625, 0.03), "holdout_carve": (0.837646484375, 0.05),
                  "holdout_forward": (0.74755859375, 0.05)}
# per training seed, the rows its reading holds inside the band
FLAGSHIP_HELD = {0: ("holdout", "holdout_carve"),
                 1: ("holdout", "holdout_carve", "holdout_forward")}
FLAGSHIP_JAX_BANDS = {
    name: {key: (jax_rate, width, key in FLAGSHIP_HELD[seed])
           for key, (jax_rate, width) in JAX_100K_BANDS.items()}
    for name, seed in FLAGSHIP_100K.items()}
FLAGSHIP_TIE = 1e-3


def greedy_min_gap(net, env, n_steps: int):
    """``agent.greedy_rollout`` on the bitboard, and per env the smallest
    top-two Q gap of the actions it took while running."""
    gap = torch.full(env.status.shape, float("inf"), device=env.status.device)
    for _ in range(n_steps):
        q = net(bb.observe(env))
        rot, col = agent_lib.q_ops(q.shape[-1]).greedy(q)
        g = (top2_gap(q) if q.shape[-1] != 14
             else torch.minimum(top2_gap(q[:, :4]), top2_gap(q[:, 4:])))
        running = env.status == agent_lib.RUNNING
        gap = torch.where(running, torch.minimum(gap, g), gap)
        env = bb.state_where(~running, env, bb.step(env, rot, col).state)
    return env, gap


def phase_flagship_policy() -> dict:
    """Each of the port's own flagship policies on its carried held-out
    rows: the recorded win rates again, the card against the CPU, and for
    the 100k policies JAX's 100k bands."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is off")
    return {path.name: flagship_policy_file(path) for path in FLAGSHIP_POLICY}


def flagship_policy_file(path: Path) -> dict:
    """Phase 19 on one policy file, in under 60 s."""
    t0 = time.perf_counter()
    pol = read_policy_npz(str(path), DEV)
    meta = pol["meta"]
    rec = meta["eval"]
    L, M = meta["L"], meta["M"]
    hold = pol["banks"]["holdout"]
    print(f"flagship policy (i): {path.name}, step {meta['step']}, warm_start from the file, "
          f"8192 greedy episodes on the {hold.capacity} carried held-out rows, "
          f"families {hold.family_counts}")
    cfg = TrainConfig(env=EnvConfig(L=L, M=M), num_envs=64,
                      bank_capacity=pol["banks"]["train"].capacity,
                      replay_capacity=8192,
                      seed=meta.get("seed", 0))  # cli eval's: the run's seed
    trainer = DQNTrainer(cfg, bank=pol["banks"]["train"], net=flagship_net(0),
                         device=DEV)
    trainer.warm_start(str(path))
    banks = {"holdout": hold, "holdout_carve": hold.subset(FAMILY_CARVE),
             "holdout_forward": hold.subset(FAMILY_FORWARD), "train_bank": None}
    rates = {k: trainer.evaluate(8192, bank=b)["win_rate"] for k, b in banks.items()}
    sync()
    eval_s = time.perf_counter() - t0
    recorded = {k: rec[k]["win_rate"] for k in ("holdout", "holdout_carve",
                                                "holdout_forward")}
    recorded["train_bank"] = (rec.get("bank") or rec["train_bank"])["win_rate"]
    check(abs(rates["holdout"] - recorded["holdout"]) <= 0.005,
          f"held-out win rate {rates['holdout']} within 0.005 of the recorded "
          f"{recorded['holdout']} (all four {rates}, recorded {recorded}; "
          f"{eval_s:.2f} s)")
    with cudnn_tf32():  # as the reading ran: cuDNN's TF32 on, PyTorch's default
        as_run = {k: trainer.evaluate(8192, bank=b)["win_rate"] for k, b in banks.items()}
    check(as_run == recorded, f"with cuDNN's TF32 on, as the reading ran, all four "
          f"win rates {as_run} equal the recorded {recorded}")
    bands = FLAGSHIP_JAX_BANDS.get(path.name, {})
    verdicts = {}
    for key, (jax_rate, width, held) in bands.items():
        verdicts[key] = abs(rates[key] - jax_rate) <= width
        msg = (f"{key} win rate {rates[key]} within {width} of JAX's {jax_rate} "
               f"at the same step")
        if held:
            check(verdicts[key], msg)
        else:
            print(f"  reported, not held: {msg}: "
                  f"{'inside' if verdicts[key] else 'OUTSIDE'}")

    print("flagship policy (ii): the greedy episode of 256 held-out rows, card "
          "against CPU, TF32 off")
    n = 256
    cpu_net = flagship_net(0)
    cpu_net.load_state_dict({k: v.cpu() for k, v in pol["net"].items()})
    ends = []
    for net, dev in ((trainer.state.net, DEV), (cpu_net.eval(), torch.device("cpu"))):
        env = bb.make_state_batch(hold.cols[:n].to(dev), hold.pieces[:n].to(dev), L, M)
        with torch.no_grad():
            env, gap = greedy_min_gap(net, env, M + 1)
        ends.append((env.status.cpu(), gap.cpu()))
    (st_card, gap_card), (st_cpu, gap_cpu) = ends
    apart = st_card != st_cpu
    near_tie = torch.minimum(gap_card, gap_cpu) < FLAGSHIP_TIE
    check(bool((near_tie | ~apart).all()),
          f"{int(apart.sum())} of {n} episodes end otherwise on the card than on "
          f"the CPU, {int((apart & ~near_tie).sum())} of them with no top-two Q gap "
          f"under {FLAGSHIP_TIE} ({int(near_tie.sum())} rows meet such a near-tie)")
    total_s = time.perf_counter() - t0
    check(total_s < 60, f"phase 19 took {total_s:.1f} s (< 60) on {path.name}")
    return {"step": meta["step"], "win_rates": rates, "recorded": recorded,
            "win_rates_tf32": as_run,
            "jax_bands": {k: {"jax": j, "band": w, "held": held, "inside": verdicts[k]}
                          for k, (j, w, held) in bands.items()},
            "holdout_families": hold.family_counts, "eval_s": eval_s,
            "rows_compared": n, "episodes_apart": int(apart.sum()),
            "near_tie_rows": int(near_tie.sum()), "total_s": total_s}


CARVE_CUT = 40            # iterations: at L=5/M=25 about 40% of rows finish
POOL_TIMEOUT_S = 240.0    # the host pools' wall time may not exceed this
POOL_WORKERS = 8          # the card's host has 8 cores


def carver_draws(n: int, M: int, iters: int, seed: int) -> tuple:
    """The device carver's draws for ``iters`` iterations and the pad, made
    on the CPU from a seeded generator (as JAX's loop and pad draw them)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 7, (iters, n), generator=g),
            torch.randint(0, 4, (iters, n), generator=g),
            torch.rand((iters, n), generator=g),
            torch.randint(0, 7, (n, M + 1), generator=g).to(torch.int8))


def carve_card_vs_cpu(n: int, L: int, M: int, max_iters, seed: int) -> dict:
    """The carver on the card and on the CPU from the same draws: all five
    fields word for word, and every done row's solution replays to WIN on
    the card in its n_moves."""
    iters = 24 * M + 512 if max_iters is None else max_iters
    draws = carver_draws(n, M, iters, seed)
    t0 = time.perf_counter()
    cpu = device_carver.generate_batch_device(n, L, M, max_iters=max_iters,
                                              draws=draws, device="cpu")
    cpu_s = time.perf_counter() - t0
    card_draws = tuple(d.to(DEV) for d in draws)
    sync()
    t0 = time.perf_counter()
    card = device_carver.generate_batch_device(n, L, M, max_iters=max_iters,
                                               draws=card_draws)
    sync()
    card_s = time.perf_counter() - t0
    check(card.boards.device.type == DEV.type
          and all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
                  for f in card._fields),
          f"carver max_iters={max_iters}: card = CPU word for word in "
          f"{', '.join(card._fields)} (n={n}, L={L}/M={M})")
    done = card.n_moves > 0
    idx = done.nonzero()[:, 0]
    st = replay_status(card.boards[idx], card.pieces[idx], card.rotations[idx],
                       card.locations[idx], L, M)
    check(bool((st.status == 1).all()) and bool((st.lines_cleared >= L).all())
          and torch.equal(st.moves_used, card.n_moves[idx]),
          f"all {idx.numel()} carved rows replay to WIN on the card in their n_moves")
    return {"done": idx.numel(), "cpu_s": cpu_s, "card_s": card_s}


def timed_pool(executor: str, L: int, M: int, seeds: int, workers: int):
    """``generate_batch`` on one host pool, under a watchdog that kills the
    pool's worker processes after POOL_TIMEOUT_S: a hung pool then raises
    BrokenProcessPool, which fails the phase."""
    def kill_children():
        for child in multiprocessing.active_children():
            child.kill()

    watchdog = threading.Timer(POOL_TIMEOUT_S, kill_children)
    watchdog.start()
    try:
        t0 = time.perf_counter()
        games = generate_batch(L, M, 0, seeds, workers=workers, executor=executor)
        wall_s = time.perf_counter() - t0
    finally:
        watchdog.cancel()
    check(wall_s < POOL_TIMEOUT_S, f"{executor} pool ended in {wall_s:.2f} s")
    return [(g.seed, g.board.tolist(), g.sequence) for g in games], wall_s


def phase_generators() -> dict:
    """(a) The device carver at the flagship bank's shape (n=4096,
    L=5/M=25, JAX's default max_iters) on draws made on the CPU: card = CPU
    word for word, every row done and replayed to WIN; (b) the same with
    max_iters cut so that some rows end undone; (c) the generator path on
    the card, as the bank calls it, timed per 4096 rows; (d) the host
    forward pipeline's process pool against its thread pool."""
    L, M, n = 5, 25, 4096
    print(f"device carver: n={n}, L={L}/M={M}, draws made on the CPU, card vs CPU")
    full = carve_card_vs_cpu(n, L, M, None, seed=20)
    check(full["done"] == n, f"every row done at the default max_iters "
          f"({full['done']} of {n})")
    cut = carve_card_vs_cpu(n, L, M, CARVE_CUT, seed=21)
    check(0 < cut["done"] < n, f"max_iters={CARVE_CUT}: {cut['done']} of {n} rows "
          "done, the rest undone (n_moves 0)")

    def bank_carve(seed):
        return device_carver.generate_batch_device(
            n, L, M, generator=torch.Generator(device=DEV).manual_seed(seed),
            device=DEV)

    bank_carve(0)
    sync()
    times = []
    for seed in (1, 2, 3):
        t0 = time.perf_counter()
        b = bank_carve(seed)
        sync()
        times.append(time.perf_counter() - t0)
        check(bool((b.n_moves > 0).all()), f"generator path, seed {seed}: "
              f"all {n} rows done")
    carve_ms = [t * 1e3 for t in times]
    # the cut run never stops early (some rows stay undone): its time per
    # iteration gives the default runs' loop lengths
    iter_ms = cut["card_s"] * 1e3 / CARVE_CUT
    print(f"  generator path {min(carve_ms):.1f} ms per {n} rows (best of 3; "
          f"{', '.join(f'{t:.1f}' for t in carve_ms)}); draws path on the card "
          f"{full['card_s'] * 1e3:.1f} ms, on the CPU {full['cpu_s'] * 1e3:.1f} ms; "
          f"{iter_ms:.3f} ms per iteration on the card (max_iters={CARVE_CUT})")

    pL, pM, seeds = 2, 20, 100
    workers = min(POOL_WORKERS, os.cpu_count() or 1)
    print(f"host pipeline: seeds 0-{seeds - 1} at L={pL}/M={pM}, thread and "
          f"process pools of {workers} workers")
    thread_games, thread_s = timed_pool("thread", pL, pM, seeds, workers)
    process_games, process_s = timed_pool("process", pL, pM, seeds, workers)
    check(len(thread_games) > 0 and process_games == thread_games,
          f"the process pool proves the thread pool's {len(thread_games)} games "
          "(seed, board, sequence)")
    print(f"  thread {thread_s:.2f} s ({len(thread_games) / thread_s:.2f} games/s), "
          f"process {process_s:.2f} s ({len(process_games) / process_s:.2f} games/s) "
          f"on {os.cpu_count()} host cores")
    return {"carve_n": n, "carve_L": L, "carve_M": M,
            "carve_generator_ms": carve_ms, "carve_draws_card_ms": full["card_s"] * 1e3,
            "carve_draws_cpu_ms": full["cpu_s"] * 1e3, "cut_max_iters": CARVE_CUT,
            "cut_done": cut["done"], "cut_draws_card_ms": cut["card_s"] * 1e3,
            "card_ms_per_iteration": iter_ms, "pipeline_L": pL, "pipeline_M": pM,
            "pipeline_seeds": seeds, "workers": workers,
            "host_cores": os.cpu_count(), "winnable": len(thread_games),
            "thread_s": thread_s, "process_s": process_s,
            "thread_games_per_s": len(thread_games) / thread_s,
            "process_games_per_s": len(process_games) / process_s}


HOLDOUT_DRAWS = ROOT / "results" / "holdout_draws_L5M25.jsonl"
DRAW_POLICY = "flagship_L5M25_100k_h100_policy.npz"
DRAW_TIE = 1e-4           # a top-two Q gap under this is a near-tie
DRAW_COUNT = 4            # draws, the first seeds of tools/holdout_draws.py
DRAW_LIMIT_S = 60.0


def holdout_draws_tool():
    """``tools/holdout_draws.py`` as a module (its port side imports no JAX)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import holdout_draws
    return holdout_draws


def phase_holdout_draws() -> dict:
    """Four L=5/M=25 beam-family draws on the card, as
    ``tools/holdout_draws.py --package port --device cuda`` makes them
    (``make_holdout_bank`` with no host seeds, the tool's first seeds),
    each timed; every beam row proven again by the beam prover and its
    solution replayed to WIN on the card; the 100k flagship policy played
    once per row on the card and on the CPU, TF32 off, every outcome equal
    but at named near-ties; each draw's outcomes equal to the recorded
    card draw of its seed in ``results/holdout_draws_L5M25.jsonl``, and the
    per-draw win fractions beside the JAX package's CPU draws there."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is off")
    hd = holdout_draws_tool()
    t_start = time.perf_counter()
    L, M = 5, 25
    policy = str(ROOT / "results" / DRAW_POLICY)
    nets = {side: (dev, hd.load_policy(policy, dev))
            for side, dev in (("card", DEV), ("cpu", torch.device("cpu")))}
    draws = []
    for seed in hd.SEEDS[:DRAW_COUNT]:
        bank = hd.port_banks(L, M, ["holdout"], seed, None, DEV, hd.HOLDOUT_ROWS,
                             hd.TRAIN_ROWS)[0]
        boards = torch.as_tensor(bank["boards"], device=DEV)
        pieces = torch.as_tensor(bank["pieces"], device=DEV)
        cols = bb.pack_board(boards)
        n = cols.shape[0]
        won, rots, locs, n_moves = device_forward.prove_batch_device(
            cols, pieces, L, M, beam_width=8)
        st = replay_status(cols, pieces, rots, locs, L, M)
        check(n == hd.HOLDOUT_ROWS // 2 and bool(won.all())
              and bool((st.status == 1).all())
              and torch.equal(st.moves_used, n_moves),
              f"seed {seed}: {n} beam rows in {bank['build_s']:.2f} s "
              f"({bank['beam']['chunks']} chunks, {bank['beam']['winners']} winners of "
              f"{bank['beam']['candidates']}), each proven again and replayed to WIN")
        ends = {}
        with torch.no_grad():
            for side, (dev, net) in nets.items():
                env = bb.make_state_batch(cols.to(dev), pieces.to(dev), L, M)
                env, gap = greedy_min_gap(net, env, M + 1)
                ends[side] = (env.status.cpu(), gap.cpu())
        (st_card, gap_card), (st_cpu, gap_cpu) = ends["card"], ends["cpu"]
        apart = st_card != st_cpu
        tie = torch.minimum(gap_card, gap_cpu) < DRAW_TIE
        named = [int(i) for i in (apart & tie).nonzero()[:, 0]]
        check(not bool((apart & ~tie).any()),
              f"seed {seed}: the 100k policy's outcome on the card equals the CPU's on "
              f"{n - int(apart.sum())} of {n} rows; near-ties apart (gap < {DRAW_TIE}): "
              f"{named}")
        draws.append({"seed": seed, "build_s": bank["build_s"], "rows": n,
                      "beam": bank["beam"], "win_fraction": float((st_card == 1).float().mean()),
                      "cpu_win_fraction": float((st_cpu == 1).float().mean()),
                      "near_tie_rows_apart": named,
                      "won_hex": np.packbits((st_card == 1).numpy()).tobytes().hex()})
    recorded = [json.loads(t) for t in HOLDOUT_DRAWS.read_text().splitlines() if t.strip()]
    beam = [ln for ln in recorded if ln["family"] == "beam" and not ln["reference"]]
    jax_wins = np.array([ln["policies"][DRAW_POLICY]["win_fraction"] for ln in beam
                         if ln["package"] == "jax"])
    card_lines = {ln["seed"]: ln for ln in beam if ln["package"] == "port"
                  and ln["device"] == "cuda"}
    same = [d["seed"] in card_lines
            and card_lines[d["seed"]]["policies"][DRAW_POLICY]["won_hex"] == d["won_hex"]
            for d in draws]
    check(all(same), "each draw's outcomes equal, row for row, the recorded card draw "
          f"of its seed in {HOLDOUT_DRAWS.name}: {same}")
    wins = [d["win_fraction"] for d in draws]
    print(f"  the 100k policy on these draws' beam rows: {', '.join(f'{w:.4f}' for w in wins)}; "
          f"JAX's CPU draws ({jax_wins.size}): mean {jax_wins.mean():.4f}, sd "
          f"{jax_wins.std(ddof=1):.4f}, range {jax_wins.min():.4f}-{jax_wins.max():.4f}")
    total_s = time.perf_counter() - t_start
    check(total_s < DRAW_LIMIT_S, f"phase 21 took {total_s:.1f} s (< {DRAW_LIMIT_S:.0f})")
    for d in draws:
        del d["won_hex"]
    return {"draws": draws, "jax_cpu": {"draws": int(jax_wins.size),
                                        "mean": float(jax_wins.mean()),
                                        "sd": float(jax_wins.std(ddof=1)),
                                        "min": float(jax_wins.min()),
                                        "max": float(jax_wins.max())},
            "equal_to_recorded_card_draws": same,
            "total_s": total_s}


def multigpu_worker(kind: str, out: str) -> int:
    res = {"nccl1": worker_one_rank_nccl, "gloo2": worker_two_ranks_gloo,
           "refresh2": worker_mesh_refresh,
           "submesh3": lambda o: worker_two_ranks_gloo(o, n_mesh=2)}[kind](Path(out))
    print(json.dumps(res), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def run_cli(argv: list) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"cli {' '.join(argv)} exits 0")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def phase_cli(ckpt: str, rollout_rate: float) -> dict:
    """``cli play`` and ``cli bench`` (counted: bench runs the rollout kernel)."""
    print("cli play: recorded solution, and greedy on the card")
    sol = run_cli(["play", "-L", "2", "-M", "20", "--seed", "3"])
    check(sol["result"] == "win", f"play --policy solution: {sol}")
    greedy = run_cli(["play", "-L", "2", "-M", "20", "--seed", "3", "--policy",
                      "greedy", "--checkpoint", ckpt])
    check(greedy["result"] in ("win", "loss") and 0 < greedy["moves_used"] <= 20,
          f"play --policy greedy from the default-bank trainer: {greedy}")
    shutil.rmtree(ckpt, ignore_errors=True)
    print("cli bench --no-train: N=8192, K=1024, host-filled bank 256, 5 repeats")
    _build.reset_launch_counts()
    res = run_cli(["bench", "--no-train"])
    launches = _build.LAUNCHES["rollout"]
    check(launches == 6, f"bench launched the rollout kernel {launches}x (1 + 5 repeats)")
    check(sorted(res) == ["metric", "unit", "value", "vs_baseline"]
          and res["metric"] == "env_steps_per_sec_per_chip",
          f"bench prints bench.py's keys: {res}")
    print(f"  bench {res['value']:.4e} env-steps/s ({res['vs_baseline']}x the "
          f"reference's move()); phase 1's kernel time gives {rollout_rate:.4e}")
    return {"bench": res, "bench_launches": launches, "play": [sol, greedy],
            "bench_over_kernel_rate": res["value"] / rollout_rate}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    bank = ConfigBank(2, 20, capacity=256, seed=1, device=DEV).fill_device()
    r_check = phase_rollout_check(bank)
    r_bench = phase_rollout_bench(bank)
    a = phase_actor_check(bank)
    tr = phase_trainer()
    per_step = phase_trainer_per_step()
    fwd = phase_forward()
    tr_fwd = phase_trainer_forward()
    learner = phase_learner_checks()
    flagship = phase_flagship_demo()
    adaptive = phase_adaptive_bf16()
    nstep = phase_nstep_per()
    carves = phase_host_carves()
    default = phase_default_bank_trainer()
    array = phase_array_engine()
    curriculum = phase_curriculum()
    cli_res = phase_cli(default.pop("ckpt"), r_bench["env_steps_per_s"])
    goals = phase_per_env_goals()
    prof = phase_profile_mfu()
    multi = phase_multigpu()
    extras = phase_mesh_extras()
    tpu = phase_tpu_policy()
    flag_policy = phase_flagship_policy()
    generators = phase_generators()
    holdout_draws = phase_holdout_draws()

    kernels = [
        {"name": "rollout", "route": "cuda",
         "source": "tetris_piclim_tpu_torch/csrc/rollout.cu",
         "replaces": "tetris_piclim_tpu/ops/pallas_rollout.py:298",
         "launches": r_bench["launches"], "max_abs_err": r_check["max_abs_err"],
         "ms": r_bench["ms"], "plain_ms": r_bench["plain_ms"],
         "bound_ms": r_bench["bound_ms"], "bound_by": r_bench["bound_by"],
         "library_ms": None},
        {"name": "actor", "route": "cuda",
         "source": "tetris_piclim_tpu_torch/csrc/actor.cu",
         "replaces": "tetris_piclim_tpu/ops/pallas_actor.py:273",
         "launches": tr["launches"], "max_abs_err": a["max_abs_err"],
         "ms": a["ms"], "plain_ms": a["plain_ms"],
         "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
         "library_ms": None},
    ]
    print(json.dumps({"rollout_env_steps_per_s": r_bench["env_steps_per_s"],
                      "trainer_env_steps_per_s": tr["env_steps_per_s"],
                      "trainer_learner_share": tr["learner_share"],
                      "per_step_trainer_env_steps_per_s": per_step["env_steps_per_s"],
                      "per_step_trainer_learner_share": per_step["learner_share"],
                      "trainer_eval_win_rate": tr["win_rate"]}))
    print(json.dumps({"forward_generator": fwd,
                      "forward_bank_trainer": {
                          k: v for k, v in tr_fwd.items() if k != "launches"}}))
    print(json.dumps({"learner_checks": learner, "flagship_demo_trainer": flagship,
                      "adaptive_bf16_trainer": adaptive,
                      "nstep_per_trainer": {k: v for k, v in nstep.items()
                                            if k != "launches"}}))
    print(json.dumps({"host_carves": carves,
                      "default_bank_trainer": {k: v for k, v in default.items()
                                               if k != "launches"},
                      "array_engine": array, "curriculum": curriculum,
                      "cli": cli_res, "per_env_goals": goals}))
    mm = prof["measure"]
    print(json.dumps({"training_benchmark": {
        "scan": mm["scan"], "scan_cut_from": prof["scan_cut_from"],
        "train_env_steps_per_s": mm["chunk_env_steps_per_s"],
        "chunk_mfu": mm["chunk_mfu"], "learner_mfu": mm["learner_mfu"],
        "actor_mfu": mm["actor_mfu"],
        "learner_share_of_chunk": mm["learner_share_of_chunk"],
        "learner_gflops_per_update": mm["learner_gflops_per_update"],
        "learner_ms_per_update": prof["learner_ms_per_update"],
        "actor_forward_us": mm["actor_forward_us"],
        "actor_gflops_per_call": mm["actor_gflops_per_call"],
        "peak_tflops_bf16": mm["peak_tflops_bf16"], "device_kind": mm["device_kind"],
        "trace_kernel_events": prof["trace_kernel_events"]}}))
    print(json.dumps({"multigpu": multi, "card": smi}))
    print(json.dumps({"mesh_refresh_submesh_entry": extras, "card": smi}))
    print(json.dumps({"tpu_policy": tpu, "card": smi}))
    print(json.dumps({"flagship_policy": flag_policy, "card": smi}))
    print(json.dumps({"generators": generators, "card": smi}))
    print(json.dumps({"holdout_draws": holdout_draws, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--multigpu-worker":
        sys.exit(multigpu_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
