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
   comparison, the same recipe on the per-step path (``actor_fusion=0``).

Each kernel wrapper counts its launches; the counts are set to 0 just
before a path runs and read just after, and a path whose kernel never
launched fails. Every check that fails exits non-zero. Output: the card's
name and power limit, the kernels' JSON line (launches, errors, times,
bounds), and as the last line ``{"ok": true, "device": {...}}``. Needs one
card, no network; imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.models.qnet import QNetwork
from tetris_piclim_tpu_torch.ops import _build
from tetris_piclim_tpu_torch.ops import actor as actor_ops
from tetris_piclim_tpu_torch.ops import bitboard as bb
from tetris_piclim_tpu_torch.ops import rollout as rollout_ops
from tetris_piclim_tpu_torch.utils.checkpoint import (
    restore_bank, save_bank, save_train_state,
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
    bank = ConfigBank(2, 20, capacity=4096, seed=0, device=DEV).fill_device()
    trainer = DQNTrainer(train_config(0, 2, 32), bank=bank, device=DEV)
    last = trainer.train(log_fn=lambda m: print("  " + m))["history"][-1]
    check(np.isfinite(last["loss"]) and trainer.state.updates_done > 0,
          "per-step path trains")
    print(f"  last chunk {last['steps_per_s']:.4e} env-steps/s, "
          f"learner share {last['learner_share']:.3f}")
    return {"env_steps_per_s": last["steps_per_s"],
            "learner_share": last["learner_share"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
