"""Where does the training throughput go? Decomposition of the per-step
chunk on one GPU, the harness of ``benchmarks/bench_actor_decomp.py``.

    python3 tools/actor_decomp.py [--model conv --dueling --joint --bf16]
                                  [--num-envs 4096] [--batch 128] [--updates 1 4]

Times cumulative variants of the same lockstep loop of ``--num-envs`` envs
(L=2/M=20, a 1024-row device bank), each ``SCAN`` = 512 steps, best of 3
after a warm-up, CUDA-synchronised around each call
(``bench_mfu.best_seconds``):

  env        random actions -> ``bitboard.step_autoreset_batch``
             (no net, no replay)
  act        observe -> Q forward + eps-greedy (eps 0.05) -> step +
             auto-reset (the actor)
  act_replay ... + the packed replay write
  full_u1    ... + 1 learner update per step (``DQNTrainer._chunk_plain``)
  full_u4    ... + 4 learner updates per step (the flagship setting)

and, beside ``env``, the rollout kernel (``ops/rollout.py::rollout_fused``,
one launch of SCAN steps with its own Philox draws), which does the env
variant's work in one kernel. Every rate is env steps per second. The
derived ``cost_us`` are microseconds per env step of each stage: the env
step, the forward and observation, the replay write, one update, and the
three extra updates. Prints one JSON line and, last, the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetris_piclim_tpu_torch.bench_mfu import best_seconds  # noqa: E402
from tetris_piclim_tpu_torch.dqn import agent as agent_lib  # noqa: E402
from tetris_piclim_tpu_torch.dqn.replay import ReplayBuffer  # noqa: E402
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer  # noqa: E402
from tetris_piclim_tpu_torch.gen.bank import ConfigBank  # noqa: E402
from tetris_piclim_tpu_torch.ops import bitboard  # noqa: E402
from tetris_piclim_tpu_torch.ops.rollout import rollout_fused  # noqa: E402
from tetris_piclim_tpu_torch.utils.config import (  # noqa: E402
    DQNConfig, EnvConfig, TrainConfig,
)
from tetris_piclim_tpu_torch.utils.device import resolve_device  # noqa: E402

SCAN = 512
L, M = 2, 20


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["mlp", "conv"], default="mlp")
    ap.add_argument("--dueling", action="store_true")
    ap.add_argument("--joint", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--impl", choices=["conv", "im2col"], default="conv")
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--updates", type=int, nargs="*", default=[1, 4],
                    help="updates-per-step variants to time")
    return ap.parse_args(argv)


def make_net(args):
    """The net ``cli train`` builds for these flags (seed 0)."""
    gen = torch.Generator().manual_seed(0)
    if args.model == "conv":
        from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork

        return ConvQNetwork(dueling=args.dueling, joint=args.joint,
                            dtype=torch.bfloat16 if args.bf16 else torch.float32,
                            impl=args.impl, generator=gen)
    from tetris_piclim_tpu_torch.models.qnet import QNetwork

    return QNetwork(dueling=args.dueling, joint=args.joint, generator=gen)


def decompose(args, device="cuda") -> dict:
    dev = resolve_device(device)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    n = args.num_envs

    def timed(fn) -> float:
        return n * SCAN / best_seconds(fn, sync)

    bank = ConfigBank(L, M, capacity=1024, seed=0, device=dev).fill_device()
    cols, pieces = bank.rows
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, bank.capacity, (n,), generator=gen, device=dev)
    states = bitboard.make_state_batch(cols[idx], pieces[idx], L, M)

    def mk_cfg(updates: int) -> TrainConfig:
        return TrainConfig(env=EnvConfig(L=L, M=M),
                           dqn=DQNConfig(batch_size=args.batch), num_envs=n,
                           bank_capacity=bank.capacity, replay_capacity=262144,
                           warmup_steps=1, updates_per_step=updates, seed=0)

    trainer = DQNTrainer(mk_cfg(1), bank=bank, net=make_net(args), device=dev)
    net = trainer.state.net
    replay = ReplayBuffer(262144, dev)

    def loop(act: bool, write: bool):
        def run():
            s = states
            for _ in range(SCAN):
                if act:
                    rot, col = agent_lib.select_actions(
                        net, bitboard.observe(s), 0.05, generator=gen)
                else:
                    rot = torch.randint(0, 4, (n,), generator=gen, device=dev)
                    col = torch.randint(0, 10, (n,), generator=gen, device=dev)
                reset = torch.randint(0, bank.capacity, (n,), generator=gen,
                                      device=dev)
                nxt, res = bitboard.step_autoreset_batch(s, rot, col, cols,
                                                         pieces, reset)
                if write:
                    replay.add(s, rot, col, res.lines_delta.float(), res.state,
                               res.done)
                s = nxt
        return run

    seeds = itertools.count(1)  # a fresh Philox seed per rollout call
    res = {"num_envs": n, "scan": SCAN, "backend": dev.type,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "model": args.model, "dueling": args.dueling, "joint": args.joint,
           "bf16": args.bf16, "impl": args.impl, "batch": args.batch}
    res["env_only"] = round(timed(loop(False, False)), 1)
    res["rollout_kernel"] = round(timed(
        lambda: rollout_fused(states, cols, pieces, SCAN, seed=next(seeds))), 1)
    res["actor"] = round(timed(loop(True, False)), 1)
    res["actor_replay"] = round(timed(loop(True, True)), 1)

    for u in args.updates:
        tr = DQNTrainer(mk_cfg(u), bank=bank, net=make_net(args), device=dev)
        res[f"full_u{u}"] = round(timed(lambda tr=tr: tr._chunk_plain(SCAN)), 1)

    def us(v):
        return round(1e6 / v, 4)

    cost = {"env": us(res["env_only"]),
            "net_forward+obs": round(us(res["actor"]) - us(res["env_only"]), 4),
            "replay_write": round(us(res["actor_replay"]) - us(res["actor"]), 4)}
    if "full_u1" in res:
        cost["replay+learn_u1"] = round(us(res["full_u1"]) - us(res["actor"]), 4)
        cost["learn_u1"] = round(us(res["full_u1"]) - us(res["actor_replay"]), 4)
    if "full_u1" in res and "full_u4" in res:
        cost["extra_3_updates"] = round(us(res["full_u4"]) - us(res["full_u1"]), 4)
    res["cost_us"] = cost
    return res


def main(argv=None) -> int:
    res = decompose(parse(argv))
    print(json.dumps(res), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
