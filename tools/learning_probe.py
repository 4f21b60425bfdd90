"""Where a learning curve comes from: the DQN trainer of either package at
any size, with float32 matmuls or with their inputs rounded to bfloat16.

    python3 tools/learning_probe.py [--package torch|jax] [--matmul f32|bf16]
        [--device cuda|cpu] [--num-envs N] [--steps S] [--seeds 0,1,2]

Trains the per-step path with the flags of ``tools/learning_check.py``
(L=2/M=20, reference-declared hyperparameters, a device-carved bank, 4096
envs and 100k steps unless given smaller) once per seed, in process, and
prints one JSON line per seed: the training win rate of every chunk, the
logged loss, and the greedy win rate of the end. ``--matmul bf16`` rounds
both operands of every ``nn.Linear`` to bfloat16 and multiplies in float32
(exact products, float32 sums): one bfloat16 pass, which is what XLA's
default precision gives a float32 matmul on a TPU, against the card's and
the CPU's full float32. ``--package jax`` runs the JAX package's trainer on
the CPU instead (the reference; this is the one path of the tool that
imports JAX).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from learning_check import card as card_name  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=["torch", "jax"], default="torch")
    p.add_argument("--matmul", choices=["f32", "bf16"], default="f32")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--bank", type=int, default=4096)
    p.add_argument("--replay", type=int, default=131072,
                   help="ring size; 32 x num-envs keeps the full run's 32 steps of history")
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--log-every", type=int, default=10_000)
    p.add_argument("--eval-episodes", type=int, default=4096)
    p.add_argument("--seeds", default="0")
    return p.parse_args(argv)


def round_linear_inputs_to_bf16() -> None:
    """Every ``nn.Linear`` multiplies bfloat16-rounded operands in float32."""
    import torch
    import torch.nn.functional as F

    def forward(self, x):
        return F.linear(x.bfloat16().float(), self.weight.bfloat16().float(), self.bias)

    torch.nn.Linear.forward = forward


def train_torch(a, seed: int) -> tuple[list, float]:
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=a.num_envs,
                      bank_capacity=a.bank, replay_capacity=a.replay,
                      total_steps=a.steps, log_every=a.log_every, seed=seed)
    bank = ConfigBank(2, 20, capacity=a.bank, seed=seed, device=a.device).fill_device()
    tr = DQNTrainer(cfg, bank=bank, device=a.device)
    hist = tr.train(log_fn=None)["history"]
    return hist, tr.evaluate(n_episodes=a.eval_episodes)["win_rate"]


def train_jax(a, seed: int) -> tuple[list, float]:
    from tetris_piclim_tpu.dqn.train import DQNTrainer
    from tetris_piclim_tpu.gen.bank import ConfigBank
    from tetris_piclim_tpu.utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=a.num_envs,
                      bank_capacity=a.bank, replay_capacity=a.replay,
                      total_steps=a.steps, log_every=a.log_every, seed=seed)
    tr = DQNTrainer(cfg, bank=ConfigBank(2, 20, capacity=a.bank, seed=seed).fill_device())
    hist = tr.train(log_fn=None)["history"]
    return hist, tr.evaluate(n_episodes=a.eval_episodes)["win_rate"]


def main(argv=None) -> int:
    a = parse(argv)
    if a.package == "jax" and (a.matmul != "f32" or a.device != "cpu"):
        raise SystemExit("--package jax runs float32 on the CPU: give --device cpu")
    card = None
    if a.package == "torch":
        from tetris_piclim_tpu_torch.utils.device import resolve_device

        resolve_device(a.device)  # no card: raise, never fall back to the CPU
        if a.matmul == "bf16":
            round_linear_inputs_to_bf16()
        if a.device == "cuda":
            card = card_name()
    train = train_torch if a.package == "torch" else train_jax
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        hist, greedy = train(a, seed)
        print(json.dumps({
            "tool": "learning_probe", "package": a.package, "matmul": a.matmul,
            "device": a.device, "card": card, "seed": seed, "num_envs": a.num_envs,
            "bank": a.bank, "replay": a.replay, "steps": a.steps,
            "env_steps": [h["env_steps"] for h in hist],
            "win_rate": [h["win_rate"] for h in hist],
            "loss": [h["loss"] for h in hist], "greedy_win_rate": greedy,
            "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
