"""Where a learning curve comes from: the DQN trainer of either package at
any size, with float32 matmuls or with their inputs rounded to bfloat16.

    python3 tools/learning_probe.py [--package torch|jax] [--jax-root DIR]
        [--matmul f32|bf16|bf16-fwd-bwd] [--device cuda|cpu] [--num-envs N]
        [--steps S] [--seeds 0,1,2]

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
imports JAX). ``--matmul bf16-fwd-bwd`` rounds the operands of the backward
products too (``grad_x = g W`` and ``grad_W = g^T x``), each a bfloat16
pass with float32 sums, as XLA's default precision runs all three products
of a float32 layer on a TPU.

``--jax-root DIR`` runs the JAX package found in DIR, put first on
``sys.path``, instead of this checkout's: an older version of it taken
from git history, outside the repo tree, e.g. the one that made
``results/train_L2M20_v2_summary.json``::

    mkdir -p DIR && git archive b5c6e5a tetris_piclim_tpu | tar -x -C DIR
    git rev-parse b5c6e5a > DIR/COMMIT

Only ``TrainConfig`` fields that the package had then are passed (``env``,
``num_envs``, ``bank_capacity``, ``replay_capacity``, ``total_steps``,
``log_every``, ``seed``). The JSON line names DIR and the commit in
``DIR/COMMIT`` (null without that file).

``--summarize FILE [FILE ...]`` trains nothing: it reads such JSON lines
back and prints, for each set of runs that differ only in their seed, the
training win rate of every chunk and the greedy win rate as mean, sample
standard deviation and lowest over the seeds, one JSON line per set.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from learning_check import card as card_name  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=["torch", "jax"], default="torch")
    p.add_argument("--jax-root", metavar="DIR",
                   help="run the JAX package in DIR (with --package jax)")
    p.add_argument("--matmul", choices=["f32", "bf16", "bf16-fwd-bwd"], default="f32")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--bank", type=int, default=4096)
    p.add_argument("--replay", type=int, default=131072,
                   help="ring size; 32 x num-envs keeps the full run's 32 steps of history")
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--log-every", type=int, default=10_000)
    p.add_argument("--eval-episodes", type=int, default=4096)
    p.add_argument("--seeds", default="0")
    p.add_argument("--summarize", nargs="+", metavar="FILE",
                   help="summarize the JSON lines of earlier runs instead")
    return p.parse_args(argv)


# what a set of runs shares: every key of a run's line but the seed's own
_SET_KEYS = ("package", "jax_commit", "matmul", "device", "card", "num_envs",
             "bank", "replay", "steps", "env_steps")


def summarize(lines: list[dict]) -> list[dict]:
    """Per set of runs that differ only in their seed: each chunk's training
    win rate and the greedy win rate as mean, sample sd and lowest."""
    sets: dict = {}
    for r in lines:
        sets.setdefault(json.dumps([r[k] for k in _SET_KEYS]), []).append(r)
    out = []
    for runs in sets.values():
        wr = np.array([r["win_rate"] for r in runs])
        greedy = np.array([r["greedy_win_rate"] for r in runs])

        def sd(x):
            return x.std(axis=0, ddof=1) if len(runs) > 1 else np.zeros(x.shape[1:])

        out.append({**{k: runs[0][k] for k in _SET_KEYS},
                    "seeds": [r["seed"] for r in runs],
                    "win_rate_mean": wr.mean(axis=0).tolist(),
                    "win_rate_sd": sd(wr).tolist(),
                    "win_rate_min": wr.min(axis=0).tolist(),
                    "greedy_mean": float(greedy.mean()),
                    "greedy_sd": float(sd(greedy[:, None])[0])})
    return out


def round_linear_inputs_to_bf16() -> None:
    """Every ``nn.Linear`` multiplies bfloat16-rounded operands in float32."""
    import torch.nn.functional as F

    def forward(self, x):
        return F.linear(x.bfloat16().float(), self.weight.bfloat16().float(), self.bias)

    torch.nn.Linear.forward = forward


def _bf16(t):
    return t.bfloat16().float()


class Bf16Linear(torch.autograd.Function):
    """``F.linear`` whose forward product and both backward products take
    bfloat16-rounded operands and sum in float32; the bias and its gradient
    stay float32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        out = _bf16(x) @ _bf16(weight).T
        return out if bias is None else out + bias

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gb = _bf16(g)
        grad_x = gb @ _bf16(weight)
        grad_w = gb.flatten(0, -2).T @ _bf16(x).flatten(0, -2)
        grad_b = g.flatten(0, -2).sum(0) if ctx.has_bias else None
        return grad_x, grad_w, grad_b


def round_linear_fwd_bwd_to_bf16() -> None:
    """Every ``nn.Linear`` runs :class:`Bf16Linear`: bfloat16 operands in
    the forward product and in both backward products, float32 sums."""

    def forward(self, x):
        return Bf16Linear.apply(x, self.weight, self.bias)

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
    import tetris_piclim_tpu
    from tetris_piclim_tpu.dqn.train import DQNTrainer
    from tetris_piclim_tpu.gen.bank import ConfigBank
    from tetris_piclim_tpu.utils.config import EnvConfig, TrainConfig

    if a.jax_root and Path(a.jax_root).resolve() not in Path(
            tetris_piclim_tpu.__file__).resolve().parents:
        raise SystemExit(f"tetris_piclim_tpu came from {tetris_piclim_tpu.__file__}")
    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=a.num_envs,
                      bank_capacity=a.bank, replay_capacity=a.replay,
                      total_steps=a.steps, log_every=a.log_every, seed=seed)
    tr = DQNTrainer(cfg, bank=ConfigBank(2, 20, capacity=a.bank, seed=seed).fill_device())
    hist = tr.train(log_fn=None)["history"]
    return hist, tr.evaluate(n_episodes=a.eval_episodes)["win_rate"]


def main(argv=None) -> int:
    a = parse(argv)
    if a.summarize:
        lines = [json.loads(line) for f in a.summarize
                 for line in Path(f).read_text().splitlines() if line.strip()]
        for row in summarize(lines):
            print(json.dumps(row))
        return 0
    if a.package == "jax" and (a.matmul != "f32" or a.device != "cpu"):
        raise SystemExit("--package jax runs float32 on the CPU: give --device cpu")
    if a.jax_root and a.package != "jax":
        raise SystemExit("--jax-root is for --package jax")
    card, commit = None, None
    if a.jax_root:
        sys.path.insert(0, str(Path(a.jax_root).resolve()))
        stamp = Path(a.jax_root) / "COMMIT"
        commit = stamp.read_text().strip() if stamp.exists() else None
    if a.package == "torch":
        from tetris_piclim_tpu_torch.utils.device import resolve_device

        resolve_device(a.device)  # no card: raise, never fall back to the CPU
        if a.matmul == "bf16":
            round_linear_inputs_to_bf16()
        elif a.matmul == "bf16-fwd-bwd":
            round_linear_fwd_bwd_to_bf16()
        if a.device == "cuda":
            card = card_name()
    train = train_torch if a.package == "torch" else train_jax
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        hist, greedy = train(a, seed)
        print(json.dumps({
            "tool": "learning_probe", "package": a.package, "matmul": a.matmul,
            "jax_root": a.jax_root, "jax_commit": commit,
            "device": a.device, "card": card, "seed": seed, "num_envs": a.num_envs,
            "bank": a.bank, "replay": a.replay, "steps": a.steps,
            "env_steps": [h["env_steps"] for h in hist],
            "win_rate": [h["win_rate"] for h in hist],
            "loss": [h["loss"] for h in hist], "greedy_win_rate": greedy,
            "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
