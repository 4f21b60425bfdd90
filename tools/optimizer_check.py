"""The learner's AMSGrad and Polyak steps as loops over the tensors against
the package's multi-tensor (foreach) versions: the same bits, and the time
each takes in the flagship trainer.

    python3 tools/optimizer_check.py [--device cpu] [--num-envs N]
        [--steps S] [--repeats R]

Builds the trainer of ``bench_mfu.flagship_trainer`` (L=5/M=25, conv
(32, 64) + dueling + joint in float32, 2048 envs, 4 learner updates per
step, the per-step path) twice from seed 0. Trainer A runs with
``AmsgradW.step`` and ``polyak`` written as loops over the tensors, one op
per tensor (kept here as the reference); trainer B with the package's own.
Each runs one chunk of ``--steps`` env steps, and the two must then hold
the same weights, target weights and moments word for word. Then each runs
``--repeats`` more chunks, A and B in turn, CUDA-synchronised: the wall
time per chunk, env-steps/s and the learner's ms per update (CUDA events
around the updates, the trainer's own clock), and at the end the word for
word check again. Prints one JSON line, and last the card's name and power
limit. Exits 1 if the two trainers part.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetris_piclim_tpu_torch.bench_mfu import flagship_trainer  # noqa: E402
from tetris_piclim_tpu_torch.dqn import agent as agent_lib  # noqa: E402


@torch.no_grad()
def loop_step(self) -> None:
    """``AmsgradW.step``, one tensor at a time."""
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


@torch.no_grad()
def loop_polyak(target_net, net, tau: float) -> None:
    """``polyak``, one tensor at a time."""
    for t, p in zip(target_net.parameters(), net.parameters()):
        t.mul_(1.0 - tau).add_(p * tau)


ARMS = {"loop": (loop_step, loop_polyak),
        "foreach": (agent_lib.AmsgradW.step, agent_lib.polyak)}


def run_chunk(tr, arm: str, steps: int) -> tuple[float, float]:
    """One chunk of ``tr`` with the arm's steps in place; its wall seconds
    and the learner's milliseconds."""
    step, polyak = ARMS[arm]
    keep = agent_lib.AmsgradW.step, agent_lib.polyak
    agent_lib.AmsgradW.step, agent_lib.polyak = step, polyak
    try:
        sync(tr.device)
        t0 = time.perf_counter()
        tr._chunk_plain(steps)
        sync(tr.device)
        return time.perf_counter() - t0, tr._clock.total_ms()
    finally:
        agent_lib.AmsgradW.step, agent_lib.polyak = keep


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def state_words(tr) -> dict:
    ts = tr.state
    out = {f"net.{k}": v for k, v in ts.net.state_dict().items()}
    out.update({f"target.{k}": v for k, v in ts.target_net.state_dict().items()})
    for name in ("mu", "nu", "nu_max"):
        out.update({f"{name}.{i}": v for i, v in enumerate(getattr(ts.opt, name))})
    return out


def apart(a, b) -> list[str]:
    """The tensors of the two trainers that differ in any word."""
    wa, wb = state_words(a), state_words(b)
    return [k for k in wa if not torch.equal(wa[k], wb[k])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--repeats", type=int, default=3)
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("optimizer_check: CUDA is not available", file=sys.stderr)
        return 1
    trainers = {arm: flagship_trainer(a.num_envs, a.steps, 4, device=a.device)
                for arm in ARMS}
    for arm, tr in trainers.items():
        run_chunk(tr, arm, a.steps)
    first = apart(trainers["loop"], trainers["foreach"])
    walls = {arm: [] for arm in ARMS}
    learner = {arm: [] for arm in ARMS}
    for _ in range(a.repeats):
        for arm, tr in trainers.items():
            wall_s, learner_ms = run_chunk(tr, arm, a.steps)
            walls[arm].append(wall_s)
            learner[arm].append(learner_ms)
    last = apart(trainers["loop"], trainers["foreach"])
    updates = a.steps * 4
    out = {"tool": "optimizer_check", "device": a.device, "num_envs": a.num_envs,
           "steps_per_chunk": a.steps, "updates_per_chunk": updates,
           "updates_compared": updates * (1 + a.repeats),
           "tensors_compared": len(state_words(trainers["loop"])),
           "apart_after_first_chunk": first, "apart_at_end": last,
           "word_for_word": not first and not last}
    for arm in ARMS:
        med = statistics.median(walls[arm])
        out[arm] = {"chunk_s": walls[arm], "env_steps_per_s": a.num_envs * a.steps / med,
                    "learner_ms_per_update": [ms / updates for ms in learner[arm]]}
    out["speedup_median_chunk"] = (statistics.median(walls["loop"])
                                   / statistics.median(walls["foreach"]))
    print(json.dumps(out), flush=True)
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    return 0 if out["word_for_word"] else 1


if __name__ == "__main__":
    sys.exit(main())
