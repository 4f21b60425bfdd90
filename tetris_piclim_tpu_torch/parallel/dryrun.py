"""Multi-process dry run of the data-parallel trainer.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` and
``tools/multihost_demo.py``: ``n`` ranks on this host (NCCL on ``n`` cards
when there are that many, else gloo on the CPU) run JAX's dry-run config
(L=1, M=2, so every env crosses episode boundaries and resets from the
bank; ``num_envs = 4n``, an 8-row bank, replay ``64n``, warmup 1, 4 steps;
from 2 ranks on the ring holds a batch of 32 within them, so the learner
and its all-reduce run), then the fused-actor phase (``actor_fusion=2``,
``num_envs = 8n``), which is executed, not only traced: the actor kernel
on the GPU, its plain version on the CPU.

    python -m tetris_piclim_tpu_torch.parallel.dryrun N
"""

from __future__ import annotations

import dataclasses
import datetime
import sys

import torch

WORKER_TIMEOUT = datetime.timedelta(seconds=120)


def _worker(device: str) -> None:
    import torch.distributed as dist

    from ..dqn.train import DQNTrainer
    from ..gen.bank import ConfigBank
    from ..utils.config import DQNConfig, EnvConfig, TrainConfig
    from .distributed import init_distributed
    from .mesh import make_mesh

    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share this host's cores
    info = init_distributed(device=device, timeout=WORKER_TIMEOUT)
    mesh = make_mesh(device=device)
    n = mesh.size
    cfg = TrainConfig(
        env=EnvConfig(L=1, M=2), dqn=DQNConfig(batch_size=32),
        num_envs=4 * n, bank_capacity=8, replay_capacity=64 * n,
        warmup_steps=1, total_steps=4, log_every=4, seed=0)
    bank = ConfigBank(1, 2, capacity=8, seed=0, device=mesh.device).fill_device()
    trainer = DQNTrainer(cfg, bank=bank, mesh=mesh)
    m = trainer.run_chunk(4)
    episodes = int(m.episodes)
    if episodes <= 0:
        raise RuntimeError("no episode ended and reset from the bank on the mesh")
    if mesh.is_root:
        print(f"dryrun_multigpu({n}): ok — episodes={episodes} "
              f"updates={trainer.state.updates_done} backend={info['backend']} "
              f"device={info['device']}", flush=True)

    fused_cfg = dataclasses.replace(
        cfg, num_envs=8 * n, actor_fusion=2, total_steps=2, log_every=2)
    fused = DQNTrainer(fused_cfg, bank=bank, mesh=mesh)
    m = fused.run_chunk(2)
    if fused.state.global_step != 2 or not 0 <= int(m.wins) <= int(m.episodes):
        raise RuntimeError("the fused phase did not run")
    if mesh.is_root:
        print(f"dryrun_multigpu({n}): fused phase ok — episodes="
              f"{int(m.episodes)} envs per rank={fused.state.env.status.shape[0]}",
              flush=True)
    dist.destroy_process_group()


def dryrun_multigpu(n_devices: int, timeout: float = 300.0) -> str:
    """Run the dry run on ``n_devices`` ranks; returns rank 0's output and
    raises if any rank fails or ``timeout`` seconds pass."""
    from .distributed import launch_local

    device = ("cuda" if torch.cuda.is_available()
              and torch.cuda.device_count() >= n_devices else "cpu")
    outs = launch_local(n_devices, ["-m", "tetris_piclim_tpu_torch.parallel.dryrun",
                                    "--worker", device],
                        timeout=timeout)
    print(outs[0], end="", flush=True)
    return outs[0]


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        _worker(sys.argv[2])
    else:
        dryrun_multigpu(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
