"""Weak scaling of the data-parallel trainer over W ranks.

Counterpart of ``benchmarks/bench_multichip.py``: ``num_envs`` grows with
the rank count (512 envs per rank), and the rate is env-steps/s of the
whole per-step chunk (act, step, bank reset, replay write, learner with its
gradient all-reduce) at L=2/M=20, batch 128, replay ``8192 W``, 64-step
chunks, best of 3 after one warm-up chunk. ``efficiency(W) = sps(W) /
(W sps(1))``.

    python -m tetris_piclim_tpu_torch.bench_multigpu [--ranks 1,2,4] [--device cuda]

Each rank count is its own launch of W processes
(``parallel/distributed.py::launch_local``). With a card per rank they
join over NCCL; with more ranks than cards (or on the CPU) they share
devices over gloo, and the JSON then carries a ``caveat``: such a run
measures the sharing, not scaling. The last line of standard output is the
JSON; each rank count's row also goes to standard error.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import time

import torch

ENVS_PER_RANK = 512
CHUNK_STEPS = 64
REPEATS = 3
L, M = 2, 20


def _worker(device: str) -> None:
    from .dqn.train import DQNTrainer
    from .gen.bank import ConfigBank
    from .parallel.distributed import init_distributed, sync_hosts
    from .parallel.mesh import make_mesh
    from .utils.config import DQNConfig, EnvConfig, TrainConfig

    info = init_distributed(device=device, timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh(device=device)
    n = mesh.size
    cfg = TrainConfig(env=EnvConfig(L=L, M=M), dqn=DQNConfig(batch_size=128),
                      num_envs=ENVS_PER_RANK * n, bank_capacity=256,
                      replay_capacity=8192 * n, warmup_steps=1, seed=0)
    bank = ConfigBank(L, M, capacity=256, seed=0, device=mesh.device).fill_device()
    trainer = DQNTrainer(cfg, bank=bank, mesh=mesh)

    def chunk() -> float:
        sync_hosts()
        t0 = time.perf_counter()
        int(trainer.run_chunk(CHUNK_STEPS).episodes)  # waits for the chunk
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return time.perf_counter() - t0

    chunk()  # warm-up
    best = min(chunk() for _ in range(REPEATS))
    if mesh.is_root:
        print(json.dumps({"ranks": n, "backend": info["backend"],
                          "env_steps_per_s": CHUNK_STEPS * cfg.num_envs / best}),
              flush=True)
    torch.distributed.destroy_process_group()


def run(ranks: list, device: str = "cuda", timeout: float = 900.0) -> dict:
    """Launch each rank count in turn; returns the benchmark's JSON."""
    from .parallel.distributed import launch_local

    cards = torch.cuda.device_count() if device == "cuda" else 0
    rows, base = [], None
    for n in ranks:
        out = launch_local(n, ["-m", "tetris_piclim_tpu_torch.bench_multigpu",
                               "--worker", device], timeout=timeout)
        row = json.loads(out[0].strip().splitlines()[-1])
        base = row["env_steps_per_s"] if base is None else base
        row["weak_scaling_efficiency"] = row["env_steps_per_s"] / (n * base)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    res = {"metric": "weak_scaling_efficiency",
           "value": rows[-1]["weak_scaling_efficiency"],
           "unit": f"fraction at {ranks[-1]} ranks", "device": device,
           "device_kind": torch.cuda.get_device_name(0) if cards else "cpu",
           "cards": cards, "rows": rows}
    if max(ranks) > cards:
        res["caveat"] = (
            f"up to {max(ranks)} ranks share {cards or 'no'} card(s) "
            f"({'gloo' if cards else 'the CPU'}): this measures the sharing of "
            "one device, not scaling over cards; run with a card per rank "
            "for the scaling number")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default=None,
                    help="comma-separated rank counts (default: 1, 2, 4, ... up "
                         "to the card count)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker)
        return
    if args.ranks:
        ranks = [int(r) for r in args.ranks.split(",")]
    else:
        cards = max(torch.cuda.device_count() if args.device == "cuda" else 1, 1)
        ranks = [n for n in (1, 2, 4, 8) if n <= cards]
    print(json.dumps(run(ranks, args.device)))


if __name__ == "__main__":
    main()
