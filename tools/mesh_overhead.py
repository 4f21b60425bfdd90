"""What a one-rank NCCL mesh adds to one learner update, on one card.

    python3 tools/mesh_overhead.py [--model mlp|flagship] [--updates 200]

Fills a replay ring of 131072 random transitions written by 4096 envs,
then times ``learner_update`` (batch 128) without a mesh and on a one-rank
NCCL mesh, the two in turns (plain, mesh, mesh, plain), each over
``--updates`` updates after a warm-up: host clock around a synchronised
run. Then the pieces the mesh adds: the all-reduce of the flat gradient
buffer alone (per call with no synchronise between calls, and with one
after each), and the host's synchronising calls per update, counted by
``torch.profiler`` for each learner. Prints one JSON line and, last, the
card's name and power limit. The process joins its own one-rank group on
``127.0.0.1``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetris_piclim_tpu_torch.dqn import agent  # noqa: E402
from tetris_piclim_tpu_torch.dqn.replay import ReplayBuffer  # noqa: E402
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork  # noqa: E402
from tetris_piclim_tpu_torch.models.qnet import QNetwork  # noqa: E402
from tetris_piclim_tpu_torch.parallel.distributed import (  # noqa: E402
    free_port, init_distributed,
)
from tetris_piclim_tpu_torch.parallel.mesh import all_reduce, make_mesh  # noqa: E402
from tetris_piclim_tpu_torch.utils.config import DQNConfig  # noqa: E402

CAP, NUM_ENVS, BATCH = 131072, 4096, 128


def random_ring(dev, mesh=None) -> ReplayBuffer:
    ring = ReplayBuffer(CAP, dev, mesh=mesh, num_envs=NUM_ENVS if mesh else None)
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda hi, dt=torch.int32, shape=(): torch.randint(  # noqa: E731
        0, hi, (NUM_ENVS, *shape), generator=g, device=dev, dtype=dt)
    for _ in range(CAP // NUM_ENVS):
        ring.add_fields(r(1 << 20, shape=(10,)), r(7, torch.int8), r(7, torch.int8),
                        r(4), r(21), r(4, torch.int8), r(10, torch.int8),
                        r(3).float() - 1.0, r(5) == 0, r(1 << 20, shape=(10,)),
                        r(7, torch.int8), r(7, torch.int8), r(4), r(21),
                        r(3, torch.int8))
    return ring


def make_net(model: str):
    if model == "mlp":
        return QNetwork(generator=torch.Generator().manual_seed(0))
    return ConvQNetwork(channels=(32, 64), dueling=True, joint=True,
                        generator=torch.Generator().manual_seed(0))


def learner(model: str, ring: ReplayBuffer, dev):
    net = make_net(model).to(dev)
    target = copy.deepcopy(net)
    cfg = DQNConfig(batch_size=BATCH)
    opt = agent.make_optimizer(net, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    return lambda: agent.learner_update(net, target, opt, ring, cfg,  # noqa: E731
                                        step_gap=NUM_ENVS, generator=gen), net


def ms_per_call(fn, n: int, sync_each: bool = False) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        if sync_each:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def host_syncs(fn, n: int) -> dict:
    """Synchronising CUDA runtime calls and kernel launches per call."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    syncs = {e.key: e.count / n for e in ev if "Synchronize" in e.key}
    kernels = sum(e.count for e in ev
                  if e.device_type == torch.autograd.DeviceType.CUDA) / n
    return {"sync_calls_per_update": syncs, "kernels_per_update": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="mlp", choices=("mlp", "flagship"))
    ap.add_argument("--updates", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_overhead: CUDA is not available", file=sys.stderr)
        return 1
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(free_port())),
                 ("WORLD_SIZE", "1"), ("RANK", "0")):
        os.environ.setdefault(k, v)
    info = init_distributed()
    mesh = make_mesh()
    dev = mesh.device
    plain_ring = random_ring(dev)
    mesh_ring = ReplayBuffer(CAP, mesh=mesh, num_envs=NUM_ENVS)
    mesh_ring.load_state_dict(plain_ring.state_dict())
    plain, _ = learner(args.model, plain_ring, dev)
    meshed, net = learner(args.model, mesh_ring, dev)
    n = args.updates
    order = [("plain", plain), ("mesh", meshed), ("mesh", meshed), ("plain", plain)]
    runs = {"plain": [], "mesh": []}
    for label, fn in order:
        runs[label].append(ms_per_call(fn, n))
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    res = {
        "model": args.model, "backend": info["backend"], "updates": n,
        "batch": BATCH, "ms_per_update": runs,
        "all_reduce_floats": flat.numel(),
        "all_reduce_ms_per_call": ms_per_call(lambda: all_reduce(mesh, flat), n),
        "all_reduce_ms_per_call_synced": ms_per_call(
            lambda: all_reduce(mesh, flat), n, sync_each=True),
        "profile_plain": host_syncs(plain, 20),
        "profile_mesh": host_syncs(meshed, 20),
    }
    print(json.dumps(res), flush=True)
    torch.distributed.destroy_process_group()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
