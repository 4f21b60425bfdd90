"""One rank of the port's data-parallel scenarios on the CPU (gloo).

Run by ``tests/test_torch_parallel.py`` through
``parallel.distributed.launch_local`` as ``python torch_parallel_worker.py
WORKDIR``: it reads ``WORKDIR/inputs.pt`` (written by the test), runs every
scenario on a 2-rank mesh and writes ``WORKDIR/<scenario>_rank<r>.pt``,
which the test holds against JAX's mesh and the one-process port. Imports
no JAX.
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path

import numpy as np
import torch

from tetris_piclim_tpu_torch.dqn import agent
from tetris_piclim_tpu_torch.dqn.replay import ReplayBuffer
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
from tetris_piclim_tpu_torch.models.qnet import QNetwork
from tetris_piclim_tpu_torch.parallel.distributed import init_distributed
from tetris_piclim_tpu_torch.parallel.mesh import all_gather, make_mesh
from torch_port_helpers import transitions

torch.set_num_threads(1)
GLOO_TIMEOUT = datetime.timedelta(seconds=60)


def make_bank(L: int, M: int, capacity: int) -> ConfigBank:
    return ConfigBank(L, M, capacity=capacity, seed=0, device="cpu").fill_device()


def make_net(kind: str, seed: int = 0):
    """``"mlp"``: None (the trainer's default MLP); ``"conv"``: the flagship
    net's layout at narrow widths, conv (4, 8) + dueling + joint."""
    if kind == "mlp":
        return None
    return ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                        generator=torch.Generator().manual_seed(seed))


def fill_ring(mesh, cap: int, n: int, writes: int, seed: int) -> ReplayBuffer:
    """The rank's ring after the writes of ``torch_port_helpers.filled_replays``
    (each rank writes its slice of every block)."""
    ring = ReplayBuffer(cap, "cpu", mesh=mesh, num_envs=n)
    k = n // mesh.size
    rng = np.random.default_rng(seed)
    for _ in range(writes):
        f = transitions(rng, n)
        ring.add_fields(*[torch.as_tensor(v[mesh.rank * k:(mesh.rank + 1) * k])
                          for v in f.values()])
    return ring


def learner(mesh, inp: dict, workdir: Path) -> dict:
    net, target = QNetwork(joint=False), QNetwork(joint=False)
    net.load_state_dict(inp["params"])
    target.load_state_dict(inp["params"])
    cfg = inp["cfg"]
    ring = fill_ring(mesh, inp["cap"], inp["n"], inp["writes"], inp["seed"])
    if "priority" in inp:
        ring.load_state_dict(dict(ring.state_dict(), priority=inp["priority"],
                                  max_prio=inp["priority"].max()))
    opt = agent.make_optimizer(net, cfg)
    losses = []
    for draw in inp["draws"]:
        kw = {"idx0": draw} if cfg.prioritized else {"j": draw}
        aux = agent.learner_update(net, target, opt, ring, cfg,
                                   step_gap=inp["n"], **kw)
        losses.append(float(aux["loss"]))
    return {"net": net.state_dict(), "target": target.state_dict(),
            "mu": opt.mu, "nu_max": opt.nu_max, "count": opt.count,
            "losses": losses, "replay": ring.state_dict()}


def gathered_env(mesh, env) -> dict:
    return {k: all_gather(mesh, v).flatten(0, 1) for k, v in env._asdict().items()}


def chunk(mesh, inp: dict, workdir: Path) -> dict:
    trainer = DQNTrainer(inp["cfg"], bank=make_bank(*inp["bank"]),
                         net=make_net(inp["net"]), device="cpu", mesh=mesh)
    m = trainer.run_chunk(inp["steps"])
    out = {"metrics": {k: (v if isinstance(v, int) else v.clone())
                       for k, v in m._asdict().items()},
           "net": trainer.state.net.state_dict(),
           "env": gathered_env(mesh, trainer.state.env),
           "replay": trainer.state.replay.state_dict(),
           "updates_done": trainer.state.updates_done}
    if "save_to" in inp:
        trainer.save_checkpoint(str(workdir / inp["save_to"]))
    return out


def restore(mesh, inp: dict, workdir: Path) -> dict:
    trainer = DQNTrainer(inp["cfg"], bank=make_bank(*inp["bank"]), device="cpu",
                         mesh=mesh)
    trainer.restore_checkpoint(str(workdir / inp["path"]))
    ts = trainer.state
    return {"env": ts.env._asdict(), "ring": dict(ts.replay.buf),
            "priority": ts.replay.priority, "pos": ts.replay.pos,
            "size": ts.replay.size, "net": ts.net.state_dict(),
            "global_step": ts.global_step}


SCENARIOS = {"learner": learner, "learner_per": learner, "chunk_mlp": chunk,
             "chunk_conv": chunk, "fused": chunk, "restore": restore}


def main(workdir: Path) -> None:
    init_distributed(device="cpu", timeout=GLOO_TIMEOUT)
    mesh = make_mesh(device="cpu")
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    for name, inp in inputs.items():
        fn = SCENARIOS[inp.get("kind", name)]
        out = fn(mesh, inp, workdir)
        torch.save(out, workdir / f"{name}_rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
