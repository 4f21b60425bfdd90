"""One rank of the mesh scenarios of ``tests/test_torch_mesh.py`` on the CPU
(gloo), run through ``parallel.distributed.launch_local`` as ``python
torch_mesh_worker.py SCENARIO WORKDIR``:

* ``refresh`` (2 ranks): ``DQNTrainer.train(refresh_bank=True)`` on a
  2-rank mesh with the trainer's own host bank. Each rank records the bank
  rows every chunk read, the chunk metrics, the logged rows and whether it
  started producers; before the last chunk rank 0 waits until the
  producers' rows have landed, so the last chunk reads them.
* ``submesh`` (3 ranks): ``make_mesh(2)``; ranks 0-1 run the ``learner``
  and ``chunk_mlp`` scenarios of ``torch_parallel_worker.py`` on it, rank
  2 gets no mesh and exits; every rank checks that ``make_mesh(4)`` raises.

Each rank writes ``WORKDIR/<scenario>_rank<r>.pt``. Imports no JAX.
"""

from __future__ import annotations

import datetime
import multiprocessing
import sys
import time
from pathlib import Path

import torch

from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.parallel.distributed import init_distributed
from tetris_piclim_tpu_torch.parallel.mesh import STAGED, all_gather, make_mesh
from torch_parallel_worker import chunk, learner

torch.set_num_threads(1)
# rank 1 waits in a collective while rank 0 waits for the producers
GLOO_TIMEOUT = datetime.timedelta(seconds=150)
PRODUCER_WAIT_S = 120.0


def refresh(mesh, inp: dict) -> dict:
    started = []
    start = ConfigBank.start_refresh

    def record_start(bank, *a, **kw):
        started.append(mesh.rank)
        return start(bank, *a, **kw)

    ConfigBank.start_refresh = record_start
    trainer = DQNTrainer(inp["cfg"], device="cpu", mesh=mesh)
    init_rows = tuple(t.clone() for t in trainer.bank.rows)
    init_family = trainer.bank.family.copy()
    run, chunks, waited = trainer.run_chunk, [], []

    def recorded(n, rows=None):
        chunks.append({"rows": tuple(t.clone() for t in rows)})
        m = run(n, rows)
        chunks[-1]["metrics"] = {k: (v if isinstance(v, int) else v.clone())
                                 for k, v in m._asdict().items()}
        if mesh.is_root and len(chunks) == inp["chunks"] - 1:
            t0 = time.monotonic()
            while (trainer.bank.refresh_writes == 0
                   and time.monotonic() - t0 < PRODUCER_WAIT_S):
                time.sleep(0.05)
            waited.append(time.monotonic() - t0)
        return m

    trainer.run_chunk = recorded
    hist = trainer.train(total_steps=inp["chunks"] * inp["cfg"].log_every,
                         log_fn=None, refresh_bank=True)["history"]
    pool = trainer.bank._pool
    return {"init_rows": init_rows, "init_family": init_family,
            "chunks": chunks, "history": hist, "started": started,
            "waited_s": waited,
            "children_after": [p.pid for p in multiprocessing.active_children()],
            "producers_alive": [] if pool is None else
            [proc.is_alive() for proc, _ in pool.slots],
            "final_rows": trainer.bank.rows, "final_family": trainer.bank.family,
            "net": trainer.state.net.state_dict(),
            "env": {k: all_gather(mesh, v).flatten(0, 1)
                    for k, v in trainer.state.env._asdict().items()},
            "staged": STAGED["broadcasts"]}


def submesh(inputs: dict, workdir: Path) -> dict:
    mesh = make_mesh(2, device="cpu")
    out = {"mesh": None if mesh is None else (mesh.rank, mesh.size, mesh.src)}
    try:
        make_mesh(4, device="cpu")
    except ValueError as e:
        out["too_many"] = str(e)
    if mesh is not None:
        out["learner"] = learner(mesh, inputs["learner"], workdir)
        out["chunk_mlp"] = chunk(mesh, inputs["chunk_mlp"], workdir)
    return out


def main(scenario: str, workdir: Path) -> None:
    init_distributed(device="cpu", timeout=GLOO_TIMEOUT)
    rank = torch.distributed.get_rank()
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    if scenario == "refresh":
        out = refresh(make_mesh(device="cpu"), inputs["refresh"])
    else:
        out = submesh(inputs, workdir)
    torch.save(out, workdir / f"{scenario}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], Path(sys.argv[2]))
