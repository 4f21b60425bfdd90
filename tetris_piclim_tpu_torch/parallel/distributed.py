"""Process-group start-up and a barrier across processes.

Counterpart of ``tetris_piclim_tpu/parallel/distributed.py``. There one
process drives every local TPU chip and ``jax.distributed`` joins hosts;
here one process drives one device and ``torch.distributed`` joins the
processes: NCCL when each process has a GPU of its own, gloo on the CPU and
when processes share a GPU (NCCL refuses two ranks on one device).

Launch with ``torchrun --nproc-per-node=N script.py`` (it sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``), with :func:`launch_local` (the same variables, every rank
killed when one fails or a time limit passes), or give the coordinator's
address, the process count and this process's index to
:func:`init_distributed`. Without any of these a process runs alone and
:func:`init_distributed` does nothing.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def process_device(device="cuda") -> torch.device:
    """The device this process drives: ``cuda:<LOCAL_RANK mod cards>`` for
    a CUDA device without an index, else ``device`` itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device="cuda",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> dict:
    """Join the default process group when running as several processes.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` name the group; without them torchrun's environment
    variables do, and with neither this is a no-op. The backend is NCCL
    when ``device`` is CUDA and no two processes of this host share a card
    (``LOCAL_WORLD_SIZE``, else the world size, against the card count),
    else gloo. A CUDA device is made the current one. Every collective
    times out after ``timeout``. Returns JAX's summary keys plus
    ``backend`` and ``device``."""
    dev = process_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    launched = coordinator_address is not None or "MASTER_ADDR" in os.environ
    if launched and not dist.is_initialized():
        if coordinator_address is not None:
            kw = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
        else:
            kw = dict(init_method="env://")
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", "1"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        nccl = dev.type == "cuda" and local_world <= torch.cuda.device_count()
        backend = "nccl" if nccl else "gloo"
        if nccl:
            kw["device_id"] = dev
        dist.init_process_group(backend, timeout=timeout, **kw)
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": str(dev),
    }


def sync_hosts(tag: int = 0) -> None:
    """Barrier across every process of the group; a no-op without one.
    ``tag`` is accepted for JAX's signature and unused."""
    if dist.is_initialized():
        dist.barrier()


def free_port() -> int:
    """A TCP port that is free on this host now."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def launch_local(n: int, argv: list, *, timeout: float) -> list:
    """Run ``python <argv>`` as ``n`` ranks of one group on this host, with
    torchrun's environment variables (coordinator ``127.0.0.1`` on a free
    port), and return each rank's standard output. Every rank is killed
    when one fails or ``timeout`` seconds pass, and then this raises with
    the end of each rank's standard error."""
    port = free_port()
    root = str(Path(__file__).resolve().parents[2])
    procs, outs = [], []
    try:
        for r in range(n):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(n),
                       PYTHONPATH=os.pathsep.join(
                           p for p in (root, os.environ.get("PYTHONPATH")) if p))
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            outs.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *map(str, argv)],
                                          env=env, stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for out, err in outs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read().decode(errors="replace"),
                          err.read().decode(errors="replace")))
            out.close()
            err.close()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc}) stderr:\n{e[-3000:]}"
                          for r, (rc, (_, e)) in enumerate(zip(rcs, texts)))
        raise RuntimeError(f"{n} ranks of {argv}: exit codes {rcs}\n{tails}")
    return [o for o, _ in texts]
