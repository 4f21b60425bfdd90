"""Env-step throughput of the random-policy rollout, the shape of the repo's
``bench.py``.

``run()`` fills a bank on the host (``ConfigBank.fill``, carves), starts N
envs on its rows, and times ``repeats`` calls of
``ops/rollout.py::rollout_fused`` (the CUDA kernel on the GPU), each K
steps with the kernel's own Philox draws, keeping the best. It returns the
JSON keys of ``bench.py``: ``metric``, ``value`` (env steps per second),
``unit`` and ``vs_baseline`` (against the reference's single-core
``move()`` rate). The defaults are ``bench.py``'s shape; the CPU tests call
it small.

With ``train=True`` (the default; ``bench.py``'s ``BENCH_NO_MFU`` unset) it
adds the flagship training recipe's ``train_env_steps_per_s``,
``train_mfu`` and ``train_learner_share`` from
``bench_mfu.measure(num_envs=2048, scan=512, updates=4, bf16=True)``, as
``bench.py`` does. As there, the rollout's result survives an exception in
the training section, which is printed on stderr.
``python -m tetris_piclim_tpu_torch bench`` prints the result.
"""

from __future__ import annotations

import sys
import time

import torch

from .gen.bank import ConfigBank
from .ops import bitboard
from .ops.rollout import rollout_fused
from .utils.device import resolve_device

BASELINE_STEPS_PER_S = 49_000.0  # reference move()/s, 1 CPU core (BASELINE.md)


def run(num_envs: int = 8192, steps: int = 1024, bank: int = 256, L: int = 2,
        M: int = 20, repeats: int = 5, device="cuda", train: bool = True) -> dict:
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    b = ConfigBank(L, M, capacity=bank, seed=0, device=dev).fill()
    idx = torch.arange(num_envs, device=dev) % bank
    states = bitboard.make_state_batch(b.cols[idx], b.pieces[idx], L, M)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, episodes, _ = rollout_fused(states, b.cols, b.pieces, steps, seed=0)
    sync()
    compile_s = time.perf_counter() - t0
    if int(episodes) <= 0:
        raise RuntimeError("no episode ended in the rollout")
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        rollout_fused(states, b.cols, b.pieces, steps, seed=i + 1)
        sync()
        times.append(time.perf_counter() - t0)
    steps_per_s = num_envs * steps / min(times)
    result = {
        "metric": "env_steps_per_sec_per_chip",
        "value": round(steps_per_s, 1),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_s / BASELINE_STEPS_PER_S, 2),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "envs": num_envs, "steps": steps, "repeats_s": times,
        "bank_build_s": build_s, "first_call_s": compile_s,
    }
    if train:
        try:
            from .bench_mfu import measure

            mm = measure(num_envs=2048, scan=512, updates=4, bf16=True, device=dev)
            result["train_env_steps_per_s"] = mm["chunk_env_steps_per_s"]
            result["train_mfu"] = mm["chunk_mfu"]
            result["train_learner_share"] = mm["learner_share_of_chunk"]
        except Exception as e:  # noqa: BLE001 -- the headline must survive
            print(f"# mfu section unavailable: {e!r:.200}", file=sys.stderr)
    return result
