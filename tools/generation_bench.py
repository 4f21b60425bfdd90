"""Generation throughput, the harness of ``benchmarks/bench_generation.py``.

    python3 tools/generation_bench.py [--workers N]

Prints one JSON line per benchmark:

* games/s of the host carver (``gen/carver.py``, L=10/M=30, 100 carves;
  the reference's soak loop, game/main.py:59-71) and of the device carver
  (``gen/device_carver.py``, 4096 rows, best of 3 after a warm-up, with the
  count that converged);
* winnable games/s of the host forward generate + prove pipeline
  (``gen/pipeline.py::generate_batch``, seeds 0-99 at L=2/M=20) on its
  thread pool and on its spawn-context process pool, each of ``--workers``
  workers (default: each executor's own), with the faster one and the
  host's core count. The tool loads torch only
  for the device benchmarks, so the spawned workers, which re-import it,
  import no torch;
* proven forward-family configs/s of the device generator and beam prover
  (``gen/device_forward.py``, n=1024, L=10/M=30) at beam widths 1, 4 and 8:
  the best rate of the (wins, time) pairs of 3 calls, the mean yield and
  the best batch time.

Device times are CUDA-synchronised (the device functions take a
``torch.device``; the CPU tests run them on the CPU at tiny sizes).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetris_piclim_tpu_torch.gen.carver import CarvingGenerator  # noqa: E402
from tetris_piclim_tpu_torch.gen.pipeline import generate_batch  # noqa: E402


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_host_carver(L=10, M=30, n=100) -> dict:
    rng = random.Random(0)
    t0 = time.perf_counter()
    for _ in range(n):
        CarvingGenerator(L, M, rng=rng).generate()
    dt = time.perf_counter() - t0
    return {"bench": "host_carver_games_per_s", "L": L, "M": M,
            "value": round(n / dt, 1),
            "reference_1core": 21.0}  # BASELINE.md, L=10 M=30


def bench_device_carver(dev, L=10, M=30, n=4096) -> dict:
    import torch

    from tetris_piclim_tpu_torch.gen import device_carver

    def call(seed):
        return device_carver.generate_batch_device(
            n, L, M, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)

    b = call(0)
    _sync(dev)
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        b = call(i + 1)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return {"bench": "device_carver_games_per_s", "L": L, "M": M, "n": n,
            "device": dev.type, "value": round(n / min(times), 1),
            "converged": int((b.n_moves > 0).sum()), "reference_1core": 21.0}


def bench_forward_pipeline(L=2, M=20, seeds=100, workers=None) -> dict:
    """The thread pool and the process pool on the same seed range: the
    greedy DFS prover is recursive Python over tiny arrays, so threads
    share the GIL, and processes pay their start-up and pickling."""
    out = {"bench": "forward_pipeline_winnable_per_s", "L": L, "M": M,
           "reference_2core": 19.4,  # BASELINE.md
           "workers": workers, "host_cores": os.cpu_count()}
    proved = {}
    for ex in ("thread", "process"):
        t0 = time.perf_counter()
        games = generate_batch(L, M, seed_start=0, seed_end=seeds,
                               workers=workers, executor=ex)
        dt = time.perf_counter() - t0
        out[ex] = round(len(games) / dt, 2)
        out[f"{ex}_batch_s"] = round(dt, 2)
        proved[ex] = [g.seed for g in games]
    if proved["process"] != proved["thread"]:
        raise AssertionError("the process pool proved other games than the threads")
    out["winnable"] = len(proved["thread"])
    out["value"] = max(out["thread"], out["process"])
    out["winner"] = "thread" if out["thread"] >= out["process"] else "process"
    return out


def bench_device_forward(dev, L=10, M=30, n=1024, beams=(1, 4, 8)) -> dict:
    import torch

    from tetris_piclim_tpu_torch.gen import device_forward

    out = {"bench": "device_forward_winnable_per_s", "L": L, "M": M, "n": n,
           "device": dev.type}
    for bw in beams:
        def call(seed):
            return device_forward.generate_batch_device(
                n, L, M, 4, bw,
                generator=torch.Generator(device=dev).manual_seed(seed),
                device=dev)

        call(0)
        _sync(dev)
        pairs = []
        for i in range(3):
            t0 = time.perf_counter()
            b = call(i + 1)
            wins = int(b.winnable.sum())
            pairs.append((wins, time.perf_counter() - t0))
        out[f"bw{bw}_winnable_per_s"] = round(max(w / t for w, t in pairs), 1)
        out[f"bw{bw}_yield"] = round(sum(w for w, _ in pairs) / (len(pairs) * n), 3)
        out[f"bw{bw}_batch_ms"] = round(min(t for _, t in pairs) * 1e3, 1)
    out["value"] = out[f"bw{beams[-1]}_winnable_per_s"]
    return out


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=None,
                    help="workers of each host pool (default: the executor's)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from tetris_piclim_tpu_torch.utils.device import resolve_device

    args = parse(argv)
    dev = resolve_device("cuda")
    for bench in (bench_host_carver, lambda: bench_device_carver(dev),
                  lambda: bench_forward_pipeline(workers=args.workers),
                  lambda: bench_device_forward(dev)):
        print(json.dumps(bench()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
