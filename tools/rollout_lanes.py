"""Time the rollout CUDA kernel at each lane split on one NVIDIA GPU.

    python3 tools/rollout_lanes.py [--lanes 2 4 8 16] [--reps 10]

``csrc/rollout.cu`` splits each env over ``TETRIS_ROLLOUT_LANES`` lanes of a
warp, a compile-time constant. This script builds the kernel once per value
(``nvcc -DTETRIS_ROLLOUT_LANES=L``, all at once, into ``build/``), holds each
build word for word against ``rollout_reference`` (scripted actions, and the
Philox mode against ``philox_draws``; N=8191, K=64), and times it at the
benchmark shape (N=8192, K=1024, L=2/M=20, bank 256, Philox policy) with
CUDA events, in turns over two rounds. It prints the card's name and power
limit and one JSON line ``{"lanes": {"4": [ms, ms], ...}, "card": "..."}``.
The value kept in the source is the fastest here; PERF.md records the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetris_piclim_tpu_torch.gen.bank import ConfigBank  # noqa: E402
from tetris_piclim_tpu_torch.ops import _build  # noqa: E402
from tetris_piclim_tpu_torch.ops import bitboard as bb  # noqa: E402
from tetris_piclim_tpu_torch.ops import rollout as rollout_ops  # noqa: E402


def build(lanes: list[int]) -> dict[int, ctypes.CDLL]:
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in lanes:
        out = _build.BUILD / f"librollout-lanes{n}.so"
        log = out.with_suffix(".log").open("w")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DTETRIS_ROLLOUT_LANES={n}",
               "-o", str(out), str(_build.CSRC / "rollout.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                    out, log)
    libs = {}
    for n, (proc, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        report = out.with_suffix(".log").read_text()
        if rc != 0:
            raise RuntimeError(f"lanes {n}: nvcc exit {rc}\n{report}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  lanes {n}: {line.strip()}")
        lib = ctypes.CDLL(str(out))
        fn_name, argtypes = _build._SIGNATURES["rollout"]
        lib.rollout_launch.argtypes = argtypes
        lib.rollout_launch.restype = ctypes.c_int
        libs[n] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rollout_lanes: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    libs = build(args.lanes)
    bank = ConfigBank(2, 20, capacity=256, seed=1, device=dev).fill_device()
    rng = np.random.default_rng(0)

    def with_lanes(n: int, fn):
        """Run fn with the wrapper bound to the build for n lanes."""
        _build._LIBS["rollout"] = libs[n]
        try:
            return fn()
        finally:
            _build._LIBS.pop("rollout")

    # word for word against the plain version, ragged N
    n_chk, k_chk = 8191, 64
    boards = torch.as_tensor(rng.random((n_chk, 20, 10)) < 0.3, device=dev)
    boards[:, :6] = False
    state = bb.make_state_batch(
        boards, torch.as_tensor(rng.integers(0, 7, (n_chk, 21)), device=dev), 2, 20)
    g = lambda lo, hi: torch.as_tensor(  # noqa: E731
        rng.integers(lo, hi, (k_chk, n_chk)), dtype=torch.int32, device=dev)
    scripted = (g(0, 8), g(-3, 13), g(0, 256))
    philox = rollout_ops.philox_draws(7, n_chk, k_chk, 256, dev).actions
    refs = [rollout_ops.rollout_reference(state, bank.cols, bank.pieces, k_chk,
                                          actions=a) for a in (scripted, philox)]
    for n in args.lanes:
        kers = [with_lanes(n, lambda: rollout_ops.rollout_fused(
                    state, bank.cols, bank.pieces, k_chk, actions=scripted)),
                with_lanes(n, lambda: rollout_ops.rollout_fused(
                    state, bank.cols, bank.pieces, k_chk, seed=7))]
        for ker, ref in zip(kers, refs):
            same = all(torch.equal(x, y) for x, y in zip(ker[0], ref[0])) \
                and int(ker[1]) == int(ref[1]) and int(ker[2]) == int(ref[2])
            if not same:
                raise RuntimeError(f"lanes {n}: kernel and plain version differ")
        print(f"  lanes {n}: word-identical (scripted and Philox mode)")

    # times at the benchmark shape, in turns
    n_env, k_steps = 8192, 1024
    idx = torch.arange(n_env, device=dev) % bank.capacity
    state = bb.make_state_batch(bank.cols[idx], bank.pieces[idx], 2, 20)
    times: dict[str, list[float]] = {str(n): [] for n in args.lanes}
    for _ in range(2):
        for n in args.lanes:
            def run():
                rollout_ops.rollout_fused(state, bank.cols, bank.pieces,
                                          k_steps, seed=1)
            with_lanes(n, run)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                with_lanes(n, run)
            end.record()
            end.synchronize()
            times[str(n)].append(start.elapsed_time(end) / args.reps)
    for n, ms in times.items():
        print(f"  lanes {n}: {ms[0]:.4f} / {ms[1]:.4f} ms per launch of "
              f"{n_env} x {k_steps} env steps")
    print(json.dumps({"lanes": times, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
