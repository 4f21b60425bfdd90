"""Where a launch of the actor CUDA kernel spends its time, on one NVIDIA GPU.

    python3 tools/actor_time.py [--also name=path/to/actor.cu ...]

Times the kernel launch alone (``ops/actor.py::prepare_actor_launch``:
buffers prepared once, CUDA events around 50 launches) at the trainer's
shape (N=4096 envs, head 14, a 256-row bank window, Philox draws) for K = 1,
8 and 16 steps, and prints the time of a launch and of one further step.

It does so for ``csrc/actor.cu`` as it is and for copies of it with parts
compiled out, which shows what a step waits for (the copies compute wrong
values; only their times mean anything):

* ``nocopy``: no weight slab is copied into the ring;
* ``nomma``: no mma instruction is issued;
* ``nocopy_nomma``: neither, which leaves the observation, the fragment
  loads and splits, the epilogues, the head's bookkeeping, the env phase
  and the barriers.

The copies are made by replacing marked lines of the source text; the
script stops if a line it needs has changed. ``--also`` adds other actor
sources with the same C entry point (an older or an experimental kernel,
with ``env_step.cuh`` beside it), built and timed in turns with the rest.
Everything is built into ``build/actor_time/``. Prints the card's name and
power limit and one JSON line with all times in microseconds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetris_piclim_tpu_torch.gen.bank import ConfigBank  # noqa: E402
from tetris_piclim_tpu_torch.models.qnet import QNetwork  # noqa: E402
from tetris_piclim_tpu_torch.ops import _build  # noqa: E402
from tetris_piclim_tpu_torch.ops import actor as actor_ops  # noqa: E402
from tetris_piclim_tpu_torch.ops import bitboard as bb  # noqa: E402

OUT = _build.BUILD / "actor_time"

# (macro, line(s) of csrc/actor.cu, replacement); every line must occur once
PATCHES = [
    ("ABLATE_NOCOPY",
     "  const int t = threadIdx.x;\n  const int layer = s / kSlabsPerLayer;\n",
     "  const int t = threadIdx.x;\n#ifdef ABLATE_NOCOPY\n  return;\n#endif\n"
     "  const int layer = s / kSlabsPerLayer;\n"),
    ("ABLATE_NOMMA",
     "          mma_tf32(d[mt][nt], ah[mt], bl[nt]);\n"
     "          mma_tf32(d[mt][nt], al[mt], bh[nt]);\n"
     "          mma_tf32(d[mt][nt], ah[mt], bh[nt]);\n",
     "#ifndef ABLATE_NOMMA\n"
     "          mma_tf32(d[mt][nt], ah[mt], bl[nt]);\n"
     "          mma_tf32(d[mt][nt], al[mt], bh[nt]);\n"
     "          mma_tf32(d[mt][nt], ah[mt], bh[nt]);\n"
     "#endif\n"),
    ("ABLATE_NOMMA",
     "            mma_tf32(d, ah, bl);\n"
     "            mma_tf32(d, al, bh);\n"
     "            mma_tf32(d, ah, bh);\n",
     "#ifndef ABLATE_NOMMA\n"
     "            mma_tf32(d, ah, bl);\n"
     "            mma_tf32(d, al, bh);\n"
     "            mma_tf32(d, ah, bh);\n"
     "#endif\n"),
]
ABLATIONS = {"kernel": [], "nocopy": ["-DABLATE_NOCOPY"], "nomma": ["-DABLATE_NOMMA"],
             "nocopy_nomma": ["-DABLATE_NOCOPY", "-DABLATE_NOMMA"]}


def patched_source() -> Path:
    text = (_build.CSRC / "actor.cu").read_text()
    for _, old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"actor.cu has changed: cannot find\n{old}")
        text = text.replace(old, new)
    (OUT / "actor.cu").write_text(text)
    (OUT / "env_step.cuh").write_text((_build.CSRC / "env_step.cuh").read_text())
    return OUT / "actor.cu"


def build(jobs: dict[str, tuple[Path, list[str]]]) -> dict[str, ctypes.CDLL]:
    procs = {}
    for name, (src, flags) in jobs.items():
        out = OUT / f"libactor-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(out))
        lib.actor_launch.argtypes = _build._SIGNATURES["actor"][1]
        lib.actor_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--also", nargs="*", default=[], metavar="NAME=PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("actor_time: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    OUT.mkdir(parents=True, exist_ok=True)
    src = patched_source()
    jobs = {name: (src, flags) for name, flags in ABLATIONS.items()}
    for item in args.also:
        name, path = item.split("=", 1)
        jobs[name] = (Path(path), [])
    libs = build(jobs)

    bank = ConfigBank(2, 20, capacity=256, seed=1, device=dev).fill_device()
    n = 4096
    idx = torch.arange(n, device=dev) % bank.capacity
    state = bb.make_state_batch(bank.cols[idx], bank.pieces[idx], 2, 20)
    net = QNetwork(generator=torch.Generator().manual_seed(0)).to(dev)

    def launch_us(k_steps: int) -> float:
        launch, _ = actor_ops.prepare_actor_launch(
            state, net, bank.cols, bank.pieces, 0, 1, eps_start=0.9,
            eps_end=0.05, eps_decay=1000.0, n_steps=k_steps)
        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 50 * 1e3

    times: dict[str, list[dict]] = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            _build._LIBS["actor"] = lib
            try:
                by_k = {k: launch_us(k) for k in (1, 8, 16)}
            finally:
                _build._LIBS.pop("actor")
            row = {"k1": by_k[1], "k8": by_k[8], "k16": by_k[16],
                   "per_step": (by_k[16] - by_k[8]) / 8}
            times[name].append(row)
            print(f"  {name}: K=1 {row['k1']:.1f} us, K=8 {row['k8']:.1f} us, "
                  f"K=16 {row['k16']:.1f} us; {row['per_step']:.2f} us per step")
    print(json.dumps({"actor_launch_us": times, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
