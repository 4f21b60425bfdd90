"""Where one chunk of the flagship trainer's time goes on the GPU.

    python3 tools/trainer_profile.py

Builds the trainer of ``tetris_piclim_tpu_torch/bench_mfu.py::measure`` as
``bench`` runs it (L=5/M=25, conv (32, 64) + dueling + joint with a bf16
torso, 2048 envs, a 1024-row device bank, replay 131072, 4 learner updates
per step, the per-step path), warms it with one chunk of ``STEPS`` env
steps, times three more chunks (CUDA-synchronised), then runs one chunk
under ``torch.profiler`` (``tools/forward_profile.py::profiled``): the CUDA
kernels launched, their summed device time, the kernels that take the most
of it, and ``device_busy_share`` (device time over the profiled chunk's
wall time, which the profiler's overhead inflates) beside
``device_share_of_median_wall`` (over the median unprofiled chunk). Prints
one JSON line and, last, the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from forward_profile import profiled, wall_ms  # noqa: E402

from tetris_piclim_tpu_torch.bench_mfu import flagship_trainer  # noqa: E402

STEPS, UPDATES, NUM_ENVS = 64, 4, 2048


def main() -> int:
    if not torch.cuda.is_available():
        print("trainer_profile: CUDA is not available", file=sys.stderr)
        return 1
    tr = flagship_trainer(NUM_ENVS, STEPS, UPDATES, bf16=True)
    chunk = lambda: tr._chunk_plain(STEPS)  # noqa: E731
    walls = wall_ms(chunk)
    row = {"case": f"flagship_chunk_{STEPS}_steps_u{UPDATES}", "bf16": True,
           "num_envs": NUM_ENVS, "wall_ms": walls}
    row.update(profiled(chunk))
    row["device_share_of_median_wall"] = (
        row["kernel_device_ms"] / statistics.median(walls))
    row["launches_per_step"] = row["kernel_launches"] / STEPS
    print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
