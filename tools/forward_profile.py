"""Where the forward-family bank's time goes on the GPU.

    python3 tools/forward_profile.py

Times, on one CUDA card, the device forward generator
(``gen/device_forward.generate_batch_device``, n=1024, beam 8, height 4) at
L=2/M=20 and L=10/M=30, the carver's 4096-row batch, and a whole
``ConfigBank.refresh_device`` of a 4096-row bank with 25% forward rows.
For each: the wall time (CUDA-synchronised, median of 3 after a warm-up),
then one more call under ``torch.profiler``: CUDA kernels launched, their
summed device time, and the kernels that take the most device time. Two
busy shares come from that device time: ``device_busy_share`` divides it by
the profiled call's own wall time, which the profiler's overhead inflates;
``device_share_of_median_wall`` divides it by the median unprofiled wall
time. Prints one JSON line per case and, last, the card's name and power
limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetris_piclim_tpu_torch.gen import device_carver, device_forward  # noqa: E402
from tetris_piclim_tpu_torch.gen.bank import ConfigBank  # noqa: E402

DEV = torch.device("cuda")


def wall_ms(fn, reps: int = 3) -> list[float]:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profiled(fn) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(_self_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_self_device_us, reverse=True)[:6]
    return {
        "profiled_wall_ms": wall,
        "kernel_launches": int(sum(e.count for e in kernels)),
        "kernel_device_ms": device_ms,
        "device_busy_share": device_ms / wall,
        "top_kernels": [{"name": e.key[:80], "count": int(e.count),
                         "device_ms": _self_device_us(e) / 1e3} for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("forward_profile: CUDA is not available", file=sys.stderr)
        return 1
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = {
        f"forward_L{L}_M{M}": (lambda L=L, M=M: device_forward.generate_batch_device(
            1024, L, M, 4, 8, generator=gen, device=DEV))
        for L, M in ((2, 20), (10, 30))
    }
    cases["carve_4096_L2_M20"] = lambda: device_carver.generate_batch_device(
        4096, 2, 20, generator=gen, device=DEV)
    bank = ConfigBank(2, 20, capacity=4096, seed=0, device=DEV).fill_device(
        forward_fraction=0.25)
    cases["refresh_4096_forward_0.25"] = lambda: bank.refresh_device(
        forward_fraction=0.25)
    for name, fn in cases.items():
        walls = wall_ms(fn)
        row = {"case": name, "wall_ms": walls}
        row.update(profiled(fn))
        row["device_share_of_median_wall"] = (
            row["kernel_device_ms"] / statistics.median(walls))
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
