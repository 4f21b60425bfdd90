"""The port's tools run end to end at tiny sizes on the CPU:
``tools/generation_bench.py`` (the harness of
``benchmarks/bench_generation.py``). The numbers are CPU numbers and mean
nothing; the shapes of the results are checked."""

import json
import sys
from pathlib import Path

import torch
from torch_port_helpers import run_tool

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import generation_bench  # noqa: E402

torch.set_num_threads(1)


_PIPELINE_BENCH = """
import json, sys
sys.path.insert(0, "tools")
import generation_bench
print(json.dumps(generation_bench.bench_forward_pipeline(L=1, M=8, seeds=3, workers=2)))
"""


def test_generation_bench_small():
    """The host pipeline's bench spawns its process pool: run in a
    subprocess under a timeout."""
    cpu = torch.device("cpu")
    host = generation_bench.bench_host_carver(L=2, M=8, n=3)
    dev = generation_bench.bench_device_carver(cpu, L=2, M=8, n=16)
    out = run_tool(["-c", _PIPELINE_BENCH], timeout=120)
    assert out.returncode == 0, out.stderr
    fwd = json.loads(out.stdout.strip().splitlines()[-1])
    beam = generation_bench.bench_device_forward(cpu, L=1, M=8, n=16, beams=(1, 2))
    assert host["value"] > 0 and dev["converged"] == 16
    assert 0 <= fwd["winnable"] <= 3 and fwd["workers"] == 2
    assert fwd["value"] == max(fwd["thread"], fwd["process"])
    assert fwd["winner"] in ("thread", "process") and fwd["process_batch_s"] > 0
    assert generation_bench.parse(["--workers", "3"]).workers == 3
    assert {"bw1_yield", "bw2_winnable_per_s", "bw2_batch_ms"} <= set(beam)
    assert beam["value"] == beam["bw2_winnable_per_s"]
