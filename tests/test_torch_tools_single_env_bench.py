"""The port's tools run end to end at tiny sizes on the CPU:
``tools/single_env_bench.py`` (the harness of
``benchmarks/bench_single_env.py``). The numbers are CPU numbers and mean
nothing; the shapes of the results are checked."""

import json
import sys
from pathlib import Path

import torch
from torch_port_helpers import run_tool

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


def test_single_env_bench_small():
    """Spawns the warm-reset producers: run in a subprocess under a timeout."""
    out = run_tool(["tools/single_env_bench.py", "--moves", "300"], timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bench"] == "single_env_api_moves_per_s" and res["value"] > 0
