"""The port's benchmark tools run end to end at tiny sizes on the CPU:
``tools/actor_decomp.py`` (the decomposition of the per-step chunk),
``tools/generation_bench.py`` and ``tools/single_env_bench.py`` (the
harnesses of ``benchmarks/bench_generation.py`` and
``benchmarks/bench_single_env.py``), and ``tools/trainer_profile.py``,
which needs a card and refuses to run without one. The numbers are CPU
numbers and mean nothing; the shapes of the results are checked."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import actor_decomp  # noqa: E402
import generation_bench  # noqa: E402

torch.set_num_threads(1)


def test_actor_decomp_small(monkeypatch):
    monkeypatch.setattr(actor_decomp, "SCAN", 2)
    res = actor_decomp.decompose(
        actor_decomp.parse(["--num-envs", "32", "--batch", "16"]), device="cpu")
    rates = ("env_only", "rollout_kernel", "actor", "actor_replay", "full_u1", "full_u4")
    assert all(res[k] > 0 for k in rates)
    assert set(res["cost_us"]) == {"env", "net_forward+obs", "replay_write",
                                   "replay+learn_u1", "learn_u1", "extra_3_updates"}
    assert res["scan"] == 2 and res["device"] == "cpu"


def test_generation_bench_small():
    cpu = torch.device("cpu")
    host = generation_bench.bench_host_carver(L=2, M=8, n=3)
    dev = generation_bench.bench_device_carver(cpu, L=2, M=8, n=16)
    fwd = generation_bench.bench_forward_pipeline(L=1, M=8, seeds=3)
    beam = generation_bench.bench_device_forward(cpu, L=1, M=8, n=16, beams=(1, 2))
    assert host["value"] > 0 and dev["converged"] == 16
    assert 0 <= fwd["winnable"] <= 3 and fwd["value"] == fwd["thread"]
    assert {"bw1_yield", "bw2_winnable_per_s", "bw2_batch_ms"} <= set(beam)
    assert beam["value"] == beam["bw2_winnable_per_s"]


def _tool(args: list, timeout: int) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_single_env_bench_small():
    """Spawns the warm-reset producers: run in a subprocess under a timeout."""
    out = _tool(["tools/single_env_bench.py", "--moves", "300"], timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bench"] == "single_env_api_moves_per_s" and res["value"] > 0


def test_trainer_profile_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run at full size")
    out = _tool(["tools/trainer_profile.py"], timeout=120)
    assert out.returncode == 1 and "CUDA is not available" in out.stderr
