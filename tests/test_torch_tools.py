"""The port's benchmark tools run end to end at tiny sizes on the CPU:
``tools/actor_decomp.py`` (the decomposition of the per-step chunk),
``tools/generation_bench.py`` and ``tools/single_env_bench.py`` (the
harnesses of ``benchmarks/bench_generation.py`` and
``benchmarks/bench_single_env.py``), ``tools/learning_check.py`` (the
learning curve against the JAX run's, here against a stub curve), and
``tools/trainer_profile.py``, which needs a card and refuses to run without
one. The numbers are CPU
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


def test_learning_check_small(tmp_path):
    """The learning check at a tiny size on the CPU against a stub JAX curve:
    the JSON line's keys, and the band read at the rows of the band steps."""
    ref = {"num_envs": 32, "final_greedy_win_rate": 0.5,
           "history": [{"step": s, "win_rate": w}
                       for s, w in ((100, 0.02), (200, 0.9), (300, 0.04))]}
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    out = _tool(["tools/learning_check.py", "--device", "cpu", "-L", "1", "-M", "8",
                 "--num-envs", "32", "--bank", "16", "--steps", "300",
                 "--log-every", "100", "--eval-episodes", "64",
                 "--checkpoint-every", "100", "--out", str(tmp_path / "out"),
                 "--reference", str(tmp_path / "ref.json"),
                 "--band-steps", "100,300", "--band", "1.0"], timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"rows", "band", "env_steps_per_s", "wall_s", "card", "actor_fusion",
            "total_env_steps"} <= set(res)
    assert res["card"] is None and res["total_env_steps"] == 300 * 32
    assert [r["step"] for r in res["rows"]] == [100, 200, 300]
    assert [r["env_steps"] for r in res["rows"]] == [3200, 6400, 9600]
    assert [r["jax_win_rate"] for r in res["rows"]] == [0.02, 0.9, 0.04]
    band = res["band"]
    assert [(c["step"], c["jax"]) for c in band["training"]] == [(100, 0.02), (300, 0.04)]
    assert [c["port"] for c in band["training"]] == [
        res["rows"][0]["port_win_rate"], res["rows"][2]["port_win_rate"]]
    assert band["inside"] and band["first_row_outside"] is None  # width 1.0
    assert 0 <= band["greedy"]["port"] <= 1 and res["env_steps_per_s"] > 0
    assert sorted(p.name for p in (tmp_path / "out" / "ckpt").iterdir()) == ["final"]


def test_learning_check_curve_across_resumed_segments(tmp_path):
    """A resumed segment's rows replace the cut one's from its first step."""
    import learning_check

    row = "[{:>7}] env_steps=1.00e+00 win_rate={} loss=0.1 eps=0.05 sps=1.0e+03\n"
    (tmp_path / "segment_0.log").write_text(
        "".join(row.format(s, w) for s, w in ((10, 0.1), (20, 0.2), (30, 0.3))))
    (tmp_path / "segment_20.log").write_text(
        "resumed\n" + "".join(row.format(s, w) for s, w in ((10, 0.35), (20, 0.4))))
    curve = learning_check.read_curve(tmp_path, num_envs=4)
    assert [(r["step"], r["win_rate"], r["env_steps"]) for r in curve] == [
        (10, 0.1, 40), (20, 0.2, 80), (30, 0.35, 120), (40, 0.4, 160)]
    ref = {"num_envs": 4, "final_greedy_win_rate": 0.5,
           "history": [{"step": s, "win_rate": 0.3} for s in (10, 20, 30, 40)]}
    res = learning_check.compare(curve, ref, 0.06, [10, 30, 40], greedy=0.46)
    assert [c["inside"] for c in res["band"]["training"]] == [False, True, False]
    assert res["band"]["first_row_outside"] == 10 and not res["band"]["inside"]
    assert res["band"]["greedy"]["inside"]


@pytest.mark.parametrize("matmul", ["f32", "bf16"])
def test_learning_probe_small(matmul):
    """The probe at a tiny size; bf16 rounds every Linear's operands."""
    out = _tool(["tools/learning_probe.py", "--device", "cpu", "--num-envs", "32",
                 "--bank", "16", "--replay", "1024", "--steps", "200",
                 "--log-every", "100", "--eval-episodes", "32", "--seeds", "0,1",
                 "--matmul", matmul], timeout=150)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [r["seed"] for r in rows] == [0, 1]
    for r in rows:
        assert r["matmul"] == matmul and r["card"] is None
        assert r["env_steps"] == [3200, 6400] and len(r["win_rate"]) == 2
        assert 0 <= r["greedy_win_rate"] <= 1


def test_learning_probe_bf16_linear_is_one_bf16_pass():
    import learning_probe

    lin = torch.nn.Linear(7, 3)
    x = torch.randn(5, 7)
    forward = torch.nn.Linear.forward
    try:
        learning_probe.round_linear_inputs_to_bf16()
        got = lin(x)
    finally:
        torch.nn.Linear.forward = forward
    want = x.bfloat16().double() @ lin.weight.bfloat16().double().T + lin.bias.double()
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    assert not torch.equal(got, lin(x))
