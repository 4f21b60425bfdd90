"""Profiling and MFU accounting of the port against the JAX package's
``utils/mfu.py`` and ``utils/profiling.py``, and the training benchmark
(``bench_mfu.measure``, ``bench.run``'s train keys, ``cli train
--profile-dir``, ``cli bench --no-train``) at tiny shapes on the CPU.

FLOP conventions. XLA's ``compiled_flops`` counts every HLO op of the
compiled program; the port's ``counted_flops`` (``FlopCounterMode``) counts
the model FLOPs of matrix products and convolutions, 2 per multiply-add.
So the MLP forward counts 0.66% less than XLA's (no bias adds or ReLUs),
one MLP learner update 2.54% less (no Huber loss, sampling or optimizer
arithmetic), and the conv forward 6.8% MORE: XLA leaves out the
zero-padded taps of the 3x3 SAME convolutions on the 20x10 board, torch
counts every tap of every output. Every count is linear in the batch."""

import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import filled_replays

from tetris_piclim_tpu.dqn import agent as jagent
from tetris_piclim_tpu.models.convnet import ConvQNetwork as JConv
from tetris_piclim_tpu.models.qnet import QNetwork as JQ
from tetris_piclim_tpu.utils import mfu as jmfu
from tetris_piclim_tpu.utils import profiling as jprof
from tetris_piclim_tpu.utils.config import DQNConfig as JDQNConfig
from tetris_piclim_tpu_torch import bench, bench_mfu, cli
from tetris_piclim_tpu_torch.dqn import agent as tagent
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
from tetris_piclim_tpu_torch.models.qnet import QNetwork
from tetris_piclim_tpu_torch.utils import mfu as tmfu
from tetris_piclim_tpu_torch.utils import profiling as tprof
from tetris_piclim_tpu_torch.utils.config import DQNConfig

torch.set_num_threads(1)

MLP_FWD_PER_ROW = 2 * (217 * 128 + 3 * 128 * 128 + 128 * 14)


def _xla_flops(fn, *args) -> float:
    return jmfu.compiled_flops(jax.jit(fn).lower(*args).compile())


@pytest.fixture
def card_named(monkeypatch):
    """A stub card: ``torch.device("cuda")`` whose name is what the test
    sets."""
    name = {}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name["kind"])

    def set_kind(kind: str) -> torch.device:
        name["kind"] = kind
        return torch.device("cuda")
    return set_kind


def test_peak_flops_and_mfu_follow_jax_arithmetic(card_named):
    tpu = types.SimpleNamespace(device_kind="TPU v5 lite")
    h100 = card_named("NVIDIA H100 80GB HBM3")
    assert jmfu.peak_flops(tpu) == 197e12
    assert tmfu.peak_flops(h100) == 989.4e12
    assert tmfu.peak_flops(card_named("NVIDIA H100 PCIe")) == 756e12
    for flops, secs in ((1e12, 0.5), (3.3e9, 2e-3), (7.0, 1.0)):
        h100 = card_named("NVIDIA H100 80GB HBM3")
        j, t = jmfu.mfu_from_flops(flops, secs, tpu), tmfu.mfu_from_flops(flops, secs, h100)
        assert sorted(t) == sorted(j)
        assert t["flops"] == j["flops"] == flops
        assert t["device_kind"] == "NVIDIA H100 80GB HBM3"
        assert t["mfu"] == flops / (secs * 989.4e12)
        assert t["mfu"] * t["peak_flops"] == pytest.approx(j["mfu"] * j["peak_flops"], rel=1e-12)
        for bad in ((0.0, secs), (flops, 0.0), (-flops, secs)):
            assert jmfu.mfu_from_flops(*bad, tpu) is None
            assert tmfu.mfu_from_flops(*bad, h100) is None
    # an unknown kind has no peak, on both sides
    for kind in ("NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB"):
        assert tmfu.peak_flops(card_named(kind)) is None
        assert tmfu.mfu_from_flops(1e12, 1.0, card_named(kind)) is None
    assert jmfu.peak_flops(types.SimpleNamespace(device_kind="cpu")) is None
    assert tmfu.peak_flops("cpu") is None
    assert tmfu.device_kind("cpu") == "cpu"


def test_mfu_counts_one_call():
    net, obs = QNetwork(), torch.zeros(64, 217)
    with torch.no_grad():
        assert tmfu.counted_flops(net, obs) == MLP_FWD_PER_ROW * 64
        assert tmfu.mfu(net, obs, elapsed_s=1.0, device="cpu") is None
    assert tmfu.counted_flops(lambda: torch.zeros(3) + 1) is None


def test_mlp_forward_flops_within_1pct_of_xla():
    n = 4096
    jn = JQ()
    obs = jnp.zeros((n, 217), jnp.float32)
    xla = _xla_flops(jn.apply, jn.init(jax.random.PRNGKey(0), obs[:1]), obs)
    with torch.no_grad():
        port = tmfu.counted_flops(QNetwork(), torch.zeros(n, 217))
    assert port == MLP_FWD_PER_ROW * n == 644_874_240
    assert xla == 649_125_888
    assert 0.99 <= port / xla <= 1.0


def test_conv_forward_flops_vs_xla_padding_convention():
    """Torch counts all 9 taps of every 3x3 output, XLA leaves out the
    zero-padded ones: the port's count is 1.0-1.10x XLA's (1.0685)."""
    n = 128
    jn = JConv(dueling=True, joint=True)
    obs = jnp.zeros((n, 217), jnp.float32)
    xla = _xla_flops(jn.apply, jn.init(jax.random.PRNGKey(0), obs[:1]), obs)
    with torch.no_grad():
        port = tmfu.counted_flops(ConvQNetwork(dueling=True, joint=True),
                                  torch.zeros(n, 217))
    # at 4096 rows: 41,450,082,304 (XLA) and 44,287,655,936 (port)
    assert port * 4096 // n == 44_287_655_936
    assert 1.0 <= port / xla <= 1.10
    assert port / xla == pytest.approx(1.0685, abs=1e-3)


def test_learner_update_flops_vs_xla():
    """One MLP update at batch 128: 3 forwards (online, online on s' for
    double DQN, target) and the backward (weight grads of all 5 layers,
    input grads of the last 4). The port counts 0.9746x XLA's, which also
    counts the loss, sampling and AdamW arithmetic; held to +-0.2%."""
    jr, tr = filled_replays(1024, 64, 8)
    jn = JQ()
    p = jn.init(jax.random.PRNGKey(0), jnp.zeros((1, 217)))
    opt = jagent.make_optimizer(JDQNConfig())

    def one(params, target, opt_state, rpl, key):
        return jagent.learner_update(params, target, opt_state, rpl, key,
                                     apply_fn=jn.apply, optimizer=opt,
                                     cfg=JDQNConfig(), step_gap=64,
                                     beta=jnp.float32(1.0))[:4]

    xla = _xla_flops(one, p, p, opt.init(p), jr, jax.random.PRNGKey(1))
    net = QNetwork()
    target = QNetwork()
    port = tmfu.counted_flops(
        tagent.learner_update, net, target, tagent.make_optimizer(net, DQNConfig()),
        tr, DQNConfig(), step_gap=64, generator=torch.Generator().manual_seed(0))
    fwd = MLP_FWD_PER_ROW * 128
    input_grads = fwd - 2 * 217 * 128 * 128
    assert port == 3 * fwd + fwd + input_grads == 93_650_944
    assert port / xla == pytest.approx(0.9746, abs=2e-3)


def test_section_timer_summary_matches_jax(monkeypatch):
    def run(timer_cls):
        clock = iter(np.cumsum([0.0, 0.25, 0.125, 1.5, 0.0625, 2.0, 0.03125]))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
        timer = timer_cls()
        for name in ("gen", "upload", "gen"):
            with timer.section(name):
                pass
        return timer.summary()

    got, want = run(tprof.SectionTimer), run(jprof.SectionTimer)
    assert got == want
    assert got["gen"]["count"] == 2 and got["upload"]["count"] == 1


def _trace(logdir) -> list:
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_device_trace_writes_parseable_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tprof.device_trace(str(logdir)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    names = {e.get("name") for e in _trace(logdir)}
    assert "aten::mm" in names
    with tprof.device_trace(None):  # no logdir: nothing is written
        torch.ones(2) + 1
    assert len(list(tmp_path.iterdir())) == 1


def test_cli_train_profile_dir_writes_trace(tmp_path, capsys):
    """``cli train --profile-dir`` on the CPU. Explicit tiny sizes rather than
    ``--smoke``, whose 400 steps trace ~1M CPU ops (~270 MB)."""
    logdir = tmp_path / "trace"
    rc = cli.main(["train", "--device", "cpu", "-L", "1", "-M", "8",
                   "--num-envs", "16", "--bank", "16", "--device-bank",
                   "--replay", "1024", "--warmup", "32", "--steps", "4",
                   "--log-every", "2", "--eval-episodes", "16",
                   "--profile-dir", str(logdir)])
    assert rc == 0
    assert "win_rate" in capsys.readouterr().out
    names = {e.get("name") for e in _trace(logdir)}
    assert "aten::addmm" in names or "aten::mm" in names


JAX_MEASURE_KEYS = {
    "bench", "num_envs", "scan", "updates", "dtype", "backend",
    "flop_accounting", "chunk_env_steps_per_s", "actor_forward_us",
    "actor_timing", "actor_gflops_per_call", "actor_mfu",
    "learner_s_per_chunk_equiv", "learner_share_of_chunk",
    "learner_gflops_per_update", "learner_mfu", "chunk_tflops", "chunk_mfu",
    "device_kind", "peak_tflops_bf16", "value",
}


def test_bench_mfu_measure_small_on_cpu():
    n, scan, updates = 16, 2, 1
    res = bench_mfu.measure(num_envs=n, scan=scan, updates=updates, bf16=True,
                            device="cpu")
    assert set(res) == JAX_MEASURE_KEYS
    for k in ("actor_mfu", "learner_mfu", "chunk_mfu", "value", "peak_tflops_bf16"):
        assert res[k] is None, k
    assert res["device_kind"] == "cpu" and res["dtype"] == "bf16"
    # the conv forward counts 10,812,416 FLOPs per observation (see above)
    assert res["actor_gflops_per_call"] == round(44_287_655_936 / 4096 * n / 1e9, 4)
    assert res["learner_gflops_per_update"] > 30 * res["actor_gflops_per_call"]
    assert res["chunk_tflops"] == round(
        scan * (res["actor_gflops_per_call"]
                + updates * res["learner_gflops_per_update"]) / 1e3, 3)
    assert res["chunk_env_steps_per_s"] > 0 and res["learner_s_per_chunk_equiv"] > 0


def test_bench_mfu_learner_share_from_one_clock():
    """The learner's share of the chunk comes from the trainer's clock
    inside the timed chunk, so it lies in (0, 1]; 1024 envs fill the
    1000-transition warmup in the first step, so every timed chunk learns."""
    res = bench_mfu.measure(num_envs=1024, scan=1, updates=1, bf16=True,
                            device="cpu")
    assert 0 < res["learner_share_of_chunk"] <= 1


def test_bench_run_train_keys_and_guard(monkeypatch, capsys):
    calls = []

    def fake_measure(**kw):
        calls.append(kw)
        return {"chunk_env_steps_per_s": 123.0, "chunk_mfu": 0.5,
                "learner_share_of_chunk": 0.75}

    monkeypatch.setattr(bench_mfu, "measure", fake_measure)
    small = dict(num_envs=32, steps=8, bank=16, L=1, M=8, repeats=1, device="cpu")
    res = bench.run(**small)
    assert calls == [{"num_envs": 2048, "scan": 512, "updates": 4, "bf16": True,
                      "device": torch.device("cpu")}]
    assert (res["train_env_steps_per_s"], res["train_mfu"],
            res["train_learner_share"]) == (123.0, 0.5, 0.75)
    assert "train_mfu" not in bench.run(**small, train=False) and len(calls) == 1

    def broken(**kw):
        raise RuntimeError("wedged")

    monkeypatch.setattr(bench_mfu, "measure", broken)
    res = bench.run(**small)
    assert res["value"] > 0 and "train_mfu" not in res
    assert "# mfu section unavailable: RuntimeError('wedged')" in capsys.readouterr().err


def test_cli_bench_train_flag(monkeypatch, capsys):
    seen = []

    def fake_run(device, train):
        seen.append(train)
        res = {"metric": "env_steps_per_sec_per_chip", "value": 1.0,
               "unit": "steps/s", "vs_baseline": 0.0, "device": "cpu"}
        if train:
            res.update(train_env_steps_per_s=2.0, train_mfu=None,
                       train_learner_share=0.9)
        return res

    monkeypatch.setattr(bench, "run", fake_run)
    for argv, keys in ((["bench", "--device", "cpu", "--no-train"], 4),
                       (["bench", "--device", "cpu"], 7)):
        assert cli.main(argv) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert len(out) == keys and out["metric"] == "env_steps_per_sec_per_chip"
    assert seen == [False, True]
    assert out["train_mfu"] is None and out["train_learner_share"] == 0.9
