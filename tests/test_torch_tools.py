"""The port's benchmark tools run end to end at tiny sizes on the CPU:
``tools/actor_decomp.py`` (the decomposition of the per-step chunk),
``tools/generation_bench.py`` and ``tools/single_env_bench.py`` (the
harnesses of ``benchmarks/bench_generation.py`` and
``benchmarks/bench_single_env.py``), ``tools/learning_check.py`` (the
learning curve against the JAX run's, here against a stub curve; the
flagship recipe's reading of its committed JAX log, rows and
``final_eval``; the held-out block and its bands; flags that do not read
the total steps; the flagship recipe and ``--holdout-only`` at a toy
size; the 100k recipe against JAX's run that stops there, its held-out
block and the forward family split by provenance),
``tools/optimizer_check.py`` (the learner's optimizer as loops against
the package's foreach version, word for word), ``tools/holdout_rows.py``
(every held-out row of a policy file played once),
``tools/learning_probe.py`` (either package's trainer; ``--jax-root`` here
on a stub package; the bfloat16 forward-and-backward ``nn.Linear``), and
``tools/trainer_profile.py``, which needs a card and refuses to run without
one. The numbers are CPU
numbers and mean nothing; the shapes of the results are checked."""

import dataclasses
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
    out = _tool(["-c", _PIPELINE_BENCH], timeout=120)
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


def _tool(args: list, timeout: int) -> subprocess.CompletedProcess:
    # one thread, as in this process: on a busy machine torch's default of
    # one thread per core makes a tiny run wait on the others for minutes
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
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


def test_learning_check_flagship_recipe_reads_the_jax_log():
    """``--recipe flagship``: round 4 stage C's flags, and JAX's rows read
    from ``results/train_r4_L5df500.log`` at the band steps."""
    import learning_check

    a = learning_check.parse(["--recipe", "flagship", "--device", "cpu"])
    assert (a.lines, a.moves, a.num_envs, a.bank, a.log_every, a.checkpoint_every) == (
        5, 25, 2048, 4096, 1000, 10_000)
    assert (a.steps, a.eval_episodes, a.eval_holdout, a.holdout_bank) == (
        500_000, 8192, True, 2048)
    cmd = learning_check.train_command(a, a.steps, "CKPT")
    flags = " ".join(cmd[cmd.index("train") + 1:])
    for want in ("-L 5 -M 25", "--num-envs 2048", "--bank 4096 --device-bank",
                 "--steps 500000", "--log-every 1000", "--eval-episodes 8192",
                 "--seed 0", "--model conv --dueling --joint --updates 4 "
                 "--device-refresh 1 --device-forward 0.25"):
        assert want in flags, (want, flags)
    assert "--eval-holdout" not in flags  # only the segment that ends the run
    last = " ".join(learning_check.train_command(a, 50_000, "CKPT", "HOLD"))
    assert "--steps 50000" in last
    assert last.endswith("--eval-holdout --holdout-bank 2048 --save-holdout HOLD")
    ref = learning_check.read_reference(a.reference, a.num_envs)
    rows = {r["step"]: r["win_rate"] for r in ref["history"]}
    assert len(rows) == 500 and min(rows) == 1000 and max(rows) == 500_000
    assert [rows[s] for s in (20_000, 25_000, 30_000, 40_000, 50_000, 75_000, 100_000)] == [
        0.058, 0.100, 0.162, 0.301, 0.396, 0.520, 0.579]
    assert ref["final_greedy_win_rate"] == 0.947265625
    band_steps = [int(x) for x in a.band_steps.split(",")]
    assert band_steps == [25_000, 50_000, 75_000, 100_000, 150_000, 200_000,
                          300_000, 400_000, 500_000]
    # a run cut at 60k: the rows reached are held, the others wait, and so
    # does the greedy win rate (JAX's is at 500k)
    curve = [{"step": s, "env_steps": s * 2048, "win_rate": rows[s] + 0.04,
              "loss": 0.1, "sps": 5e4} for s in range(1000, 60_001, 1000)]
    res = learning_check.compare(curve, ref, 0.05, band_steps, greedy=0.6)
    assert [c["inside"] for c in res["band"]["training"]] == [True, True] + [None] * 7
    assert res["band"]["first_row_outside"] is None and not res["band"]["inside"]
    assert res["band"]["greedy"] == {"port": 0.6, "jax": 0.947265625, "inside": None}
    res = learning_check.compare(curve[:50], ref, 0.03, band_steps, greedy=None)
    assert [c["inside"] for c in res["band"]["training"]] == [False, False] + [None] * 7
    assert res["band"]["first_row_outside"] == 25_000
    default = learning_check.parse([])
    assert (default.recipe, default.lines, default.num_envs, default.flags) == (
        "l2", 2, 4096, [])
    assert (default.steps, default.eval_episodes, default.eval_holdout) == (
        100_000, 4096, False)


def test_read_reference_final_eval_of_the_jax_log():
    """The JAX run's ``final_eval`` line (``train_r4_L5df500.log:503``) and
    its rows from 100k to 500k steps."""
    import learning_check

    ref = learning_check.read_reference(str(learning_check.FLAGSHIP_REFERENCE), 2048)
    final = ref["final_eval"]
    assert [final[k]["win_rate"] for k in
            ("train_bank", "holdout", "holdout_carve", "holdout_forward")] == [
        0.947265625, 0.9334716796875, 0.968505859375, 0.900390625]
    assert final["holdout"]["families"] == {"carve": 1024, "forward": 1024}
    assert all(final[k]["episodes"] == 8192 for k in final)
    rows = {r["step"]: r["win_rate"] for r in ref["history"]}
    assert [rows[s] for s in (100_000, 150_000, 200_000, 300_000, 400_000, 500_000)] == [
        0.579, 0.648, 0.686, 0.737, 0.762, 0.791]


def _reading(step, holdout, carve, forward, train_bank, key="bank"):
    ev = {"holdout": {"win_rate": holdout, "episodes": 8192,
                      "families": {"carve": 1024, "forward": 1024},
                      "build": {"host_forward": 700, "device_forward": 324}},
          "holdout_carve": {"win_rate": carve}, "holdout_forward": {"win_rate": forward},
          key: {"win_rate": train_bank}}
    return {"step": step, "source": "eval", "eval": ev}


@pytest.mark.parametrize("reading,inside", [
    (_reading(500_000, 0.92, 0.95, 0.89, 0.93, key="train_bank"),
     {"holdout": True, "carve": True, "forward": True, "train_bank": True}),
    (_reading(150_000, 0.90, 0.918, 0.851, 0.91),
     {"holdout": False, "carve": False, "forward": True, "train_bank": False}),
    (None, {"holdout": None, "carve": None, "forward": None, "train_bank": None}),
], ids=["inside", "outside", "not-reached"])
def test_compare_held_out_block(reading, inside):
    """The held-out block: each win rate inside or outside its band (0.03
    in all and on the training bank, 0.05 per family), None where the port
    has no reading yet."""
    import learning_check

    ref = learning_check.read_reference(str(learning_check.FLAGSHIP_REFERENCE), 2048)
    curve = [{"step": 1000, "env_steps": 2048 * 1000, "win_rate": 0.0, "loss": 0.1,
              "sps": 5e4}]
    block = learning_check.compare(curve, ref, 0.05, [], None, reading)["held_out"]
    assert {k: r["inside"] for k, r in block["rows"].items()} == inside
    assert {k: (r["jax"], r["band"]) for k, r in block["rows"].items()} == {
        "holdout": (0.9334716796875, 0.03), "carve": (0.968505859375, 0.05),
        "forward": (0.900390625, 0.05), "train_bank": (0.947265625, 0.03)}
    assert block["jax_step"] == 500_000
    assert block["families"]["jax"] == {"carve": 1024, "forward": 1024}
    if reading is None:
        assert block["port_step"] is None and block["inside"] is None
        assert all(r["port"] is None for r in block["rows"].values())
    else:
        assert block["port_step"] == reading["step"]
        assert block["inside"] == all(inside.values())
        assert block["build"] == {"host_forward": 700, "device_forward": 324}
        assert block["families"]["port"] == {"carve": 1024, "forward": 1024}


def test_flagship_flags_do_not_read_total_steps():
    """Each call passes ``cli train`` its own segment's length, not JAX's
    500k: the config differs in ``total_steps`` alone, and nothing the
    flagship trainer does with it moves. Epsilon decays by a constant from
    the global step, the forward height is fixed at 4 (``height_at``
    ignores the total), PER (whose beta anneals over the total) and the
    demo refresh are off."""
    import learning_check

    from tetris_piclim_tpu_torch import cli
    from tetris_piclim_tpu_torch.dqn import agent
    from tetris_piclim_tpu_torch.dqn.train import height_at

    a = learning_check.parse(["--recipe", "flagship", "--device", "cpu"])
    parsed = []
    for steps in (50_000, 100_000, 500_000):
        cmd = learning_check.train_command(a, steps, "CKPT")
        parsed.append(cli.build_parser().parse_args(cmd[cmd.index("train"):]))
    cfgs = [cli._config(args) for args in parsed]
    assert [c.total_steps for c in cfgs] == [50_000, 100_000, 500_000]
    assert all(dataclasses.replace(c, total_steps=0) == dataclasses.replace(
        cfgs[0], total_steps=0) for c in cfgs)
    cfg = cfgs[-1]
    assert not cfg.dqn.prioritized and cfg.demo_every == 0
    heights = {cli._parse_height(args.device_height) for args in parsed}
    assert heights == {(4, 4)}
    for done in (0, 1000, 49_000, 50_000, 99_000, 250_000, 499_000):
        assert {height_at((4, 4), done, total)
                for total in (1000, 50_000, 100_000, 500_000)} == {4}
    eps = [agent.eps_schedule(step, cfg.dqn) for step in (0, 1000, 5000, 150_000)]
    assert eps[0] == pytest.approx(0.9) and eps[-1] == pytest.approx(0.05)
    assert eps == [agent.eps_schedule(step, cfgs[0].dqn) for step in (0, 1000, 5000, 150_000)]


def test_learning_check_flagship_holdout_small(tmp_path):
    """``--recipe flagship`` on the CPU at a toy size, to ``--steps`` in one
    call: the last segment ends in the held-out evaluation, and the result
    holds a ``held_out`` block with family counts and the rows' provenance;
    then ``--holdout-only`` reads the final checkpoint through ``cli eval``."""
    out = _tool(["tools/learning_check.py", "--recipe", "flagship", "--device", "cpu",
                 "-L", "1", "-M", "8", "--num-envs", "8", "--bank", "16",
                 "--steps", "20", "--log-every", "10", "--checkpoint-every", "10",
                 "--eval-episodes", "32", "--holdout-bank", "16",
                 "--out", str(tmp_path)], timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r["step"] for r in res["rows"]] == [10, 20] and res["last_step"] == 20
    block = res["held_out"]
    assert block["port_step"] == 20 and block["episodes"] == 32
    assert block["families"]["port"] == {"carve": 8, "forward": 8}
    assert block["families"]["jax"] == {"carve": 1024, "forward": 1024}
    assert all(0 <= r["port"] <= 1 and isinstance(r["inside"], bool)
               for r in block["rows"].values())
    build = block["build"]
    assert build["host_forward"] + build["device_forward"] == 8 and build["carve"] == 8
    assert build["seconds"] > 0 and build["host_seeds"] >= 100
    assert [s["first_step"] for s in res["segments"]] == [0]
    assert res["segments"][0]["env_steps_per_s"] > 0
    assert (tmp_path / "holdout_20" / "bank.pt").exists()


def test_learning_check_holdout_only_small(tmp_path):
    """``--holdout-only`` reads a checkpoint's held-out evaluation through
    ``cli eval`` (its weights and live training bank) and trains nothing;
    the reading joins the run's result beside the segments already there."""
    import learning_check

    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.utils.checkpoint import save_bank
    from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=1, M=8), num_envs=8, bank_capacity=16,
                      replay_capacity=64, seed=0)
    bank = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device(
        forward_fraction=0.25)
    net = ConvQNetwork(dueling=True, joint=True, generator=torch.Generator().manual_seed(0))
    trainer = DQNTrainer(cfg, bank=bank, net=net, device="cpu")
    trainer.state.global_step = 30
    ckpt = str(tmp_path / "ckpt" / "final")
    trainer.save_checkpoint(ckpt)
    save_bank(ckpt, trainer.bank)
    row = "[{:>7}] env_steps=1.00e+00 win_rate=0.5 loss=0.1 eps=0.05 sps=1.0e+03\n"
    (tmp_path / "segment_0.log").write_text(row.format(10) + row.format(30))
    (tmp_path / "segment_0.json").write_text(json.dumps(
        {"first_step": 0, "stop_step": 30, "wall_s": 1.0, "card": None,
         "greedy": None}))
    out = _tool(["tools/learning_check.py", "--recipe", "flagship", "--device", "cpu",
                 "-L", "1", "-M", "8", "--num-envs", "8", "--bank", "16",
                 "--log-every", "10", "--eval-episodes", "32", "--holdout-bank", "16",
                 "--holdout-only", "--resume", ckpt, "--out", str(tmp_path)], timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r["step"] for r in res["rows"]] == [10, 30] and len(res["segments"]) == 1
    assert [(r["step"], r["source"]) for r in res["held_out_readings"]] == [(30, "eval")]
    block = res["held_out"]
    assert block["port_step"] == 30 and block["families"]["port"] == {
        "carve": 8, "forward": 8}
    # cli eval's "bank" is the checkpoint's training bank, at the draws
    # DQNTrainer.evaluate makes
    assert block["rows"]["train_bank"]["port"] == trainer.evaluate(32)["win_rate"]
    assert learning_check.resume_step(ckpt) == 30
    assert (tmp_path / "holdout_30" / "bank.pt").exists()


JAX_100K = {"holdout": 0.7978515625, "carve": 0.837646484375,
            "forward": 0.74755859375, "train_bank": 0.831787109375}
BANDS = {"holdout": 0.03, "carve": 0.05, "forward": 0.05, "train_bank": 0.03}


def test_flagship100k_recipe_reads_the_jax_run():
    """``--recipe flagship100k``: the flagship flags for 100k steps with a
    4096-episode evaluation on the training bank and none held out in the
    run, as ``tools/round3e.sh`` stage 1 ran them. JAX's 100 rows
    (``train_r3_L5df.log``) are the first 100 of the 500k run's, and
    ``final_eval`` joins the log's training-bank win rate to the held-out
    ones of ``eval_r3_L5df.json``."""
    import learning_check as lc

    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu"])
    full = lc.parse(["--recipe", "flagship", "--device", "cpu"])
    assert (a.steps, a.eval_episodes, a.eval_holdout, a.holdout_bank,
            a.holdout_episodes) == (100_000, 4096, False, 2048, 8192)
    for k in ("lines", "moves", "num_envs", "bank", "log_every", "checkpoint_every",
              "model_flags", "flags", "seed", "actor_fusion"):
        assert getattr(a, k) == getattr(full, k), k
    cmd = lc.train_command(a, a.steps, "CKPT", "HOLD")
    flags = " ".join(cmd[cmd.index("train") + 1:])
    assert "--steps 100000" in flags and "--eval-episodes 4096" in flags
    assert "--eval-holdout" not in flags  # JAX measured it afterwards
    assert " ".join(lc.eval_command(a, "CKPT", "HOLD")).endswith(
        "--eval-holdout --holdout-bank 2048 --episodes 8192 --seed 0 --device cpu "
        "--save-holdout HOLD")
    assert [int(x) for x in a.band_steps.split(",")] == [25_000, 50_000, 75_000, 100_000]
    ref = lc.read_reference(a.reference, a.num_envs, a.reference_eval)
    whole = lc.read_reference(full.reference, full.num_envs)
    key = lambda rows: [(r["step"], r["win_rate"], r["loss"]) for r in rows]  # noqa: E731
    assert len(ref["history"]) == 100
    assert key(ref["history"]) == key(whole["history"][:100])
    rows = {r["step"]: r["win_rate"] for r in ref["history"]}
    assert [rows[s] for s in (25_000, 50_000, 75_000, 100_000)] == [0.100, 0.396, 0.520, 0.579]
    final = ref["final_eval"]
    assert ref["final_greedy_win_rate"] == final["train_bank"]["win_rate"] == 0.831787109375
    assert final["train_bank"]["episodes"] == 4096
    assert [final[k]["win_rate"] for k in ("holdout", "holdout_carve", "holdout_forward")] == [
        JAX_100K["holdout"], JAX_100K["carve"], JAX_100K["forward"]]
    assert final["holdout"]["families"] == {"carve": 1024, "forward": 1024}
    assert all(final[k]["episodes"] == 8192
               for k in ("holdout", "holdout_carve", "holdout_forward"))
    assert ref["eval_bank"]["win_rate"] == 0.8436279296875
    # the log alone holds no held-out reading
    assert sorted(lc.read_reference(a.reference, a.num_envs)["final_eval"]) == ["train_bank"]


@pytest.mark.parametrize("row,side", [(None, 0)] + [
    (row, side) for row in JAX_100K for side in (1, -1)])
def test_flagship100k_held_out_block(row, side):
    """JAX's 100k held-out block bands the port's reading row by row: every
    row 1e-4 inside its band, or the named row 1e-4 outside it, above or
    below. The eval JSON's own training-bank win rate stands beside the
    port's with no band; the forward family's split by provenance passes
    through."""
    import learning_check as lc

    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu"])
    ref = lc.read_reference(a.reference, a.num_envs, a.reference_eval)
    port = {k: JAX_100K[k] + (BANDS[k] + 1e-4 if k == row else BANDS[k] - 1e-4) * (side or 1)
            for k in JAX_100K}
    reading = _reading(100_000, port["holdout"], port["carve"], port["forward"],
                       port["train_bank"])
    reading["forward_by_provenance"] = {"host_dfs": {"rows": 700, "win_rate": 0.8},
                                        "device_beam": {"rows": 324, "win_rate": 0.6}}
    curve = [{"step": s, "env_steps": 2048 * s, "win_rate": 0.5, "loss": 0.1,
              "sps": 6e4} for s in range(1000, 100_001, 1000)]
    block = lc.compare(curve, ref, 0.05, [], None, reading)["held_out"]
    assert {k: (r["port"], r["jax"], r["band"]) for k, r in block["rows"].items()} == {
        k: (port[k], JAX_100K[k], BANDS[k]) for k in JAX_100K}
    assert {k: r["inside"] for k, r in block["rows"].items()} == {
        k: k != row for k in JAX_100K}
    assert block["inside"] == (row is None)
    assert block["port_step"] == block["jax_step"] == 100_000
    assert block["eval_bank"] == {"port": port["train_bank"], "jax": 0.8436279296875,
                                  "band": None}
    assert block["forward_by_provenance"] == reading["forward_by_provenance"]


def test_learning_check_against_an_earlier_record(tmp_path, capsys):
    """``--summarize-only --against``: the run as OUT holds it beside an
    earlier record, the rows equal up to the first step where they part,
    and each run's mean gap to JAX per 25k-step window."""
    import learning_check as lc

    jax = {r["step"]: r["win_rate"] for r in lc.read_reference(
        str(lc.FLAGSHIP100K_REFERENCE), 2048)["history"]}
    mine = {s: round(w + (0.01 if s <= 50_000 else -0.02), 3) for s, w in jax.items()}
    row = "[{:>7}] env_steps=1.00e+00 win_rate={:.3f} loss=0.1 eps=0.05 sps=6.0e+04\n"
    (tmp_path / "segment_0.log").write_text("".join(row.format(s, w)
                                                    for s, w in mine.items()))
    (tmp_path / "segment_0.json").write_text(json.dumps(
        {"first_step": 0, "stop_step": 100_000, "wall_s": 3400.0,
         "card": "a card", "greedy": 0.83}))
    earlier = [{"step": s, "port_win_rate": mine[s] if s <= 50_000 else round(w + 0.03, 3),
                "port_loss": 0.1, "jax_win_rate": w}
               for s, w in jax.items() if s <= 60_000]
    (tmp_path / "earlier.json").write_text(json.dumps({"rows": earlier}))
    rc = lc.main(["--recipe", "flagship100k", "--device", "cpu", "--out", str(tmp_path),
                  "--summarize-only", "--against", str(tmp_path / "earlier.json")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res == json.loads((tmp_path / "result.json").read_text())
    got = res["against"]
    assert (got["rows_compared"], got["rows_equal"], got["equal_through"],
            got["first_apart"], got["window"]) == (60, 50, 50_000, 51_000, 25_000)
    assert {int(k): v for k, v in got["gap"]["this"].items()} == pytest.approx(
        {25_000: 0.01, 50_000: 0.01, 75_000: -0.02, 100_000: -0.02})
    assert {int(k): v for k, v in got["gap"]["earlier"].items()} == pytest.approx(
        {25_000: 0.01, 50_000: 0.01, 75_000: 0.03})
    assert res["last_step"] == 100_000 and res["band"]["training"][1]["inside"]
    assert res["card"] == "a card" and res["held_out"]["port_step"] is None


def test_learning_check_overlaps_of_a_continued_segment(tmp_path):
    """A segment that went on from a checkpoint older than the earlier
    segment's last row logs those steps again: ``overlaps`` names them and
    says whether each row is the same; the merged curve takes the later
    segment's rows."""
    import learning_check as lc

    row = "[{:>7}] env_steps=1.00e+00 win_rate={} loss={} eps=0.05 sps=1.0e+03\n"
    (tmp_path / "segment_0.log").write_text("".join(
        row.format(s, w, 0.1) for s, w in ((10, 0.1), (20, 0.2), (30, 0.3), (40, 0.4))))
    (tmp_path / "segment_20.log").write_text("".join(
        row.format(s, w, 0.1) for s, w in ((10, 0.3), (20, 0.45), (30, 0.5))))
    assert lc.overlaps(tmp_path) == [{"segment": 20, "steps": [30, 40],
                                      "equal": [True, False]}]
    curve = lc.read_curve(tmp_path, num_envs=4)
    assert [(r["step"], r["win_rate"]) for r in curve] == [
        (10, 0.1), (20, 0.2), (30, 0.3), (40, 0.45), (50, 0.5)]
    (tmp_path / "segment_20.log").unlink()
    assert lc.overlaps(tmp_path) == []


def test_learning_check_passes_continue_run(capsys):
    """``--continue-run`` reaches ``cli train`` with the ``--resume``
    checkpoint (``tests/test_torch_continue.py`` holds the continued run
    against one unbroken call), and ``cli train`` refuses it without one."""
    import learning_check as lc

    from tetris_piclim_tpu_torch import cli

    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu", "--resume", "CKPT",
                  "--continue-run"])
    assert lc.train_command(a, 20_000, "OUT")[-3:] == ["--resume", "CKPT",
                                                       "--continue-run"]
    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu", "--resume", "CKPT"])
    assert "--continue-run" not in lc.train_command(a, 20_000, "OUT")
    assert cli.main(["train", "--device", "cpu", "--continue-run"]) == 2
    assert "--resume" in capsys.readouterr().err


def _tiny_run(tmp_path, forward_fraction: float = 0.5):
    """A checkpoint of the toy conv learner with its 16-row training bank,
    and a 16-row held-out bank of forward rows over carves (saved as
    ``cli eval --save-holdout`` saves it)."""
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.utils.checkpoint import save_bank
    from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=1, M=8), num_envs=8, bank_capacity=16,
                      replay_capacity=64, seed=0)
    bank = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device(
        forward_fraction=0.25)
    net = ConvQNetwork(dueling=True, joint=True, generator=torch.Generator().manual_seed(3))
    trainer = DQNTrainer(cfg, bank=bank, net=net, device="cpu")
    ckpt = str(tmp_path / "ckpt" / "final")
    trainer.save_checkpoint(ckpt)
    save_bank(ckpt, trainer.bank)
    hold = ConfigBank(1, 8, capacity=16, seed=9, device="cpu").fill_device(
        forward_fraction=forward_fraction)
    save_bank(str(tmp_path / "holdout"), hold)
    return trainer, ckpt, hold


def test_forward_by_provenance_splits_the_forward_family(tmp_path):
    """The forward win rate on the host DFS rows and on the device beam
    rows apart (the first ``host_forward`` forward rows, then the next
    ``device_forward``), with ``cli eval``'s draws: each part equals
    ``DQNTrainer.evaluate`` on those rows, and the whole family again
    equals the evaluation on ``subset(FAMILY_FORWARD)``."""
    import learning_check as lc

    from tetris_piclim_tpu_torch.gen.bank import FAMILY_FORWARD, ConfigBank

    trainer, ckpt, hold = _tiny_run(tmp_path)
    n_fwd = hold.family_counts["forward"]
    assert n_fwd >= 4
    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu", "-L", "1", "-M", "8",
                  "--bank", "16"])
    ev = {"holdout": {"episodes": 64, "build": {"host_forward": 3,
                                                "device_forward": n_fwd - 3}}}
    split = lc.forward_by_provenance(a, ckpt, str(tmp_path / "holdout"), ev)
    cols, pieces = hold.rows
    want = [trainer.evaluate(64, bank=ConfigBank.from_rows(
        1, 8, cols[lo:hi], pieces[lo:hi], hold.family[lo:hi]))["win_rate"]
        for lo, hi in ((0, 3), (3, n_fwd))]
    assert split["host_dfs"] == {"rows": 3, "episodes": 64, "win_rate": want[0]}
    assert split["device_beam"] == {"rows": n_fwd - 3, "episodes": 64, "win_rate": want[1]}
    assert split["whole_again"] == trainer.evaluate(
        64, bank=hold.subset(FAMILY_FORWARD))["win_rate"]
    # no device rows: that part has no win rate
    ev["holdout"]["build"] = {"host_forward": n_fwd, "device_forward": 0}
    split = lc.forward_by_provenance(a, ckpt, str(tmp_path / "holdout"), ev)
    assert split["device_beam"] == {"rows": 0, "episodes": 64, "win_rate": None}
    # counts that reach past the forward rows are refused
    ev["holdout"]["build"] = {"host_forward": n_fwd, "device_forward": 1}
    with pytest.raises(RuntimeError):
        lc.forward_by_provenance(a, ckpt, str(tmp_path / "holdout"), ev)


def test_on_jax_rows_plays_every_jax_row_once(tmp_path, monkeypatch):
    """The checkpoint's policy on JAX's own held-out rows of the task: each
    part's rows won equal the policy played once per row, and the forward
    family for h host rows is the first h host rows with the first n - h
    beam rows; a task with no such file gives None."""
    import numpy as np

    import holdout_draws as hd
    import learning_check as lc

    from tetris_piclim_tpu_torch.ops.bitboard import unpack_board

    trainer, ckpt, hold = _tiny_run(tmp_path)
    boards = unpack_board(hold.cols).numpy()
    pieces = hold.pieces.numpy()
    path = tmp_path / "jax_rows.npz"
    np.savez_compressed(path, beam_boards=boards[:8], beam_pieces=pieces[:8],
                        carve_boards=boards[8:], carve_pieces=pieces[8:],
                        host_boards=boards[3:8], host_pieces=pieces[3:8])
    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu", "-L", "1", "-M", "8",
                  "--bank", "16"])
    assert lc.on_jax_rows(a, ckpt) is None
    monkeypatch.setattr(lc, "JAX_ROWS", {(1, 8): path})
    monkeypatch.setattr(lc, "JAX_HOST_ROWS", (0, 3, 9))
    got = lc.on_jax_rows(a, ckpt)
    won = hd.play(trainer.state.net, boards, pieces, 1, 8, "cpu")
    assert got["beam"] == {"rows": 8, "won": int(won[:8].sum()),
                           "win_fraction": float(won[:8].mean())}
    assert got["carve"]["won"] == int(won[8:].sum())
    assert got["host"]["won"] == int(won[3:8].sum())
    want = []
    for h in (0, 3, 5):  # 9 is cut to the 5 host rows there are
        fwd = int(won[3:3 + h].sum()) + int(won[:8 - h].sum())
        want.append({"host_rows": h, "forward_win_fraction": fwd / 8,
                     "holdout_win_fraction": (fwd + int(won[8:].sum())) / 16})
    assert got["by_host_rows"] == want
    reading = _reading(10, 0.5, 0.5, 0.5, 0.5)
    reading["on_jax_rows"] = got
    ref = lc.read_reference(a.reference, a.num_envs, a.reference_eval)
    assert lc.held_out_block(reading, ref)["on_jax_rows"] == got


def test_learning_check_flagship100k_small(tmp_path):
    """``--recipe flagship100k`` at a toy size on the CPU: the run ends
    with the evaluation on the training bank and no held-out one, and the
    result names JAX's run and its held-out reading."""
    out = _tool(["tools/learning_check.py", "--recipe", "flagship100k", "--device", "cpu",
                 "-L", "1", "-M", "8", "--num-envs", "8", "--bank", "16",
                 "--steps", "10", "--log-every", "10", "--checkpoint-every", "10",
                 "--eval-episodes", "32", "--out", str(tmp_path)], timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r["step"] for r in res["rows"]] == [10] and res["held_out_readings"] == []
    assert res["reference"] == "results/train_r3_L5df.log"
    assert res["reference_eval"] == "results/eval_r3_L5df.json"
    assert res["band"]["greedy"]["jax"] == JAX_100K["train_bank"]
    assert res["held_out"]["port_step"] is None and res["holdout_bank"] == 2048
    assert (tmp_path / "ckpt" / "final" / "bank.pt").exists()


def test_learning_check_flagship100k_holdout_only_small(tmp_path):
    """``--recipe flagship100k --holdout-only`` end to end on a toy
    checkpoint: ``cli eval`` reads it, and the result's ``held_out`` block
    holds JAX's 100k values, the forward family split by provenance (the
    whole family again equal to the reading's) and the eval JSON's
    training-bank win rate unbanded."""
    _tiny_run(tmp_path)
    out = _tool(["tools/learning_check.py", "--recipe", "flagship100k", "--device", "cpu",
                 "-L", "1", "-M", "8", "--bank", "16", "--holdout-bank", "16",
                 "--holdout-episodes", "48", "--holdout-only",
                 "--resume", str(tmp_path / "ckpt" / "final"), "--out", str(tmp_path)],
                timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    block = res["held_out"]
    assert block["port_step"] == 0 and block["episodes"] == 48
    assert {k: r["jax"] for k, r in block["rows"].items()} == JAX_100K
    assert all(isinstance(r["inside"], bool) for r in block["rows"].values())
    assert block["eval_bank"]["jax"] == 0.8436279296875 and block["eval_bank"]["band"] is None
    assert block["eval_bank"]["port"] == block["rows"]["train_bank"]["port"]
    split, build = block["forward_by_provenance"], block["build"]
    assert (split["host_dfs"]["rows"], split["device_beam"]["rows"]) == (
        build["host_forward"], build["device_forward"])
    assert split["whole_again"] == block["rows"]["forward"]["port"]
    assert (tmp_path / "holdout_0.json").exists()


def test_optimizer_check_arms_agree_word_for_word():
    """``tools/optimizer_check.py``'s two arms on a toy conv learner from
    one seed: the optimizer and Polyak steps as loops over the tensors and
    the package's foreach versions end every chunk with the same weights,
    target weights and moments word for word; the loops are patched in for
    one chunk only; a changed word is reported."""
    import optimizer_check as oc

    from tetris_piclim_tpu_torch.dqn import agent
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

    def toy():
        cfg = TrainConfig(env=EnvConfig(L=1, M=8), num_envs=16, bank_capacity=16,
                          replay_capacity=1024, warmup_steps=32, updates_per_step=4,
                          seed=0)
        bank = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
        net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                           generator=torch.Generator().manual_seed(0))
        return DQNTrainer(cfg, bank=bank, net=net, device="cpu")

    loop, foreach = toy(), toy()
    for _ in range(2):
        oc.run_chunk(loop, "loop", 8)
        assert agent.AmsgradW.step is oc.ARMS["foreach"][0]
        assert agent.polyak is oc.ARMS["foreach"][1]
        oc.run_chunk(foreach, "foreach", 8)
        assert oc.apart(loop, foreach) == []
    assert loop.state.opt.count == foreach.state.opt.count >= 4 * 8
    assert len(oc.state_words(loop)) == 60
    with torch.no_grad():
        foreach.state.opt.nu_max[4].view(-1)[0] += 1.0
    assert oc.apart(loop, foreach) == ["nu_max.4"]


def test_holdout_rows_plays_every_row_once(tmp_path):
    """``tools/holdout_rows.py`` on a toy policy file: each held-out row
    played once, the rows won per family and per provenance part equal to
    a greedy rollout of the same net, and the parts adding up."""
    import holdout_rows

    from tetris_piclim_tpu_torch.dqn import agent
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.ops import bitboard as bb
    from tetris_piclim_tpu_torch.utils.checkpoint import save_policy_npz

    net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                       generator=torch.Generator().manual_seed(5)).eval()
    train = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
    hold = ConfigBank(1, 8, capacity=32, seed=7, device="cpu").fill_device(
        forward_fraction=0.5)
    n_fwd = hold.family_counts["forward"]
    ev = {"holdout": {"win_rate": 0.5, "build": {"host_forward": 5,
                                                 "device_forward": n_fwd - 5}},
          "holdout_carve": {"win_rate": 0.6}, "holdout_forward": {"win_rate": 0.4}}
    meta = {"L": 1, "M": 8, "step": 40,
            "net": {"model": "conv", "channels": [4, 8], "dueling": True, "joint": True},
            "eval": ev, "forward_by_provenance": None}
    path = tmp_path / "toy_policy.npz"
    save_policy_npz(str(path), net.state_dict(), {"train": train, "holdout": hold}, meta)
    got = holdout_rows.rows_won(path, torch.device("cpu"))
    with torch.no_grad():
        env = bb.make_state_batch(*hold.rows, 1, 8)
        won = agent.greedy_rollout(net, env, 9, bb).status == 1
    assert got["all"] == {"rows": 32, "won": int(won.sum()),
                          "win_fraction": int(won.sum()) / 32}
    assert got["forward"]["won"] == int(won[:n_fwd].sum())
    assert got["carve"]["won"] == int(won[n_fwd:].sum())
    assert (got["forward_host_dfs"]["rows"], got["forward_device_beam"]["rows"]) == (
        5, n_fwd - 5)
    assert got["forward_host_dfs"]["won"] + got["forward_device_beam"]["won"] == \
        got["forward"]["won"]
    assert got["recorded_8192_episodes"]["forward"] == 0.4 and got["step"] == 40


def test_keep_newest_checkpoint(tmp_path):
    import learning_check

    for n in (10, 20, 9):
        (tmp_path / f"step_{n}").mkdir()
    learning_check.keep_newest_checkpoint(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_20"]
    (tmp_path / "final").mkdir()
    learning_check.keep_newest_checkpoint(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["final"]


# a JAX package in name only: records the TrainConfig fields it is given
_STUB = {
    "__init__.py": "",
    "dqn/__init__.py": "",
    "gen/__init__.py": "",
    "utils/__init__.py": "",
    "utils/config.py": (
        "class EnvConfig:\n"
        "    def __init__(self, L, M):\n        self.L, self.M = L, M\n"
        "class TrainConfig:\n"
        "    def __init__(self, *, env, num_envs, bank_capacity, replay_capacity,\n"
        "                 total_steps, log_every, seed):\n"
        "        self.num_envs, self.steps, self.log_every = num_envs, total_steps, log_every\n"),
    "gen/bank.py": (
        "class ConfigBank:\n"
        "    def __init__(self, L, M, capacity, seed):\n        pass\n"
        "    def fill_device(self):\n        return self\n"),
    "dqn/train.py": (
        "class DQNTrainer:\n"
        "    def __init__(self, cfg, bank):\n        self.cfg = cfg\n"
        "    def train(self, log_fn):\n"
        "        c = self.cfg\n"
        "        return {'history': [{'env_steps': s * c.num_envs, 'win_rate': 0.25,\n"
        "                             'loss': 0.5} for s in range(c.log_every, c.steps + 1,\n"
        "                                                        c.log_every)]}\n"
        "    def evaluate(self, n_episodes):\n        return {'win_rate': 0.75}\n"),
}


def test_learning_probe_jax_root(tmp_path):
    """``--jax-root DIR`` runs the package found in DIR, passing only the
    TrainConfig fields an old version has, and names DIR and its commit."""
    pkg = tmp_path / "tetris_piclim_tpu"
    for name, text in _STUB.items():
        (pkg / name).parent.mkdir(parents=True, exist_ok=True)
        (pkg / name).write_text(text)
    (tmp_path / "COMMIT").write_text("b5c6e5a259db87eb62a2de0188d003336b547d42\n")
    args = ["tools/learning_probe.py", "--device", "cpu", "--num-envs", "8",
            "--steps", "20", "--log-every", "10", "--seeds", "3"]
    out = _tool([*args, "--package", "jax", "--jax-root", str(tmp_path)], timeout=60)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax_root"] == str(tmp_path)
    assert res["jax_commit"] == "b5c6e5a259db87eb62a2de0188d003336b547d42"
    assert res["env_steps"] == [80, 160] and res["win_rate"] == [0.25, 0.25]
    assert res["greedy_win_rate"] == 0.75 and res["seed"] == 3
    out = _tool([*args, "--jax-root", str(tmp_path)], timeout=60)
    assert out.returncode != 0 and "--jax-root is for --package jax" in out.stderr
    (tmp_path / "COMMIT").unlink()
    (pkg / "__init__.py").unlink()  # not a package: the checkout's is found
    out = _tool([*args, "--package", "jax", "--jax-root", str(tmp_path)], timeout=60)
    assert out.returncode != 0 and "tetris_piclim_tpu came from" in out.stderr


def test_learning_probe_summarize(tmp_path):
    """``--summarize``: runs that differ only in their seed become one set,
    each chunk as mean, sample sd and lowest."""
    base = {"tool": "learning_probe", "package": "jax", "matmul": "f32",
            "jax_root": None, "jax_commit": None, "device": "cpu", "card": None,
            "num_envs": 8, "bank": 8, "replay": 64, "steps": 20,
            "env_steps": [80, 160], "loss": [0.1, 0.1], "wall_s": 1.0}
    runs = [dict(base, seed=s, win_rate=w, greedy_win_rate=g)
            for s, w, g in ((0, [0.1, 0.3], 0.5), (1, [0.3, 0.5], 0.7))]
    runs.append(dict(base, seed=0, package="torch", win_rate=[0.2, 0.2],
                     greedy_win_rate=0.1))
    path = tmp_path / "runs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in runs))
    out = _tool(["tools/learning_probe.py", "--summarize", str(path)], timeout=60)
    assert out.returncode == 0, out.stderr
    jax_set, torch_set = [json.loads(line) for line in out.stdout.splitlines()]
    assert jax_set["seeds"] == [0, 1] and torch_set["seeds"] == [0]
    assert jax_set["win_rate_mean"] == pytest.approx([0.2, 0.4])
    assert jax_set["win_rate_sd"] == pytest.approx([0.1 * 2 ** 0.5] * 2)
    assert jax_set["win_rate_min"] == pytest.approx([0.1, 0.3])
    assert jax_set["greedy_mean"] == pytest.approx(0.6)
    assert torch_set["win_rate_sd"] == [0.0, 0.0] and torch_set["greedy_sd"] == 0.0


@pytest.mark.parametrize("matmul", ["f32", "bf16", "bf16-fwd-bwd"])
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


@pytest.mark.parametrize("shape", [(5, 7), (2, 3, 7)])
def test_bf16_fwd_bwd_linear_gradients(shape):
    """``Bf16Linear``: the forward product and both backward products are
    float32 products of bfloat16-rounded operands (the bias stays float32),
    checked against the same products in float64 on the rounded operands,
    and against plain float32, which they must differ from."""
    import learning_probe

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen, requires_grad=True)
    w = torch.randn(3, 7, generator=gen, requires_grad=True)
    b = torch.randn(3, generator=gen, requires_grad=True)
    g = torch.randn(*shape[:-1], 3, generator=gen)
    out = learning_probe.Bf16Linear.apply(x, w, b)
    out.backward(g)
    r = lambda t: t.detach().bfloat16().double()  # noqa: E731
    want_out = r(x) @ r(w).T + b.detach().double()
    want_gx = r(g) @ r(w)
    want_gw = r(g).reshape(-1, 3).T @ r(x).reshape(-1, 7)
    want_gb = g.double().reshape(-1, 3).sum(0)
    for got, want in ((out, want_out), (x.grad, want_gx), (w.grad, want_gw),
                      (b.grad, want_gb)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    # plain float32 autograd on the unrounded operands gives other gradients
    x32, w32 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    torch.nn.functional.linear(x32, w32, b.detach()).backward(g)
    assert not torch.allclose(x.grad, x32.grad, rtol=0, atol=1e-6)
    assert not torch.allclose(w.grad, w32.grad, rtol=0, atol=1e-6)

    lin = torch.nn.Linear(7, 3)
    forward = torch.nn.Linear.forward
    try:
        learning_probe.round_linear_fwd_bwd_to_bf16()
        y = lin(x.detach())
    finally:
        torch.nn.Linear.forward = forward
    torch.testing.assert_close(y, learning_probe.Bf16Linear.apply(
        x.detach(), lin.weight, lin.bias), rtol=0, atol=0)


def _toy_policy_file(path, net_seed: int, rows_seed: int) -> None:
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.utils.checkpoint import save_policy_npz

    net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                       generator=torch.Generator().manual_seed(net_seed))
    train = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
    hold = ConfigBank(1, 8, capacity=32, seed=rows_seed, device="cpu").fill_device(
        forward_fraction=0.5)
    n_fwd = hold.family_counts["forward"]
    ev = {"holdout": {"win_rate": 0.5, "build": {"host_forward": 3,
                                                 "device_forward": n_fwd - 3}},
          "holdout_carve": {"win_rate": 0.5}, "holdout_forward": {"win_rate": 0.5}}
    meta = {"L": 1, "M": 8, "step": 40,
            "net": {"model": "conv", "channels": [4, 8], "dueling": True, "joint": True},
            "eval": ev, "forward_by_provenance": None}
    save_policy_npz(str(path), net.state_dict(), {"train": train, "holdout": hold}, meta)


def test_holdout_rows_cross_play(tmp_path, monkeypatch, capsys):
    """``tools/holdout_rows.py --cross``: every policy on every file's
    held-out rows and on JAX's rows of the task, each row once; the
    ``seed_gap`` lines are each policy's win fractions less the first's on
    the same rows, and the rows only one of the two won."""
    import numpy as np

    import holdout_draws as hd
    import holdout_rows
    import learning_check as lc

    from tetris_piclim_tpu_torch.ops.bitboard import unpack_board
    from tetris_piclim_tpu_torch.utils.checkpoint import read_policy_npz

    paths = [tmp_path / "p0.npz", tmp_path / "p1.npz"]
    _toy_policy_file(paths[0], 5, 7)
    _toy_policy_file(paths[1], 6, 8)
    pols = [read_policy_npz(str(p)) for p in paths]
    hold = pols[1]["banks"]["holdout"]
    boards, pieces = unpack_board(hold.cols).numpy(), hold.pieces.numpy()
    jax_rows = tmp_path / "jax_rows.npz"
    np.savez_compressed(jax_rows, beam_boards=boards[:8], beam_pieces=pieces[:8],
                        carve_boards=boards[8:], carve_pieces=pieces[8:],
                        host_boards=boards[20:24], host_pieces=pieces[20:24])
    monkeypatch.setattr(lc, "JAX_ROWS", {(1, 8): jax_rows})
    monkeypatch.setattr(lc, "JAX_HOST_ROWS", (0, 2))
    assert holdout_rows.main([str(p) for p in paths] + ["--cross"]) == 0
    out = [json.loads(t) for t in capsys.readouterr().out.splitlines()]
    gaps = [ln["seed_gap"] for ln in out if "seed_gap" in ln]
    plays = [ln for ln in out if "seed_gap" not in ln]
    assert len(plays) == 6 and len(gaps) == 3  # 2 policies x (2 files + JAX's rows)
    nets = [holdout_rows.policy_net(p, torch.device("cpu")) for p in pols]
    # policy 0 on file 1's rows: each row once
    won = hd.play(nets[0], boards, pieces, 1, 8, "cpu")
    cross = next(ln for ln in plays if ln["policy"].endswith("p0.npz")
                 and ln["rows_of"].endswith("p1.npz"))
    assert cross["all"] == {"rows": 32, "won": int(won.sum()),
                            "win_fraction": float(won.mean())}
    won1 = hd.play(nets[1], boards, pieces, 1, 8, "cpu")
    on1 = next(g for g in gaps if g["rows_of"].endswith("p1.npz"))
    assert on1["base"].endswith("p0.npz")
    g = on1["policies"][next(iter(on1["policies"]))]["all"]
    assert g["gap"]["mean"] == pytest.approx(won1.mean() - won.mean())
    assert (g["rows_only_this"], g["rows_only_base"]) == (
        int((won1 & ~won).sum()), int((~won1 & won).sum()))
    # JAX's rows: the forward family of h host rows is host[:h] + beam[:8 - h]
    on_jax = next(g for g in gaps if g["rows_of"].endswith("jax_rows.npz"))
    fwd = on_jax["policies"][next(iter(on_jax["policies"]))]["forward_h2"]
    f0 = np.concatenate([won[20:22], won[:6]])
    f1 = np.concatenate([won1[20:22], won1[:6]])
    assert fwd["rows"] == 8 and fwd["gap"]["mean"] == pytest.approx(f1.mean() - f0.mean())


def test_ckpt_pack_round_trip(tmp_path, capsys):
    """``tools/ckpt_pack.py``: a trainer checkpoint packed and unpacked
    loads back word for word (weights, moments, ring, envs, generators,
    counters, bank rows), and is smaller than the directory."""
    import ckpt_pack

    _, ckpt, _ = _tiny_run(tmp_path)
    packed = tmp_path / "ckpt.xz"
    assert ckpt_pack.main(["pack", ckpt, str(packed)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["files"] == ["bank.pt", "state.pt"]
    assert res["packed_bytes"] == packed.stat().st_size < res["bytes"]
    back = tmp_path / "back"
    assert ckpt_pack.main(["unpack", str(packed), str(back)]) == 0
    for name in ("state.pt", "bank.pt"):
        a = torch.load(Path(ckpt) / name, weights_only=True)
        b = torch.load(back / name, weights_only=True)
        assert ckpt_pack.same(a, b)
    a = torch.load(Path(ckpt) / "state.pt", weights_only=True)
    assert a["global_step"] == 0 and a["replay"] and a["opt"] and a["gen"].dtype == torch.uint8
    # the check sees a flipped bit, a dtype and a container type
    w = next(iter(a["net"].values()))
    flipped = w.clone()
    flipped.view(-1).view(torch.int32)[0] ^= 1
    assert not ckpt_pack.same(w, flipped)
    assert not ckpt_pack.same(w, w.double())
    assert not ckpt_pack.same([1, 2], (1, 2))


def test_seed_pilot_verdict(tmp_path, monkeypatch, capsys):
    """``tools/seed_pilot.py`` on stub runs: each run's rate together over
    seed 1's rate alone, seed 1's rows both ways, and every checkpoint
    deleted."""
    import seed_pilot

    def command(seed, out, extra):
        code = ("import json, os, sys, torch; out = sys.argv[1]; "
                "os.makedirs(out + '/ckpt/final'); "
                "torch.save({'w': torch.ones(64)}, out + '/ckpt/final/state.pt'); "
                "rate = float(sys.argv[2]); "
                "json.dump({'env_steps_per_s': rate, 'wall_s': 1.0, 'card': None, "
                "'rows': [{'step': 1000, 'port_win_rate': 0.0 if sys.argv[3] == '1' "
                "else 0.5, 'port_loss': 0.1, 'port_sps': rate}]}, "
                "open(out + '/result.json', 'w'))")
        together = out.parent.name == "together"
        rate = {1: 90.0, 2: 70.0}[seed] if together else 100.0
        return [sys.executable, "-c", code, str(out), str(rate), str(seed)]

    monkeypatch.setattr(seed_pilot, "command", command)
    assert seed_pilot.main(["--out", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["seeds"] == [1, 2] and res["steps"] == 3000
    assert res["share_of_alone"] == {"1": 0.9, "2": 0.7}
    assert not res["share_ok"] and res["rows_equal"] and res["steps_compared"] == [1000]
    assert res["together"]["runs"]["2"]["sps_by_chunk"] == [70.0]
    assert not list(tmp_path.glob("*/s*/ckpt"))
    assert json.loads((tmp_path / "pilot.json").read_text()) == res
    row = [(1000, 0.0, 0.1)]
    ok = seed_pilot.verdict({"runs": {1: {"env_steps_per_s": 80.0, "rows": row}}},
                            {"runs": {1: {"env_steps_per_s": 100.0, "rows": row}}}, 1)
    assert ok["share_ok"] and ok["rows_equal"]  # 0.8 of the rate alone is enough


def test_seed_spread_leave_one_out(tmp_path, capsys):
    """``tools/seed_spread.py``: per row, the seeds' mean and sd with the sd's
    95% chi-square interval and JAX's z, and the same with each seed left
    out, with that seed's z against the others; a run that stops early
    counts only in the rows it reached."""
    import numpy as np
    import seed_spread
    from scipy import stats

    def result(seed, train, held):
        steps = (25000, 50000)
        return {"seed": seed, "band": {"training": [
                    {"step": st, "port": v, "jax": 0.4} for st, v in zip(steps, train)]},
                "held_out": None if held is None else {"rows": {
                    "holdout": {"port": held, "jax": 0.8},
                    "carve": {"port": None, "jax": 0.84}}}}

    runs = [result(0, [0.1, 0.40], 0.78), result(1, [0.2, 0.42], 0.76),
            result(2, [0.0, 0.22], 0.74), result(3, [0.15, None], None)]
    files = []
    for r in runs:
        files.append(tmp_path / f"s{r['seed']}.json")
        files[-1].write_text(json.dumps(r))
    out = tmp_path / "spread.json"
    assert seed_spread.main([str(f) for f in files] + ["--out", str(out)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == res
    rows = res["rows"]
    assert set(rows) == {"training_25k", "training_50k", "holdout"}
    assert rows["training_25k"]["seeds"] == {"0": 0.1, "1": 0.2, "2": 0.0, "3": 0.15}
    x = np.array([0.40, 0.42, 0.22])
    a = rows["training_50k"]["all"]
    assert a["n"] == 3 and a["mean"] == pytest.approx(x.mean())
    assert a["sd"] == pytest.approx(x.std(ddof=1))
    assert a["sd_95"] == pytest.approx([x.std(ddof=1) * np.sqrt(2 / stats.chi2.ppf(q, 2))
                                        for q in (0.975, 0.025)])
    assert a["jax_z"] == pytest.approx((0.4 - x.mean()) / x.std(ddof=1))
    loo = rows["training_50k"]["leave_one_out"]["2"]
    assert loo["n"] == 2 and loo["mean"] == pytest.approx(0.41)
    assert loo["z_of_left_out"] == pytest.approx((0.22 - 0.41) / np.std([0.4, 0.42], ddof=1))
    assert rows["holdout"]["jax"] == 0.8 and rows["holdout"]["all"]["n"] == 3
    # two results of one seed are refused
    with pytest.raises(SystemExit):
        seed_spread.main([str(files[0]), str(files[0]), "--out", str(out)])


def test_flagship_policy_carries_the_run_seed(tmp_path, capsys):
    """``tools/flagship_policy.py`` on a toy run: the newest reading's rows
    and the checkpoint's net in one file, with the run's training seed
    (from ``OUT/result.json``, 0 where the run has none), which ``cli
    eval``'s draws follow."""
    import flagship_policy

    from tetris_piclim_tpu_torch.utils.checkpoint import read_policy_npz, save_bank

    trainer, ckpt, _ = _tiny_run(tmp_path)
    hold = trainer.bank.__class__(1, 8, capacity=16, seed=11, device="cpu").fill_device()
    save_bank(str(tmp_path / "holdout_0"), hold)
    ev = {"holdout": {"win_rate": 0.5, "families": hold.family_counts,
                      "build": {"host_forward": 0, "device_forward": 0}},
          "holdout_carve": {"win_rate": 0.5}, "holdout_forward": {"win_rate": 0.5}}
    (tmp_path / "holdout_0.json").write_text(json.dumps(
        {"step": 0, "source": "eval", "card": None, "eval": ev}))
    for seed, want in ((None, 0), (3, 3)):
        if seed is not None:
            (tmp_path / "result.json").write_text(json.dumps({"seed": seed}))
        out = tmp_path / f"policy_{want}.npz"
        assert flagship_policy.main([str(tmp_path), "--out", str(out)]) == 0
        meta = read_policy_npz(str(out))["meta"]
        assert meta["seed"] == want and meta["step"] == 0
        assert json.loads(capsys.readouterr().out)["holdout_rows"] == 16
