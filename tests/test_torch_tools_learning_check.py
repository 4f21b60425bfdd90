"""The port's tools run end to end at tiny sizes on the CPU:
``tools/learning_check.py`` (the learning curve against the JAX run's, here
against a stub curve; the flagship recipe's reading of its committed JAX
log, rows and ``final_eval``; the held-out block and its bands; flags that
do not read the total steps; the flagship recipe and ``--holdout-only`` at a
toy size). The numbers are CPU numbers and mean nothing; the shapes of the
results are checked."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
from torch_port_helpers import held_out_reading, run_tool

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


def test_learning_check_small(tmp_path):
    """The learning check at a tiny size on the CPU against a stub JAX curve:
    the JSON line's keys, and the band read at the rows of the band steps."""
    ref = {"num_envs": 32, "final_greedy_win_rate": 0.5,
           "history": [{"step": s, "win_rate": w}
                       for s, w in ((100, 0.02), (200, 0.9), (300, 0.04))]}
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    out = run_tool(["tools/learning_check.py", "--device", "cpu", "-L", "1", "-M", "8",
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


@pytest.mark.parametrize("reading,inside", [
    (held_out_reading(500_000, 0.92, 0.95, 0.89, 0.93, key="train_bank"),
     {"holdout": True, "carve": True, "forward": True, "train_bank": True}),
    (held_out_reading(150_000, 0.90, 0.918, 0.851, 0.91),
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
    out = run_tool(["tools/learning_check.py", "--recipe", "flagship", "--device", "cpu",
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
    out = run_tool(["tools/learning_check.py", "--recipe", "flagship", "--device", "cpu",
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


def test_keep_newest_checkpoint(tmp_path):
    import learning_check

    for n in (10, 20, 9):
        (tmp_path / f"step_{n}").mkdir()
    learning_check.keep_newest_checkpoint(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_20"]
    (tmp_path / "final").mkdir()
    learning_check.keep_newest_checkpoint(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["final"]
