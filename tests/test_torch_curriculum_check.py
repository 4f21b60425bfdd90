"""``tools/curriculum_check.py``: the JAX log it reads, its bands and rule,
its command line, and a toy run on the CPU; the 300k recipe and bands of
``tools/curriculum_segment.py``."""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import curriculum_check as cc  # noqa: E402
import curriculum_segment as seg  # noqa: E402


def test_jax_log_parses_to_its_rows_and_final_line():
    rows, final = cc.read_log(cc.JAX_LOG.read_text())
    assert [r["step"] for r in rows] == list(range(2000, 40001, 2000))
    assert rows[-1]["win_rate_per_level"] == final["win_rate_per_level"] == [
        0.509, 0.089, 0.0, 0.0]
    assert final["level_distribution"] == [32, 4064, 0, 0]
    assert final["step"] == 40000 and final["loss"] == pytest.approx(0.1751, abs=1e-4)
    assert cc.readings(rows) == {"level0_10k": 0.264, "level0_20k": 0.41,
                                 "level0_26k": 0.473, "first_promotion": 28000,
                                 "level1_40k": 0.089}


def _rows(wr0: dict, promote_at, wr1_40k=0.089, last=40000, envs=4096) -> list:
    """Hand-made chunk rows: level 0's win rate at the steps of ``wr0``
    (0.3 elsewhere), half the envs up at ``promote_at`` (None: never)."""
    rows = []
    for step in range(2000, last + 1, 2000):
        up = promote_at is not None and step >= promote_at
        rows.append({"step": step, "loss": 0.5,
                     "win_rate_per_level": [wr0.get(step, 0.3),
                                            wr1_40k if step == 40000 else 0.0, 0.0, 0.0],
                     "level_distribution": [envs // 2 if up else envs,
                                            envs // 2 if up else 0, 0, 0]})
    return rows


def _run(seed, rows, tree="repaired") -> dict:
    return {"tree": tree, "seed": seed, "rows": rows}


JAX_ROWS = _rows({10000: 0.264, 20000: 0.41, 26000: 0.473}, 28000)


@pytest.mark.parametrize("name,values,holds", [
    # inside: every seed near JAX
    ("level0_20k", [0.40, 0.42, 0.44], True),
    # outside: the median 0.06 below
    ("level0_20k", [0.33, 0.35, 0.36], False),
    # one seed far out, the median inside
    ("level0_20k", [0.05, 0.41, 0.42], True),
    # first promotion early (median 22k, 6k before JAX's) and late (34k)
    ("first_promotion", [20000, 22000, 24000], False),
    ("first_promotion", [32000, 34000, 36000], False),
    ("first_promotion", [26000, 30000, 32000], True),
    # two of three never promote: the median is past every step
    ("first_promotion", [30000, None, None], False),
    # one never promotes, the median is the middle run's
    ("first_promotion", [26000, 28000, None], True),
    ("level1_40k", [0.03, 0.10, 0.12], True),
])
def test_band_rule_on_hand_made_rows(name, values, holds):
    runs = []
    for seed, v in enumerate(values):
        if name == "first_promotion":
            runs.append(_run(seed, _rows({}, v)))
        elif name == "level1_40k":
            runs.append(_run(seed, _rows({}, 28000, wr1_40k=v)))
        else:
            runs.append(_run(seed, _rows({int(name[7:-1]) * 1000: v}, 28000)))
    b = cc.bands(runs, JAX_ROWS)[name]
    assert b["holds"] is holds
    assert b["n"] == len(values)
    finite = sorted(v for v in values if v is not None)
    if len(finite) == len(values):
        assert b["median"] == pytest.approx(sorted(values)[1])
    assert b["never_promoted"] == [s for s, v in enumerate(values) if v is None]
    assert set(b["z"]) == {s for s, v in enumerate(values) if v is not None}


def test_lone_outlier_is_read_against_the_spread():
    """One seed far below the others leaves the median inside and shows as
    the largest |z|; a parent run is set against the repaired runs' spread."""
    vals = [0.41, 0.42, 0.43, 0.20]
    runs = [_run(s, _rows({20000: v}, 28000)) for s, v in enumerate(vals)]
    runs.append(_run(0, _rows({20000: 0.45}, 28000), tree="parent"))
    b = cc.bands(runs, JAX_ROWS)["level0_20k"]
    assert b["holds"] is True and b["median"] == pytest.approx(0.415)
    assert max(b["z"], key=lambda s: abs(b["z"][s])) == 3
    assert b["parent"] == {0: 0.45}
    assert b["parent_z"][0] == pytest.approx((0.45 - b["mean"]) / b["sd"])
    assert b["jax_z"] == pytest.approx((0.41 - b["mean"]) / b["sd"])


def test_a_run_cut_short_leaves_the_band_unread():
    runs = [_run(0, _rows({20000: 0.41}, 28000)),
            _run(1, _rows({20000: 0.43}, None, last=20000))]
    b = cc.bands(runs, JAX_ROWS)
    assert b["level0_20k"]["holds"] is True
    assert b["level0_26k"]["holds"] is None and b["level1_40k"]["holds"] is None
    assert b["first_promotion"]["holds"] is None
    v = cc.verdict(b)
    assert v["all_hold"] is False and "level1_40k" in v["bands_unread"]


def test_command_line_is_the_recipe(monkeypatch):
    assert cc.command(3, "cuda", []) == [
        sys.executable, "-m", "tetris_piclim_tpu_torch", "curriculum",
        "--levels", "1:10,2:15,3:20,5:25", "--num-envs", "4096",
        "--steps", "40000", "--chunk", "2000", "--threshold", "0.5",
        "--seed", "3", "--device", "cuda"]
    port = cc.parse_flags([])
    # the rest at the JAX CLI's defaults, which the port's share
    import tetris_piclim_tpu.cli as jcli

    seen = {}
    monkeypatch.setattr(jcli, "cmd_curriculum", lambda args: seen.update(vars(args)) or 0)
    jcli.main(["curriculum", *cc.RECIPE])
    keys = ("levels", "num_envs", "bank", "replay", "warmup", "steps", "chunk",
            "threshold", "seed", "eval_episodes", "updates", "model", "dueling",
            "joint", "bf16")
    assert {k: getattr(port, k) for k in keys} == {k: seen[k] for k in keys}
    assert (port.bank, port.replay, port.warmup, port.updates, port.model) == (
        1024, 131072, 1000, 1, "mlp")


def test_toy_cpu_run_writes_a_result(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert cc.main(["--seeds", "0:2", "--device", "cpu", "--out", str(tmp_path),
                    "--timeout", "120", "--", "--num-envs", "32", "--bank", "16",
                    "--replay", "2048", "--warmup", "64", "--steps", "40",
                    "--chunk", "20", "--eval-episodes", "8"]) == 0
    res = json.loads((tmp_path / "result.json").read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert [(r["tree"], r["seed"], r["rc"]) for r in res["runs"]] == [
        ("repaired", 0, 0), ("repaired", 1, 0)]
    for r in res["runs"]:
        assert [row["step"] for row in r["rows"]] == [20, 40]
        assert len(r["eval_per_level"]) == 4 and r["final"]["train"]["step"] == 40
        assert r["env_steps_per_s"] > 0 and r["wall_s"] > 0 and r["card"] is None
    assert res["verdict"]["bands_unread"] == list(cc.BANDS)
    assert len(res["jax"]["rows"]) == 20
    # a second call adds to the records; --summarize-only rebuilds the result
    assert cc.main(["--summarize-only", "--out", str(tmp_path),
                    "--result", str(tmp_path / "again.json")]) == 0
    assert json.loads((tmp_path / "again.json").read_text()) == res


def test_label_follows_the_tree(tmp_path, monkeypatch):
    class Proc:
        stderr = iter(())

        def wait(self, timeout=None):
            return 0

    def popen(cmd, cwd, **kw):
        Proc.stderr = iter(["[   20] loss=0.1 wr=[0.5,0,0,0] dist=[32,0,0,0]\n"])
        return Proc()

    monkeypatch.setattr(cc.subprocess, "Popen", popen)
    for tree, label in ((cc.ROOT / "tools" / "..", "repaired"),
                        (tmp_path / "parent", "parent")):
        out = tmp_path / label
        out.mkdir()
        a = argparse.Namespace(tree=str(tree), seeds=(0, 1), device="cpu",
                               timeout=10.0)
        cc.run_seeds(a, ["--num-envs", "32"], out)
        rec = json.loads((out / f"{label}_s0.json").read_text())
        assert rec["tree"] == label and rec["rows"][0]["step"] == 20
        assert sorted(p.name for p in out.iterdir()) == [
            f"{label}_s0.{x}" for x in ("json", "log", "out")]


def test_jax_package_runs_its_own_cli_on_the_cpu(tmp_path, monkeypatch):
    assert cc.command(3, "cpu", ["--num-envs", "2048"], package="jax") == [
        sys.executable, "-m", "tetris_piclim_tpu", "curriculum", *cc.RECIPE,
        "--seed", "3", "--num-envs", "2048"]
    seen = []

    class Proc:
        stderr = iter(())

        def wait(self, timeout=None):
            return 0

    def popen(cmd, cwd, env, **kw):
        seen.append((cmd, env))
        Proc.stderr = iter(["[   20] loss=0.1 wr=[0.5,0,0,0] dist=[32,0,0,0]\n"])
        return Proc()

    monkeypatch.setattr(cc.subprocess, "Popen", popen)
    monkeypatch.setenv("JAX_PLATFORMS", "tpu")
    a = argparse.Namespace(tree=str(cc.ROOT), seeds=(0, 2), device="cuda",
                           timeout=10.0, package="jax", matmul="f32")
    cc.run_seeds(a, ["--num-envs", "32"], tmp_path)
    assert len(seen) == 2
    for cmd, env in seen:
        assert cmd[1:3] == ["-m", "tetris_piclim_tpu"] and "--device" not in cmd
        assert env["JAX_PLATFORMS"] == "cpu"
    rec = json.loads((tmp_path / "jax_s1.json").read_text())
    assert (rec["tree"], rec["package"], rec["device"], rec["card"]) == (
        "jax", "jax", "cpu", None)
    assert cc.flags_of(rec["command"]) == ([*cc.RECIPE, "--num-envs", "32"], "cpu")
    with pytest.raises(SystemExit):
        cc.main(["--package", "jax", "--matmul", "bf16", "--out", str(tmp_path)])


def test_bf16_rounds_every_linear_before_the_cli_runs(tmp_path, monkeypatch):
    import torch

    from tetris_piclim_tpu_torch import cli

    assert cc.command(2, "cuda", [], matmul="bf16") == [
        sys.executable, "-c", cc.BF16_MAIN, "curriculum", *cc.RECIPE,
        "--seed", "2", "--device", "cuda"]
    assert cc.label_of(cc.ROOT, "torch", "bf16") == "port_bf16"
    with pytest.raises(SystemExit):  # the rounding is this checkout's tool's
        cc.main(["--matmul", "bf16", "--tree", str(tmp_path), "--out", str(tmp_path)])
    x = torch.tensor([[1 + 2 ** -12, 1.0]], requires_grad=True)
    seen = {}

    def main():
        lin = torch.nn.Linear(2, 1, bias=False)
        with torch.no_grad():
            lin.weight.copy_(torch.tensor([[1.0, 1 + 2 ** -12]]))
        out = lin(x)
        out.sum().backward()
        seen.update(out=float(out.detach()), grad=x.grad.clone())
        return 0

    monkeypatch.setattr(cli, "main", main)
    monkeypatch.setattr(torch.nn.Linear, "forward", torch.nn.Linear.forward)
    monkeypatch.chdir(cc.ROOT)
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(SystemExit) as e:
        exec(cc.BF16_MAIN, {})
    assert e.value.code == 0
    # both operands rounded to bfloat16 (8 bits of mantissa): 1 + 1
    assert seen["out"] == 2.0 and seen["grad"].tolist() == [[1.0, 1.0]]


def _rec(label, seed, rows, flags=(), device="cpu") -> dict:
    head = ["python", "-m", "tetris_piclim_tpu" if label == "jax"
            else "tetris_piclim_tpu_torch"]
    dev = [] if label == "jax" else ["--device", device]
    return {"tree": label, "seed": seed, "rows": rows, "rc": 0, "card": None,
            "command": [*head, "curriculum", *cc.RECIPE, "--seed", str(seed), *dev,
                        *flags]}


def test_labels_and_flags_summarize_apart(tmp_path):
    cpu = ["--num-envs", "2048"]
    recs = [_rec("repaired", 0, _rows({}, 28000), cpu),
            _rec("repaired", 1, _rows({}, 24000), cpu),
            _rec("repaired", 0, _rows({}, 24000), device="cuda"),
            _rec("jax", 0, _rows({}, 30000), cpu),
            _rec("port_bf16", 0, _rows({}, 26000), device="cuda")]
    names = ["repaired_s0", "repaired_s1", "repaired_s2", "jax_s0", "port_bf16_s0"]
    recs[2]["seed"] = 2
    for name, r in zip(names, recs):
        (tmp_path / f"{name}.json").write_text(json.dumps(r))
    res = cc.summarize(tmp_path, tmp_path / "none.json")
    got = {(g["label"], g["device"], tuple(g["flags"])): g["seeds"] for g in res["groups"]}
    assert got == {("repaired", "cpu", (*cc.RECIPE, *cpu)): [0, 1],
                   ("repaired", "cuda", tuple(cc.RECIPE)): [2],
                   ("jax", "cpu", (*cc.RECIPE, *cpu)): [0],
                   ("port_bf16", "cuda", tuple(cc.RECIPE)): [0]}
    first = {g["label"] + g["device"]: g["bands"]["first_promotion"]["median"]
             for g in res["groups"]}
    assert first == {"repairedcpu": 26000, "repairedcuda": 24000, "jaxcpu": 30000,
                     "port_bf16cuda": 26000}
    assert res["bands"] == res["groups"][0]["bands"]
    # each other label set against the repaired runs of its device and flags
    bf16 = res["groups"][3]["against_repaired"]["first_promotion"]
    assert (bf16["median"], bf16["repaired_median"], bf16["z"]) == (26000, 24000, {0: None})
    jax = res["groups"][2]["against_repaired"]["first_promotion"]
    assert jax["z"] == {0: pytest.approx(4000 / (4000 / 2 ** 0.5))}
    assert "minus_repaired" not in jax  # one jax run: no test
    # the jax runs meet the port runs of their flags only
    assert [(c["jax"], c["port"], c["device"]) for c in res["comparisons"]] == [
        ("jax", "repaired", "cpu")]
    assert res["comparisons"][0]["seeds"] == {"jax": [0], "port": [0, 1]}


def _arm(label, promotions, wr20, wr1):
    """Six made-up runs: level 0 at 20k ``wr20``, promoted at ``promotions``,
    level 1 ``wr1`` 12k steps after it."""
    return [_level1_after(_rec(label, s, _rows({20000: w, 10000: 0.25 + 0.01 * s,
                                                26000: 0.45 - 0.01 * s}, p),
                               ["--num-envs", "2048"]), p, v)
            for s, (p, w, v) in enumerate(zip(promotions, wr20, wr1))]


def _level1_after(rec, promo, value):
    for r in rec["rows"]:
        if r["step"] == promo + cc.AFTER_PROMOTION:
            r["win_rate_per_level"][1] = value
    return rec


@pytest.mark.parametrize("apart", [False, True])
def test_welch_holm_verdict_on_made_up_rows(apart):
    promos = [24000, 26000, 28000, 26000, 24000, 28000]
    jax = _arm("jax", promos, [0.40, 0.42, 0.41, 0.43, 0.39, 0.41],
               [0.10, 0.14, 0.12, 0.09, 0.15, 0.11])
    shift = 0.2 if apart else 0.0
    port = _arm("repaired", promos[::-1], [0.41, 0.40, 0.42, 0.42, 0.40, 0.43],
                [0.12 + shift, 0.10 + shift, 0.13 + shift, 0.11 + shift,
                 0.14 + shift, 0.10 + shift])
    jax_rows = cc.read_log(cc.JAX_LOG.read_text())[0]
    (c,) = cc.comparisons(jax + port, jax_rows, [])
    assert c["rule"] == cc.RULE and c["seeds"] == {"jax": list(range(6)),
                                                   "port": list(range(6))}
    row = c["readings"]["level1_after_promotion"]
    assert row["jax"]["n"] == row["port"]["n"] == 6
    assert row["port_minus_jax"]["diff"] == pytest.approx(shift - 0.01 / 6, abs=1e-9)
    lo, hi = row["port_minus_jax"]["diff_95"]
    assert lo < row["port_minus_jax"]["diff"] < hi
    assert row["recorded"]["value"] == cc.compare_readings(jax_rows)[
        "level1_after_promotion"] == 0.089
    assert c["differs"] == (["level1_after_promotion"] if apart else [])
    assert c["one_distribution"] is (not apart)
    assert all(c["readings"][k]["rejected"] is False for k in cc.COMPARE[:4])
    # Holm: the smallest p against alpha / 5, the next against alpha / 4
    assert cc.holm({"a": 0.001, "b": 0.0024, "c": 0.5}) == {"a": True, "b": True,
                                                           "c": False}
    assert cc.holm({"a": 0.003, "b": 0.001}) == {"a": True, "b": True}
    # both under alpha, but the smaller not under alpha / 2: neither
    assert cc.holm({"a": 0.006, "b": 0.0055}) == {"a": False, "b": False}


def test_a_run_that_never_promotes_enters_past_its_end():
    rows = _rows({}, None)
    got = cc.compare_readings(rows, end=40000)
    assert got["first_promotion"] == 42000 and got["level1_after_promotion"] is None
    assert cc.compare_readings(rows)["first_promotion"] is None
    late = cc.compare_readings(_rows({}, 30000), end=40000)
    assert late["first_promotion"] == 30000 and late["level1_after_promotion"] is None
    # a record of the whole recipe enters past its end; a shorter run (a
    # swap arm) keeps only the rows it reached
    assert cc.run_readings(_rec("repaired", 0, rows))["first_promotion"] == 42000
    short = cc.run_readings(_rec("port_swap_init", 0, _rows({10000: 0.3}, None, last=10000)))
    assert short == {"level0_10k": 0.3, "level0_20k": None, "level0_26k": None,
                     "first_promotion": None, "level1_after_promotion": None}
    assert cc.same_recipe(["--steps", "10000", "--num-envs", "2048"],
                          ["--num-envs", "2048"])
    assert not cc.same_recipe(["--num-envs", "1024"], ["--num-envs", "2048"])


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_tiny_real_run_of_each_package(tmp_path, monkeypatch, package):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert cc.main(["--package", package, "--device", "cpu", "--seeds", "0:1",
                    "--out", str(tmp_path), "--timeout", "120", "--",
                    "--levels", "1:4,2:6", "--num-envs", "16", "--bank", "8",
                    "--replay", "512", "--warmup", "32", "--steps", "20",
                    "--chunk", "10", "--eval-episodes", "4"]) == 0
    res = json.loads((tmp_path / "result.json").read_text())
    (run,) = res["runs"]
    label = "jax" if package == "jax" else "repaired"
    assert (run["tree"], run["rc"], run["device"]) == (label, 0, "cpu")
    assert [r["step"] for r in run["rows"]] == [10, 20]
    assert len(run["eval_per_level"]) == 2 and run["final"]["train"]["step"] == 20
    assert [g["label"] for g in res["groups"]] == [label]
    assert ("comparisons" in res) is (package == "jax")


def test_all_three_swaps_make_the_port_run_jax_run():
    """With JAX's banks, initial weights and draws swapped in, ``cli
    curriculum`` of the port gives the rows of JAX's, promotion included;
    ``--swap`` runs one part at a time under its own label."""
    assert cc.command(1, "cpu", [], swap="init")[1:3] == ["-c", cc.SWAP_MAIN.format("init")]
    assert cc.label_of(cc.ROOT, swap="draws") == "port_swap_draws"
    args = ["curriculum", "--levels", "1:4,2:6", "--num-envs", "16", "--bank", "8",
            "--replay", "512", "--warmup", "32", "--steps", "30", "--chunk", "10",
            "--eval-episodes", "4", "--threshold", "0.2", "--seed", "3"]
    env = dict(cc.run_env(cc.ROOT, "jax"), OMP_NUM_THREADS="1")
    runs = [[sys.executable, "-m", "tetris_piclim_tpu", *args],
            [sys.executable, "-c", cc.SWAP_MAIN.format("banks,init,draws"), *args,
             "--device", "cpu"]]
    rows = []
    for cmd in runs:
        out = cc.subprocess.run(cmd, cwd=cc.ROOT, env=env, capture_output=True,
                                text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        rows.append(cc.read_log(out.stderr)[0])
    assert [r["step"] for r in rows[0]] == [10, 20, 30]
    assert rows[0][-1]["level_distribution"] == [8, 8]
    assert rows[1] == rows[0]


# -- JAX's 300k run (tools/curriculum_segment.py) and the fresh-seed reading --


def test_300k_recipe_reads_the_jax_log(monkeypatch):
    rows, final = cc.read_log(seg.JAX_LOG.read_text())
    assert [r["step"] for r in rows] == list(range(10000, 300001, 10000))
    assert final == {"step": 300000, "loss": pytest.approx(0.14058391749858856),
                     "win_rate_per_level": [0.412, 0.408, 0.118, 0.0],
                     "level_distribution": [1, 64, 4031, 0]}
    assert rows[-1]["win_rate_per_level"] == final["win_rate_per_level"]
    assert {k: seg.reading(rows, k) for k in seg.BANDS} == {
        "level2_300k": 0.118, "level1_300k": 0.408, "level0_10k": 0.173,
        "level0_20k": 0.366, "enter_level1": 30000, "enter_level2": 140000,
        "level3_envs_300k": 0}
    # the recipe's flags, and the JAX CLI's defaults for the rest
    import tetris_piclim_tpu.cli as jcli

    seen = {}
    monkeypatch.setattr(jcli, "cmd_curriculum", lambda args: seen.update(vars(args)) or 0)
    jcli.main(["curriculum", *seg.RECIPE])
    port = seg.parse_flags(seg.RECIPE)
    keys = ("levels", "num_envs", "bank", "replay", "warmup", "steps", "chunk",
            "threshold", "seed", "eval_episodes", "updates", "model", "dueling",
            "joint", "bf16")
    assert {k: getattr(port, k) for k in keys} == {k: seen[k] for k in keys}
    assert (port.num_envs, port.steps, port.chunk, port.threshold) == (4096, 300000, 10000, 0.4)


def _rows300(enter1=30000, enter2=140000, wr=None, last=300000, at3=0) -> list:
    """Hand-made 10000-step rows: envs enter level 1 at ``enter1`` and
    level 2 at ``enter2`` (None: never); ``wr`` sets win rates by (level,
    step); ``at3`` envs sit at level 3 from 290k on."""
    wr = wr or {}
    rows = []
    for step in range(10000, last + 1, 10000):
        dist = [4096, 0, 0, 0]
        if enter1 is not None and step >= enter1:
            dist = [1, 4095, 0, 0]
        if enter2 is not None and step >= enter2:
            dist = [1, 64, 4031, 0]
        if step >= 290000 and at3:
            dist[2] -= at3
            dist[3] = at3
        rows.append({"step": step, "loss": 0.2, "level_distribution": dist,
                     "win_rate_per_level": [wr.get((k, step), 0.3) for k in range(4)]})
    return rows


@pytest.mark.parametrize("name,seeds,holds", [
    # the headline: level 2 at 300k, median of four inside / outside 0.05
    ("level2_300k", [_rows300(wr={(2, 300000): v}) for v in (0.10, 0.12, 0.15, 0.30)], True),
    ("level2_300k", [_rows300(wr={(2, 300000): v}) for v in (0.17, 0.18, 0.19, 0.05)], False),
    ("level1_300k", [_rows300(wr={(1, 300000): v}) for v in (0.38, 0.40, 0.43, 0.45)], True),
    ("level0_10k", [_rows300(wr={(0, 10000): v}) for v in (0.25, 0.26, 0.28, 0.30)], False),
    ("level0_20k", [_rows300(wr={(0, 20000): v}) for v in (0.33, 0.35, 0.38, 0.40)], True),
    # entries: within one chunk of 30000, within 20000 of 140000
    ("enter_level1", [_rows300(enter1=s) for s in (20000, 20000, 30000, 40000)], True),
    ("enter_level1", [_rows300(enter1=s) for s in (10000, 10000, 20000, 10000)], False),
    ("enter_level2", [_rows300(enter2=s) for s in (110000, 120000, 130000, 150000)], True),
    ("enter_level2", [_rows300(enter2=s) for s in (90000, 100000, 100000, 160000)], False),
    # a seed that never enters counts as later than any step: two of four
    # never entering put the median past the band
    ("enter_level2", [_rows300(enter2=s) for s in (140000, 150000, None, None)], False),
    ("enter_level2", [_rows300(enter2=s) for s in (130000, 140000, 150000, None)], True),
    ("level3_envs_300k", [_rows300() for _ in range(4)], True),
    ("level3_envs_300k", [_rows300(at3=a) for a in (0, 2, 3, 5)], False),
])
def test_300k_bands_on_made_up_rows(name, seeds, holds):
    jax_rows = cc.read_log(seg.JAX_LOG.read_text())[0]
    b = seg.bands(dict(enumerate(seeds)), jax_rows, 300000)
    assert b[name]["holds"] is holds
    assert b[name]["n"] == 4 and set(b[name]["seeds"]) == {0, 1, 2, 3}
    finite = [v for v in b[name]["seeds"].values() if v is not None]
    if len(finite) >= 2:
        assert b[name]["sd"] == pytest.approx(float(np.std(finite, ddof=1)))
    v = seg.verdict(b)
    assert (name in v["bands_held"]) is holds and (name in v["bands_missed"]) is not holds


def test_300k_bands_unread_until_a_seed_reaches_the_end():
    jax_rows = cc.read_log(seg.JAX_LOG.read_text())[0]
    b = seg.bands({0: _rows300(last=150000), 1: _rows300()}, jax_rows, 300000)
    assert b["level2_300k"]["n"] == 1 and b["level2_300k"]["holds"] is False
    b = seg.bands({0: _rows300(last=150000)}, jax_rows, 300000)
    assert seg.verdict(b)["bands_unread"] == list(seg.BANDS)


def test_fresh_seeds_read_apart_and_card_runs_labelled_apart(tmp_path, monkeypatch):
    """``--apart 6:18`` reads seeds 6-17 of both arms on their own beside
    every seed; the port's card runs are recorded and compared apart from
    its CPU runs, and set against them on the seeds both ran."""
    flags = ["--num-envs", "2048"]
    promos = [24000, 26000, 28000, 30000, 26000, 28000]
    recs = {}
    for s in range(18):
        recs[f"jax_s{s}"] = _rec("jax", s, _rows({}, promos[s % 6]), flags)
        recs[f"repaired_cuda_s{s}"] = _rec("repaired", s, _rows({}, promos[s % 6] - 2000),
                                           flags, device="cuda")
    for s in range(6):
        recs[f"repaired_s{s}"] = _rec("repaired", s, _rows({}, promos[s]), flags)
    for name, r in recs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(r))
    res = cc.summarize(tmp_path, tmp_path / "none.json", apart=(6, 18))
    got = [(c["port"], c["device"], c["seeds_read"], c["seeds"]["port"])
           for c in res["comparisons"]]
    assert got == [("repaired", "cpu", "all", list(range(6))),
                   ("repaired", "cuda", "all", list(range(18))),
                   ("repaired", "cuda", [6, 18], list(range(6, 18)))]
    fresh = res["comparisons"][2]
    assert fresh["seeds"]["jax"] == list(range(6, 18)) and fresh["rule"] == cc.RULE
    assert fresh["readings"]["first_promotion"]["port_minus_jax"]["diff"] == -2000
    (dev,) = res["device_checks"]
    assert (dev["port"], dev["seeds_read"]) == ("repaired", list(range(6)))
    assert dev["seeds"] == {"cpu": list(range(6)), "cuda": list(range(6))}
    assert dev["readings"]["first_promotion"]["cuda_minus_cpu"]["diff"] == -2000
    assert "recorded" not in dev["readings"]["first_promotion"]
    # the tool names a card run's record apart from the CPU run of its seed
    assert cc.record_stem("repaired", "cuda", 3) == "repaired_cuda_s3"
    assert cc.record_stem("repaired", "cpu", 3) == "repaired_s3"

    class Proc:
        stderr = iter(["[ 2000] loss=0.1 wr=[0.5,0,0,0] dist=[32,0,0,0]\n"])

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(cc.subprocess, "Popen", lambda cmd, cwd, **kw: Proc())
    monkeypatch.setattr(cc, "card", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    out = tmp_path / "card"
    out.mkdir()
    cc.run_seeds(argparse.Namespace(tree=str(cc.ROOT), seeds=(3, 4), device="cuda",
                                    timeout=10.0), flags, out)
    rec = json.loads((out / "repaired_cuda_s3.json").read_text())
    assert (rec["tree"], rec["device"], rec["card"]) == (
        "repaired", "cuda", "NVIDIA H100 80GB HBM3, 700.00 W")
