"""``tools/curriculum_check.py``: the JAX log it reads, its bands and rule,
its command line, and a toy run on the CPU."""

import argparse
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import curriculum_check as cc  # noqa: E402


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
