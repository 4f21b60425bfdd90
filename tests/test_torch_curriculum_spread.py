"""``tools/curriculum_segment.py``'s ``RULE_300K``: the six readings of a
300k curriculum run, the Welch / Holm verdict between the jax arm and the
port arm, the ``jax`` mode (the JAX package's own CLI on the CPU, at toy
sizes here) and the ``compare`` mode that joins both arms into one result."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import curriculum_segment as seg  # noqa: E402


def _rows(enter1=30000, enter2=140000, wr=None, last=300000) -> list:
    """Hand-made 10000-step rows of the 300k recipe: envs enter level 1 at
    ``enter1`` and level 2 at ``enter2`` (None: never); ``wr`` sets win
    rates by (level, step), 0.3 elsewhere."""
    wr = wr or {}
    rows = []
    for step in range(10000, last + 1, 10000):
        dist = [4096, 0, 0, 0]
        if enter1 is not None and step >= enter1:
            dist = [1, 4095, 0, 0]
        if enter2 is not None and step >= enter2:
            dist = [1, 64, 4031, 0]
        rows.append({"step": step, "loss": 0.2, "level_distribution": dist,
                     "win_rate_per_level": [wr.get((k, step), 0.3) for k in range(4)]})
    return rows


WR = {(0, 10000): 0.18, (0, 20000): 0.41, (1, 60000): 0.27, (2, 300000): 0.14}


@pytest.mark.parametrize("case,rows,ended,expect", [
    ("whole run", _rows(20000, 100000, WR), True,
     {"level0_10k": 0.18, "level0_20k": 0.41, "enter_level1": 20000,
      "enter_level2": 100000, "level1_after_entry": 0.27, "level2_300k": 0.14}),
    # never in level 2: it enters one chunk past its last row, and level 2
    # has no env to read a win rate from at 300k
    ("never enters level 2", _rows(20000, None, WR), True,
     {"level0_10k": 0.18, "level0_20k": 0.41, "enter_level1": 20000,
      "enter_level2": 310000, "level1_after_entry": 0.27, "level2_300k": None}),
    ("never enters level 1", _rows(None, None, WR), True,
     {"level0_10k": 0.18, "level0_20k": 0.41, "enter_level1": 310000,
      "enter_level2": 310000, "level1_after_entry": None, "level2_300k": None}),
    # cut at 150k: it counts for the readings it reached, and no entry is
    # made up for a level it might still have entered
    ("cut before 300k", _rows(20000, None, WR, last=150000), False,
     {"level0_10k": 0.18, "level0_20k": 0.41, "enter_level1": 20000,
      "enter_level2": None, "level1_after_entry": 0.27, "level2_300k": None}),
    ("cut before the level-1 reading", _rows(30000, None, WR, last=60000), False,
     {"level0_10k": 0.18, "level0_20k": 0.41, "enter_level1": 30000,
      "enter_level2": None, "level1_after_entry": None, "level2_300k": None}),
    ("cut after level 2", _rows(20000, 90000, WR, last=200000), False,
     {"level0_10k": 0.18, "level0_20k": 0.41, "enter_level1": 20000,
      "enter_level2": 90000, "level1_after_entry": 0.27, "level2_300k": None}),
])
def test_six_readings_on_made_up_rows(case, rows, ended, expect):
    got = seg.readings_300k(rows, ended)
    assert list(got) == list(seg.READINGS_300K)
    assert got == expect, case


def test_readings_of_jax_recorded_run_and_port_seeds():
    jax_rows, _ = seg.read_log(seg.JAX_LOG.read_text())
    assert seg.readings_300k(jax_rows, True) == {
        "level0_10k": 0.173, "level0_20k": 0.366, "enter_level1": 30000,
        "enter_level2": 140000, "level1_after_entry": 0.209, "level2_300k": 0.118}
    port = json.loads((ROOT / "results" / "curriculum_to_L5_h100.json").read_text())
    read = {int(s): seg.readings_300k(r["rows"], r["reached"] >= seg.STEPS)
            for s, r in port["seeds"].items()}
    assert [read[s]["enter_level2"] for s in range(4)] == [130000, 100000, 90000, 100000]
    assert [read[s]["level1_after_entry"] for s in range(4)] == [0.228, 0.274, 0.27, 0.278]


def _arm(**by_reading) -> dict:
    """seed -> readings: each reading's values by seed, 0.3 elsewhere."""
    n = len(next(iter(by_reading.values()), [0] * 8))
    return {s: {k: by_reading.get(k, [0.3] * n)[s] for k in seg.READINGS_300K}
            for s in range(n)}


RECORDED = {"level0_10k": 0.173, "level0_20k": 0.366, "enter_level1": 30000,
            "enter_level2": 140000, "level1_after_entry": 0.209, "level2_300k": 0.118}
SPREAD = [0.27, 0.29, 0.30, 0.31, 0.33, 0.28, 0.32, 0.30]


@pytest.mark.parametrize("case", ["apart", "alike", "constant"])
def test_rule_verdict_on_made_up_arms(case):
    jax = _arm(level0_10k=SPREAD, enter_level2=[140000 + 5000 * (s % 3) for s in range(8)])
    if case == "apart":
        port = _arm(level0_10k=SPREAD,
                    enter_level2=[100000 + 5000 * (s % 3) for s in range(8)])
    elif case == "alike":
        port = _arm(level0_10k=SPREAD[::-1],
                    enter_level2=[135000 + 5000 * (s % 4) for s in range(8)])
    else:
        jax = port = _arm()
    res = seg.compare_arms(jax, port, RECORDED)
    assert res["rule"] == seg.RULE_300K and res["alpha"] == 0.01
    assert res["tested"] == list(seg.READINGS_300K)
    row = res["readings"]["enter_level2"]
    if case == "apart":
        assert res["differs"] == ["enter_level2"] and not res["one_distribution"]
        w = row["port_minus_jax"]
        assert w["diff"] == -40000 and w["diff_95"][1] < 0 < w["p"] < 0.01
        assert row["rejected"] and not res["readings"]["level0_10k"]["rejected"]
    else:
        assert res["differs"] == [] and res["one_distribution"]
    if case == "constant":
        # equal constant arms: no difference and no spread, p 1.0
        for name in seg.READINGS_300K:
            r = res["readings"][name]
            assert r["port_minus_jax"]["p"] == 1.0 and r["port_minus_jax"]["diff"] == 0.0
            assert r["jax"]["sd"] == 0.0 and r["jax"]["recorded_z"] is None
        return
    # JAX's recorded run is placed on each arm by its z
    j = row["jax"]
    assert j["recorded_z"] == pytest.approx((140000 - j["mean"]) / j["sd"])
    assert j["mean_95"][0] < j["mean"] < j["mean_95"][1]
    assert j["sd"] == pytest.approx(float(np.std(list(j["values"].values()), ddof=1)))
    assert row["recorded"] == 140000 and res["readings"]["level0_10k"]["recorded"] == 0.173


def test_a_reading_too_few_runs_reached_is_not_tested():
    jax = _arm(level2_300k=[0.1, 0.12, 0.14, None])
    port = _arm(level2_300k=[0.13, None, None, None])
    res = seg.compare_arms(jax, port, RECORDED)
    assert "level2_300k" not in res["tested"] and len(res["tested"]) == 5
    assert res["readings"]["level2_300k"]["port"]["n"] == 1
    assert res["readings"]["level2_300k"]["jax"]["n"] == 3
    # a verdict needs all six readings
    assert not res["one_distribution"] and res["differs"] == []


def test_jax_mode_runs_the_jax_cli_at_toy_size(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "tpu")  # the tool sets the CPU itself
    toy = ["--num-envs", "16", "--steps", "40", "--chunk", "20", "--bank", "16",
           "--replay", "2048", "--warmup", "8", "--eval-episodes", "8"]
    # the tool's --timeout kills a run that hangs: it then exits 124
    assert seg.main(["jax", "--seeds", "2:3", "--concurrent", "1", "--out", str(tmp_path),
                     "--timeout", "240", "--", *toy]) == 0
    rec = json.loads((tmp_path / "jax_s2.json").read_text())
    assert rec["rc"] == 0 and rec["package"] == "jax" and rec["device"] == "cpu"
    assert rec["command"] == ["python", "-m", "tetris_piclim_tpu", "curriculum",
                              *seg.RECIPE, "--seed", "2", *toy]
    assert [r["step"] for r in rec["rows"]] == [20, 40]
    assert rec["rows"][-1]["level_distribution"] == [16, 0, 0, 0]
    assert rec["final"]["train"]["step"] == 40 and len(rec["final"]["eval_per_level"]) == 4
    assert rec["cpu_env_steps_per_s"] > 0 and rec["concurrent"] == 1
    assert (tmp_path / "jax_s2.log").read_text().count("] loss=") == 2
    assert seg.jax_runs(tmp_path)[2]["rows"] == rec["rows"]


def _port_segment(d: Path, seed: int, rows: list, start: int, stop: int, rc: int = 0):
    d.mkdir(parents=True, exist_ok=True)
    rec = {"seed": seed, "start": start, "stop": stop, "rc": rc,
           "rows": [r for r in rows if start < r["step"] <= stop], "final": None,
           "env_steps_per_s": 2.5e5, "wall_s": 1500.0, "concurrent": 4,
           "card": "NVIDIA H100 80GB HBM3, 700.00 W", "host": {},
           "state_bytes": 1, "state_packed_bytes": 1}
    (d / f"segment_{start}.json").write_text(json.dumps(rec) + "\n")


def test_compare_joins_the_port_arm_and_the_jax_arm(tmp_path):
    # the port arm: seeds 0-1 from an earlier summarize result, 2-3 as segments
    earlier = {"seeds": {str(s): {"reached": 300000, "rows": _rows(20000, 100000 + 10000 * s),
                                  "final": None, "segments": []} for s in (0, 1)}}
    (tmp_path / "earlier.json").write_text(json.dumps(earlier))
    out = tmp_path / "segments"
    for s in (2, 3):
        rows = _rows(20000, 90000 + 10000 * s)
        for start in (0, 100000, 200000):
            _port_segment(out / f"s{s}", s, rows, start, start + 100000)
    # the jax arm: seed 3 cut at 150k by the tool's timeout
    jax = tmp_path / "jax"
    jax.mkdir()
    for s in range(4):
        rows = _rows(30000, 130000 + 10000 * s, last=150000 if s == 3 else 300000)
        (jax / f"jax_s{s}.json").write_text(json.dumps(
            {"package": "jax", "seed": s, "rc": 124 if s == 3 else 0, "rows": rows,
             "final": None, "cpu_env_steps_per_s": 5e5}) + "\n")
    result = tmp_path / "spread.json"
    assert seg.main(["compare", "--out", str(out), "--jax", str(jax), "--port-result",
                     str(tmp_path / "earlier.json"), "--result", str(result)]) == 0
    res = json.loads(result.read_text())
    assert res["rule"] == seg.RULE_300K and res["recipe"] == seg.RECIPE
    assert sorted(res["arms"]["port"]["seeds"]) == ["0", "1", "2", "3"]
    assert sorted(res["arms"]["jax"]["seeds"]) == ["0", "1", "2", "3"]
    assert res["arms"]["port"]["cards"] == ["NVIDIA H100 80GB HBM3, 700.00 W"]
    assert res["short_runs"] == [{"arm": "jax", "seed": 3, "reached": 150000, "rc": 124}]
    e2 = res["readings"]["enter_level2"]
    assert e2["port"]["values"] == {"0": 100000, "1": 110000, "2": 110000, "3": 120000}
    assert e2["jax"]["values"] == {"0": 130000, "1": 140000, "2": 150000}
    assert e2["port_minus_jax"]["diff"] == pytest.approx(110000 - 140000)
    assert res["readings"]["level2_300k"]["jax"]["n"] == 3
    assert res["jax_recorded"]["readings"] == RECORDED
    # the bands, on each arm's runs that reached 300k
    assert res["bands"]["port"]["enter_level2"]["n"] == 4
    assert res["bands"]["jax"]["enter_level2"]["n"] == 3
    assert res["bands"]["jax"]["enter_level2"]["holds"] is True
    # a seed in both sources of the port arm is refused
    _port_segment(out / "s1", 1, _rows(), 0, 100000)
    with pytest.raises(SystemExit, match="seed 1 is both"):
        seg.spread(out, jax, [tmp_path / "earlier.json"])
