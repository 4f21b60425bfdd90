"""The port's tools run end to end at tiny sizes on the CPU:
``tools/seed_spread.py`` (the seeds' spread, the streams and the rule for
C-2). The numbers are CPU numbers and mean nothing; the shapes of the
results are checked."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


def _stream_result(seed, values, stream=None):
    """A learning-check result whose chunk rows read ``values`` at 25k and
    50k (JAX 0.1 and 0.4)."""
    rows = [{"step": st, "port_win_rate": v, "jax_win_rate": j}
            for st, v, j in zip((25000, 50000), values, (0.1, 0.4))]
    res = {"seed": seed, "rows": rows, "held_out": None,
           "band": {"training": [{"step": r["step"], "port": r["port_win_rate"],
                                  "jax": r["jax_win_rate"]} for r in rows]}}
    if stream is not None:
        res["bank_stream"] = stream
    return res


@pytest.mark.parametrize("case", ["c_open", "a_slow_seed", "a_within", "b_apart"])
def test_seed_spread_streams_and_c2_rule(case, tmp_path, capsys):
    """``tools/seed_spread.py`` with results of both bank streams: each
    stream's curve, Welch and the exact permutation test at 25k and 50k,
    the old seeds' z against the new ones, JAX's z against each group, and
    the rule for C-2."""
    import numpy as np
    import seed_spread
    from scipy import stats

    old50 = [0.40, 0.42, 0.22, 0.50, 0.44]
    new50 = {"c_open": [0.42, 0.45, 0.40, 0.47, 0.43, 0.44],
             "a_slow_seed": [0.42, 0.45, 0.29, 0.47, 0.43, 0.44],
             "a_within": [0.42, 0.25 + 0.06, 0.60, 0.47, 0.33, 0.44],
             "b_apart": [0.60, 0.62, 0.61, 0.63, 0.60, 0.62]}[case]
    if case == "b_apart":
        old50 = [0.40, 0.42, 0.36, 0.38, 0.41]
    files = []
    for i, v in enumerate(old50):
        files.append(tmp_path / f"old{i}.json")
        files[-1].write_text(json.dumps(_stream_result(i, [v / 4, v])))
    for i, v in enumerate(new50):
        files.append(tmp_path / f"new{i}.json")
        files[-1].write_text(json.dumps(_stream_result(i, [v / 4, v], "jax_order")))
    out = tmp_path / "spread.json"
    assert seed_spread.main([str(f) for f in files] + ["--out", str(out)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert set(res["groups"]) == {"bank_seed", "jax_order"}
    assert res["groups"]["jax_order"]["seeds"] == list(range(6))
    assert res["rows"] == res["groups"]["jax_order"]["rows"]
    c = res["curve"]["jax_order"]["50000"]
    assert c["n"] == 6 and c["mean"] == pytest.approx(np.mean(new50))
    t = res["streams"]["tests"]["50000"]
    x, y = np.array(old50), np.array(new50)
    assert t["welch_p"] == pytest.approx(stats.ttest_ind(x, y, equal_var=False).pvalue)
    assert 0 < t["permutation_p"] <= 1
    assert t["z_against_new"]["2"] == pytest.approx((old50[2] - y.mean()) / y.std(ddof=1))
    assert t["jax_z"]["new"] == pytest.approx((0.4 - y.mean()) / y.std(ddof=1))
    assert set(res["streams"]["tests"]) == {"25000", "50000"}
    assert res["streams"]["c2"]["verdict"] == case[0]
    # one seed twice in one stream is refused; in two streams it is not
    with pytest.raises(SystemExit):
        seed_spread.main([str(files[0]), str(files[0]), "--out", str(out)])


def test_seed_spread_permutation_p_exact():
    import numpy as np
    import seed_spread

    # 2 + 2 values: 6 splits, two of which are as far apart as the observed
    assert seed_spread.permutation_p(np.array([0.0, 0.1]),
                                     np.array([1.0, 1.1])) == pytest.approx(2 / 6)


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
