"""The port's tools run end to end at tiny sizes on the CPU:
``tools/seed_pilot.py`` (the layouts' verdict). The numbers are CPU numbers
and mean nothing; the shapes of the results are checked."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


def test_seed_pilot_verdict(tmp_path, monkeypatch, capsys):
    """``tools/seed_pilot.py`` on stub runs: each layout's runs' rates over
    the rate alone, the best layout whose every run keeps ``SHARE`` of it,
    every seed's rows in all its runs, and every checkpoint deleted."""
    import seed_pilot

    rates = {"together3": {0: 80.0, 1: 75.0, 2: 70.0},
             "together4": {0: 62.0, 1: 61.0, 2: 60.0, 3: 55.0}}

    def command(seed, out, extra):
        code = ("import json, os, sys, torch; out = sys.argv[1]; "
                "os.makedirs(out + '/ckpt/final'); "
                "torch.save({'w': torch.ones(64)}, out + '/ckpt/final/state.pt'); "
                "rate = float(sys.argv[2]); "
                "json.dump({'env_steps_per_s': rate, 'wall_s': 1.0, 'card': None, "
                "'rows': [{'step': 1000, 'port_win_rate': float(sys.argv[3]) / 10, "
                "'port_loss': 0.1, 'port_sps': rate}]}, "
                "open(out + '/result.json', 'w'))")
        rate = rates.get(out.parent.name, {}).get(seed, 100.0)
        return [sys.executable, "-c", code, str(out), str(rate), str(seed)]

    monkeypatch.setattr(seed_pilot, "command", command)
    assert seed_pilot.main(["--out", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["steps"] == 3000 and res["share_needed"] == 0.6
    three, four = res["layouts"]
    assert three["seeds"] == [0, 1, 2] and four["seeds"] == [0, 1, 2, 3]
    assert three["share_of_alone"] == {"0": 0.8, "1": 0.75, "2": 0.7}
    assert three["ok"] and not four["ok"]  # seed 3 keeps 0.55 of the rate alone
    assert three["total_of_alone"] == pytest.approx(2.25)
    assert four["total_of_alone"] == pytest.approx(2.38)
    assert res["best"] == 3 and res["rows_equal"] and res["steps_compared"] == [1000]
    assert res["runs_by_seed"] == {"0": 3, "1": 2, "2": 2, "3": 1}
    assert four["runs"]["3"]["sps_by_chunk"] == [55.0]
    assert not list(tmp_path.glob("*/s*/ckpt"))
    assert json.loads((tmp_path / "pilot.json").read_text()) == res

    def lay(seeds, rate, loss=0.1):
        return {"seeds": list(seeds), "runs": {s: {"env_steps_per_s": rate,
                                                    "rows": [(1000, s / 10, loss)]}
                                               for s in seeds}}

    alone = lay((0,), 100.0)
    ok = seed_pilot.verdict([lay((0, 1, 2), 60.0), lay((0, 1, 2, 3), 60.0)], alone)
    assert ok["best"] == 4 and ok["rows_equal"]  # 0.6 of the rate alone is enough
    parted = seed_pilot.verdict([lay((0, 1, 2), 70.0, loss=0.2)], alone)
    assert not parted["rows_equal"]  # seed 0's rows differ from its run alone
    assert seed_pilot.verdict([lay((0, 1, 2), 50.0)], alone)["best"] is None
