"""The port's tools run end to end at tiny sizes on the CPU:
``tools/flagship_policy.py`` (the policy file carries the run's seed). The
numbers are CPU numbers and mean nothing; the shapes of the results are
checked."""

import json
import sys
from pathlib import Path

import torch
from torch_port_helpers import tiny_run

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


def test_flagship_policy_carries_the_run_seed(tmp_path, capsys):
    """``tools/flagship_policy.py`` on a toy run: the newest reading's rows
    and the checkpoint's net in one file, with the run's training seed
    (from ``OUT/result.json``, 0 where the run has none), which ``cli
    eval``'s draws follow."""
    import flagship_policy

    from tetris_piclim_tpu_torch.utils.checkpoint import read_policy_npz, save_bank

    trainer, ckpt, _ = tiny_run(tmp_path)
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
