"""``tools/jax_holdout_rows.py`` at a toy size (L=1/M=8, 16 held-out rows):
the JAX package's held-out rows built on the CPU, the port's own held-out
host rows found to be JAX's first host rows seed for seed, and a toy
policy played once on every row, the forward fraction per host count
adding up from its parts; ``--save`` writes those rows, each part in
JAX's order."""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import jax_holdout_rows as jhr  # noqa: E402

from tetris_piclim_tpu_torch.gen.bank import ConfigBank, make_holdout_bank  # noqa: E402
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork  # noqa: E402
from tetris_piclim_tpu_torch.utils.checkpoint import save_policy_npz  # noqa: E402

torch.set_num_threads(1)


def test_jax_holdout_rows_small(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jhr, "L", 1)
    monkeypatch.setattr(jhr, "M", 8)
    monkeypatch.setattr(jhr, "CAPACITY", 16)
    hold = make_holdout_bank(1, 8, 16, device="cpu", forward_seed_budget=100)
    assert hold.provenance["host_forward"] > 0
    train = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
    net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                       generator=torch.Generator().manual_seed(2))
    ev = {"holdout": {"win_rate": 0.5, "build": hold.provenance},
          "holdout_carve": {"win_rate": 0.5}, "holdout_forward": {"win_rate": 0.5}}
    meta = {"L": 1, "M": 8, "step": 10, "eval": ev,
            "net": {"model": "conv", "channels": [4, 8], "dueling": True, "joint": True}}
    path = tmp_path / "toy_policy.npz"
    save_policy_npz(str(path), net.state_dict(), {"train": train, "holdout": hold}, meta)
    saved = tmp_path / "jax_rows.npz"
    assert jhr.main(["--windows", "1", "--policy", str(path), "--save", str(saved)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with np.load(saved) as z:
        assert {k: z[k].shape for k in z.files} == {
            "beam_boards": (8, 20, 10), "beam_pieces": (8, 9),
            "carve_boards": (8, 20, 10), "carve_pieces": (8, 9),
            "host_boards": (res["host"]["rows"], 20, 10),
            "host_pieces": (res["host"]["rows"], 9)}
        # the saved host rows begin with the port's own, seed for seed
        n = res["own_host_rows"]
        assert (z["host_pieces"][:n] == hold.pieces[:n].numpy()).all()
    assert res["own_host_rows_are_jax_first_host_rows"]
    assert res["own_host_rows"] == hold.provenance["host_forward"]
    assert res["beam"]["rows"] == 8 and res["carve"]["rows"] == 8
    n_host = res["host"]["rows"]
    assert res["host"]["per_window"] == [n_host] and n_host >= res["own_host_rows"]
    by = res["jax_bank_forward_by_host_rows"]
    assert [(b["seeds"], b["host_rows"]) for b in by] == [(0, 0), (100, min(n_host, 8))]
    assert by[0]["forward_win_fraction"] == res["beam"]["won"] / 8
    assert all(0.0 <= b["forward_win_fraction"] <= 1.0 for b in by)
