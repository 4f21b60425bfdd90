"""The port's tools run end to end at tiny sizes on the CPU:
``tools/holdout_rows.py`` (every held-out row of a policy file played once,
and each policy on every reading's rows). The numbers are CPU numbers and
mean nothing; the shapes of the results are checked."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


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
