"""Port host forward pipeline, forward-family bank and held-out bank.

The host generator, the DFS solver, ``generate_batch`` and
``translate_batch`` are seed-exact copies: they must give the JAX package's
games for the same seeds and ``random.Random`` streams, and so must the
host-forward rows of ``make_holdout_bank``. Then the port's versions of
tests/test_holdout.py's checks (disjointness, both families, collision
replacement, subsets, evaluation on the holdout), the device fallback of
the holdout's forward rows, the forward share of ``fill_device`` /
``refresh_device``, the bank's families through a checkpoint, and CPU
smokes of ``train`` / ``eval`` with the forward bank and the holdout."""

import random

import numpy as np
import pytest
import torch

from tetris_piclim_tpu import tables as jtables
from tetris_piclim_tpu.gen import bank as jbank
from tetris_piclim_tpu.gen import forward as jforward
from tetris_piclim_tpu.gen import pipeline as jpipeline
from tetris_piclim_tpu.gen import solver as jsolver
from tetris_piclim_tpu_torch import cli, tables
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer, height_at
from tetris_piclim_tpu_torch.gen import forward, pipeline, solver
from tetris_piclim_tpu_torch.gen.bank import (
    FAMILY_CARVE, FAMILY_FORWARD, ConfigBank, make_holdout_bank,
)
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from tetris_piclim_tpu_torch.utils.checkpoint import restore_bank, save_bank
from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("L,M", [(1, 8), (2, 20)])
def test_host_forward_pipeline_matches_jax(L, M):
    assert tables.PIECE_IDS == jtables.PIECE_IDS
    assert tables.GEN_NAME_ORDER == jtables.GEN_NAME_ORDER
    for name, shapes in jtables.GEN_SHAPES.items():
        for got, want in zip(tables.GEN_SHAPES[name], shapes, strict=True):
            np.testing.assert_array_equal(got, want)
    seeds = range(100_000, 100_020)
    for s in seeds:
        g = forward.ForwardGenerator(seed=s, goal=L, num_pieces=M,
                                     initial_height_max=4)
        j = jforward.ForwardGenerator(seed=s, goal=L, num_pieces=M,
                                      initial_height_max=4)
        np.testing.assert_array_equal(g.board, j.board)
        assert g.sequence == j.sequence
        got = solver.GreedyDFSSolver(g.board, g.sequence, L, 1000).solve()
        want = jsolver.GreedyDFSSolver(j.board, j.sequence, L, 1000).solve()
        assert got == want
    got = pipeline.generate_batch(L, M, seeds.start, seeds.stop)
    want = jpipeline.generate_batch(L, M, seeds.start, seeds.stop)
    assert [g.seed for g in got] == [g.seed for g in want] and got
    rows = pipeline.translate_batch(got, M, rng=random.Random(5), parity=False)
    jrows = jpipeline.translate_batch(want, M, rng=random.Random(5), parity=False)
    for (b, p), (jb, jp) in zip(rows, jrows, strict=True):
        np.testing.assert_array_equal(b, jb)
        assert p == jp and len(p) == M + 1


@pytest.fixture(scope="module")
def train_bank():
    return ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device(
        forward_fraction=0.25)


@pytest.fixture(scope="module")
def holdout(train_bank):
    return make_holdout_bank(1, 8, capacity=16, train_bank=train_bank,
                             forward_seed_budget=100, device="cpu")


def test_holdout_host_forward_rows_match_jax(holdout):
    want = jbank.make_holdout_bank(1, 8, capacity=16, forward_seed_budget=100)
    fwd = np.asarray(want._family) == jbank.FAMILY_FORWARD
    assert fwd.sum() == 8
    np.testing.assert_array_equal(holdout.family, np.asarray(want._family))
    got_boards = tbb.unpack_board(holdout.cols).numpy()
    np.testing.assert_array_equal(got_boards[fwd], np.asarray(want._host_boards)[fwd])
    np.testing.assert_array_equal(holdout.pieces.numpy()[fwd],
                                  np.asarray(want._host_pieces)[fwd])


def test_holdout_disjoint_with_both_families(train_bank, holdout):
    assert not (holdout.row_keys() & train_bank.row_keys())
    assert len(holdout.row_keys()) == holdout.capacity
    assert holdout.family_counts == {"carve": 8, "forward": 8}
    boards = tbb.unpack_board(holdout.cols).numpy()
    assert not boards.all(axis=2).any() and not boards[:, :8].any()


def test_holdout_family_subsets(holdout):
    carve = holdout.subset(FAMILY_CARVE)
    fwd = holdout.subset(FAMILY_FORWARD)
    assert carve.capacity + fwd.capacity == holdout.capacity
    assert (carve.family == FAMILY_CARVE).all() and (fwd.family == FAMILY_FORWARD).all()
    assert not (carve.row_keys() & fwd.row_keys())
    assert carve.row_keys() | fwd.row_keys() == holdout.row_keys()


def test_holdout_collision_replacement():
    a = make_holdout_bank(1, 8, capacity=8, forward_fraction=0.0, seed=7,
                          device="cpu")
    b = make_holdout_bank(1, 8, capacity=8, train_bank=a, forward_fraction=0.0,
                          seed=7, device="cpu")
    assert not (a.row_keys() & b.row_keys())
    assert len(b.row_keys()) == 8


def test_holdout_device_forward_fallback():
    """No host seeds: the forward half comes from the device beam prover
    (at L=10/M=30 the host DFS yields nothing in any realistic budget)."""
    train = ConfigBank(10, 30, capacity=16, seed=0, device="cpu").fill_device()
    hold = make_holdout_bank(10, 30, capacity=16, train_bank=train,
                             forward_seed_budget=0, device="cpu")
    assert hold.family_counts == {"carve": 8, "forward": 8}
    assert not (hold.row_keys() & train.row_keys())
    boards = tbb.unpack_board(hold.cols[:8]).numpy()
    padded = np.concatenate([boards, np.ones((8, 1, 10), bool)], axis=1)
    assert (20 - np.argmax(padded, axis=1)).max() <= 4  # prefill height cap


def test_fill_and_refresh_with_forward_share(tmp_path):
    bank = ConfigBank(2, 20, capacity=64, seed=0, device="cpu").fill_device(
        forward_fraction=0.25)
    assert (bank.family[:16] == FAMILY_FORWARD).all()
    assert (bank.family[16:] == FAMILY_CARVE).all()
    seqs = bank.pieces[:16].numpy()
    for k in range(3):  # forward rows hold 7-bag sequences
        assert (np.sort(seqs[:, 7 * k:7 * k + 7], axis=1) == np.arange(7)).all()
    # a carve-only refresh keeps the forward rows
    cols, pieces = bank.cols.clone(), bank.pieces.clone()
    bank.refresh_device(seed=3)
    assert torch.equal(bank.cols[:16], cols[:16])
    assert torch.equal(bank.pieces[:16], pieces[:16])
    assert not torch.equal(bank.pieces[16:], pieces[16:])
    assert bank.family_counts == {"carve": 48, "forward": 16}
    # a forward refresh regenerates the whole bank
    bank.refresh_device(seed=4, forward_fraction=0.5, beam_width=4)
    assert bank.family_counts["forward"] >= 31
    assert not torch.equal(bank.pieces[:16], pieces[:16])
    # the families survive a checkpoint
    save_bank(str(tmp_path), bank)
    back = restore_bank(str(tmp_path), "cpu")
    np.testing.assert_array_equal(back.family, bank.family)
    assert torch.equal(back.cols, bank.cols) and torch.equal(back.pieces, bank.pieces)


def test_restore_bank_without_family_gives_carve_rows(tmp_path):
    bank = ConfigBank(1, 8, capacity=8, seed=0, device="cpu").fill_device()
    torch.save({"cols": bank.cols, "pieces": bank.pieces, "L": 1, "M": 8},
               str(tmp_path / "bank.pt"))
    back = restore_bank(str(tmp_path), "cpu")
    assert back.family_counts == {"carve": 8, "forward": 0}
    assert torch.equal(back.cols, bank.cols) and torch.equal(back.pieces, bank.pieces)


def test_trainer_refreshes_forward_bank_and_evaluates_holdout(train_bank, holdout):
    assert [height_at((8, 4), s, 100) for s in (0, 50, 100)] == [8, 6, 4]
    assert height_at(None, 10, 100) == 4
    cfg = TrainConfig(env=EnvConfig(L=1, M=8), num_envs=16, bank_capacity=16,
                      replay_capacity=512, warmup_steps=8, total_steps=16,
                      log_every=8, actor_fusion=4, seed=0)
    bank = ConfigBank.from_rows(1, 8, train_bank.cols, train_bank.pieces,
                                train_bank.family)
    trainer = DQNTrainer(cfg, bank=bank, device="cpu")
    trainer.train(log_fn=None, device_refresh_every=1,
                  device_forward_fraction=0.25, device_beam_width=4,
                  device_height=(6, 4))
    assert trainer.bank.family_counts["forward"] == 4
    assert not torch.equal(trainer.bank.cols, train_bank.cols)
    for bank in (None, holdout, holdout.subset(FAMILY_CARVE),
                 holdout.subset(FAMILY_FORWARD)):
        ev = trainer.evaluate(n_episodes=64, bank=bank)
        assert ev["unfinished"] == 0.0 and 0.0 <= ev["win_rate"] <= 1.0


def _families_reported(out: str, first: str) -> None:
    import json

    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == {first, "holdout", "holdout_carve", "holdout_forward"}
    assert res["holdout"]["families"] == {"carve": 16, "forward": 16}
    assert all(res[k]["unfinished"] == 0.0 for k in res)


def test_cli_train_smoke_forward_bank_holdout(capsys):
    assert cli.main(["train", "--smoke", "--device", "cpu", "--device-bank",
                     "--device-forward", "0.25", "--device-refresh", "1",
                     "--eval-holdout", "--holdout-bank", "32",
                     "--eval-episodes", "64"]) == 0
    _families_reported(capsys.readouterr().out, "train_bank")


def test_cli_eval_forward_bank_holdout(capsys):
    assert cli.main(["eval", "--device", "cpu", "-L", "1", "-M", "8",
                     "--bank", "64", "--device-bank", "--device-forward", "0.25",
                     "--eval-holdout", "--holdout-bank", "32",
                     "--episodes", "64"]) == 0
    _families_reported(capsys.readouterr().out, "bank")
