"""Port host generators against the JAX package, word for word.

The host carver, the ``max_attempts`` tuner, ``translate_batch`` in both
parity modes, the host bank fill (and the trainer's default bank) and the
refresh's target rows are pure Python ``random`` / numpy ``Generator`` code
in both packages, so the same seeds must give the same integers: every
comparison here is exact. Then the asynchronous refresh: producers feed the
live bank, a killed producer is restarted, and shutdown leaves no process;
those scenarios run in a subprocess under a timeout, so a hang fails one
test instead of stalling a test worker."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tetris_piclim_tpu.gen import bank as jbank
from tetris_piclim_tpu.gen import carver as jcarver
from tetris_piclim_tpu.gen import minimize as jminimize
from tetris_piclim_tpu.gen import pipeline as jpipeline
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen import bank as tbank
from tetris_piclim_tpu_torch.gen import carver, minimize, pipeline
from tetris_piclim_tpu_torch.gen.bank import FAMILY_CARVE, FAMILY_FORWARD, ConfigBank
from tetris_piclim_tpu_torch.ops.bitboard import unpack_board
from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def assert_banks_equal(tb: ConfigBank, jb) -> None:
    """Port bank rows, families and writes == the JAX bank's (exact)."""
    np.testing.assert_array_equal(unpack_board(tb.cols).numpy(), np.asarray(jb.boards))
    np.testing.assert_array_equal(tb.pieces.numpy(), np.asarray(jb.pieces))
    np.testing.assert_array_equal(tb.family, jb._family)
    assert tb.refresh_writes == jb.refresh_writes


@pytest.mark.parametrize("L,M", [(1, 8), (3, 12), (2, 20)])
@pytest.mark.parametrize("record", [False, True], ids=["plain", "solution"])
def test_carver_matches_jax(L, M, record):
    for seed in range(6):
        frames, jframes = [], []
        got = carver.CarvingGenerator(
            L, M, rng=random.Random(seed), record_solution=record,
            render_fn=lambda b: frames.append(b.copy())).generate()
        want = jcarver.CarvingGenerator(
            L, M, rng=random.Random(seed), record_solution=record,
            render_fn=lambda b: jframes.append(b.copy())).generate()
        assert len(got) == len(want) == (3 if record else 2)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and len(got[1]) == M + 1
        if record:
            assert got[2] == want[2] and 0 < len(got[2]) <= M
        assert len(frames) == len(jframes) > 0
        for a, b in zip(frames, jframes):
            np.testing.assert_array_equal(a, b)


def test_minimize_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        stats = [{"solvable": bool(s), "failed_attempts": int(f)}
                 for s, f in zip(rng.random(30) < 0.6, rng.integers(0, 40, 30))]
        assert (minimize.minimize_max_attempts(stats)
                == jminimize.minimize_max_attempts(stats))
    assert minimize.minimize_max_attempts([]) == 0
    kw = dict(probe_seeds=8, probe_max_attempts=30)
    assert (minimize.probe_and_tune(1, 8, **kw)
            == jminimize.probe_and_tune(1, 8, **kw))


@pytest.fixture(scope="module")
def games():
    """Proven L=1/M=8 games of seeds 0..9 from both packages' pipelines."""
    got = pipeline.generate_batch(1, 8, 0, 10)
    want = jpipeline.generate_batch(1, 8, 0, 10)
    assert [g.seed for g in got] == [g.seed for g in want] and got
    return got, want


@pytest.mark.parametrize("parity", [True, False])
def test_translate_batch_parity_modes(games, parity):
    got = pipeline.translate_batch(games[0], 8, rng=random.Random(7), parity=parity)
    want = jpipeline.translate_batch(games[1], 8, rng=random.Random(7), parity=parity)
    for (b, p), (jb, jp) in zip(got, want, strict=True):
        np.testing.assert_array_equal(b, jb)
        assert p == jp and len(p) == 9
    # the default is the reference's prepended piece, as in JAX
    default = pipeline.translate_batch(games[0], 8, rng=random.Random(7))
    prepended = pipeline.translate_batch(games[0], 8, rng=random.Random(7), parity=True)
    assert [p for _, p in default] == [p for _, p in prepended]


@pytest.mark.parametrize("carve_fraction,parity,budget", [
    (0.75, False, 10_000), (0.5, True, 10_000), (0.25, False, 100)],
    ids=["mixed", "parity", "shortfall"])
def test_fill_rows_and_families_match_jax(monkeypatch, games, carve_fraction,
                                          parity, budget):
    """``fill`` with both pipelines stubbed to the same 10 proven games per
    window: row for row, and the forward shortfall (a 100-seed budget gives
    10 forward rows) carved."""
    monkeypatch.setattr(tbank, "generate_batch", lambda *a, **k: games[0])
    monkeypatch.setattr(jbank, "generate_batch", lambda *a, **k: games[1])
    kw = dict(capacity=24, seed=3, parity_translate=parity)
    tb = ConfigBank(1, 8, device="cpu", **kw).fill(carve_fraction, forward_seed_budget=budget)
    jb = jbank.ConfigBank(1, 8, **kw).fill(carve_fraction, forward_seed_budget=budget)
    assert_banks_equal(tb, jb)
    n_fwd = min(24 - int(24 * carve_fraction), 10 * (budget // 100))
    assert tb.family_counts == {"carve": 24 - n_fwd, "forward": n_fwd}
    # the bank's host streams are left where JAX leaves them
    assert tb._rng.random() == jb._rng.random()


def test_trainer_default_bank_is_jax_fill():
    """No bank passed: the trainer fills ``fill(carve_fraction=0.75)`` on the
    host, the JAX trainer's default, with the real forward pipeline."""
    cfg = TrainConfig(env=EnvConfig(L=1, M=8), num_envs=8, bank_capacity=16,
                      replay_capacity=256, warmup_steps=4, total_steps=4,
                      log_every=4, seed=0)
    assert cfg.bank_carve_fraction == 0.75
    tr = DQNTrainer(cfg, device="cpu")
    jb = jbank.ConfigBank(1, 8, capacity=16, seed=0).fill(carve_fraction=0.75)
    assert_banks_equal(tr.bank, jb)
    assert tr.bank.family_counts == {"carve": 12, "forward": 4}


def test_swap_rows_targets_match_jax(monkeypatch, games):
    """``_swap_rows``' family-aware targets, drawn with the bank's numpy
    generator, and the rows written: carve writes replace carve rows only,
    forward writes grow to the cap and then recycle forward rows, and a
    batch larger than its pool draws with replacement (last write wins)."""
    monkeypatch.setattr(tbank, "generate_batch", lambda *a, **k: games[0])
    monkeypatch.setattr(jbank, "generate_batch", lambda *a, **k: games[1])
    kw = dict(capacity=16, seed=5, forward_share_cap=0.25)
    tb = ConfigBank(1, 8, device="cpu", **kw).fill(1.0)
    jb = jbank.ConfigBank(1, 8, **kw).fill(1.0)
    rng = np.random.default_rng(1)
    for family, n in [(FAMILY_FORWARD, 3), (FAMILY_FORWARD, 2), (FAMILY_CARVE, 5),
                      (FAMILY_FORWARD, 9), (FAMILY_CARVE, 20), (FAMILY_FORWARD, 1)]:
        fresh = [(rng.random((20, 10)) < 0.2, list(rng.integers(0, 7, 9 + k % 2)))
                 for k in range(n)]
        before = tb.family.copy()
        tb._swap_rows(fresh, family)
        jb._swap_rows(fresh, family)
        assert_banks_equal(tb, jb)
        if family == FAMILY_CARVE:
            assert (tb.family[before == FAMILY_FORWARD] == FAMILY_FORWARD).all()
    # 3, then 2 more while under the cap of 4 rows (0.25 * 16); recycled after
    assert tb.family_counts["forward"] == 5


_REFRESH_SCRIPT = r"""
import json, multiprocessing, sys, time
sys.path.insert(0, sys.argv[1])
from tetris_piclim_tpu_torch.gen.bank import ConfigBank

bank = ConfigBank(1, 8, capacity=32, seed=1, device="cpu").fill_device()
out = {"start": bank.family_counts}
bank.start_refresh(n_threads=1, batch_per_cycle=4)
try:
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not (
            bank.family_counts["forward"] > 0 and bank.refresh_writes > 0):
        time.sleep(0.1)
    out["fed"] = [bank.family_counts, bank.refresh_writes]
    victim = bank._pool.slots[0][0]
    victim.terminate()
    victim.join(timeout=10)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not (
            bank._pool.slots[0][0].pid != victim.pid and bank._pool.slots[0][0].is_alive()):
        time.sleep(0.1)
    writes = bank.refresh_writes
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and bank.refresh_writes == writes:
        time.sleep(0.1)
    out["restarted"] = [bank._pool.slots[0][0].pid != victim.pid, bank._pool.restarts,
                        bank.refresh_writes > writes]
    procs = [p for p, _ in bank._pool.slots]
finally:
    bank.stop_refresh()
out["alive"] = [p.is_alive() for p in procs] + [len(multiprocessing.active_children())]
cols, pieces = bank.rows
out["shapes"] = [list(cols.shape), list(pieces.shape), int(pieces.min()), int(pieces.max())]
print(json.dumps(out))
"""


def test_refresh_feeds_bank_restarts_and_stops():
    out = subprocess.run([sys.executable, "-c", _REFRESH_SCRIPT, str(ROOT)],
                         capture_output=True, text=True, timeout=150,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["start"] == {"carve": 32, "forward": 0}
    fams, writes = res["fed"]
    assert fams["forward"] > 0 and writes > 0, res
    assert res["restarted"][0] and res["restarted"][1] >= 1 and res["restarted"][2], res
    assert not any(res["alive"]), res
    shape_cols, shape_pieces, lo, hi = res["shapes"]
    assert shape_cols == [32, 10] and shape_pieces == [32, 9] and 0 <= lo <= hi <= 6


def test_cli_config_merges_changed_flags(tmp_path):
    """``train --config``: the JSON, with every flag the user changed from
    its default laid over it (JAX ``cli.py:100-135``); flags left at their
    defaults do not override the file."""
    from tetris_piclim_tpu_torch import cli
    from tetris_piclim_tpu_torch.utils.config import DQNConfig

    path = tmp_path / "cfg.json"
    path.write_text(TrainConfig(env=EnvConfig(L=3, M=11), dqn=DQNConfig(batch_size=64),
                                num_envs=32, bank_capacity=48, total_steps=500,
                                demo_every=7).to_json())
    args = cli.build_parser().parse_args(
        ["train", "--config", str(path), "--no-double", "--steps", "77", "--lr", "3e-4",
         "-M", "13"])
    cfg = cli._config(args)
    assert (cfg.env.L, cfg.env.M) == (3, 13)
    assert (cfg.dqn.batch_size, cfg.dqn.double_dqn, cfg.dqn.lr) == (64, False, 3e-4)
    assert (cfg.num_envs, cfg.bank_capacity, cfg.total_steps, cfg.demo_every) == \
        (32, 48, 77, 7)
    assert cli._config(cli.build_parser().parse_args(
        ["train", "--config", str(path)])) == TrainConfig.from_json(path.read_text())
