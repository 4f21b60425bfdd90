"""Port single-env API, solver display, CLI ``generate`` / ``play`` and
``bench`` against the JAX package.

Cold ``Tetris(seed)`` draws its configuration from the seed-exact host
carver, so board, pieces and recorded solution equal the JAX package's;
moves (garbage ones too), parity quirks and the ASCII frames are compared
step by step, exactly. The warm reset's producer processes, their restart
and the fail-fast end of the restarts run in a subprocess under a timeout.
``generate`` and ``play`` print the JAX CLI's JSON; ``bench`` runs small."""

import argparse
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tetris_piclim_tpu import cli as jcli
from tetris_piclim_tpu import env_api as jenv
from tetris_piclim_tpu.gen import pipeline as jpipeline
from tetris_piclim_tpu.gen import solver as jsolver
from tetris_piclim_tpu_torch import bench, cli, engine, env_api
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen import pipeline, solver
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def assert_same_env(t, j):
    np.testing.assert_array_equal(t.board, j.board)
    assert (t.pieces, t.lines_cleared, t.moves_used, t.state) == \
        (j.pieces, j.lines_cleared, j.moves_used, j.state)


@pytest.mark.parametrize("L,M", [(1, 8), (3, 12), (2, 20)])
def test_cold_tetris_matches_jax(L, M):
    rng = random.Random(11)
    for seed in range(4):
        t = env_api.Tetris(L, M, warm_reset=False, debug=True, seed=seed)
        j = jenv.Tetris(L, M, warm_reset=False, debug=True, seed=seed)
        assert t.solution == j.solution and len(t.pieces) == M + 1
        assert_same_env(t, j)
        for rot, loc in t.solution:  # the recorded solution wins
            t.move(rot, loc)
            j.move(rot, loc)
            assert_same_env(t, j)
        assert t.state is True
        for _ in range(2):  # then reset and garbage moves to the end
            t.reset()
            j.reset()
            assert t.solution == j.solution
            while t.state is None and t.pieces:
                rot, loc = rng.randint(-2, 9), rng.randint(-4, 14)
                t.move(rot, loc)
                j.move(rot, loc)
                assert_same_env(t, j)
                assert t.get_state()[1:] == j.get_state()[1:]
        t.terminate()
        j.terminate()


def test_host_move_matches_jax_on_random_boards():
    rng = np.random.default_rng(0)
    for _ in range(300):
        board = rng.random((20, 10)) < rng.uniform(0.05, 0.6)
        board[board.all(axis=1)] = False
        jb = board.copy()
        args = (int(rng.integers(0, 7)), int(rng.integers(-3, 40)), int(rng.integers(-5, 15)))
        assert env_api.host_move(board, *args) == jenv.host_move(jb, *args)
        np.testing.assert_array_equal(board, jb)


def test_parity_quirks():
    for cls in (env_api.Tetris, jenv.Tetris):
        t = cls(1, 5, warm_reset=False, parity=True, seed=2)
        while t.state is None:
            t.move(0, 0)
        counters = (t.lines_cleared, t.moves_used, t.state)
        t.reset()  # the reference's reset() keeps the counters
        assert (t.lines_cleared, t.moves_used, t.state) == counters
        t = cls(1, 3, warm_reset=False, parity=True, seed=3)
        for _ in range(3):
            t.move(0, 0)
        with pytest.raises(IndexError):
            t.get_state()
        t = cls(1, 3, warm_reset=False, seed=3)
        for _ in range(4):
            t.move(0, 0)
        assert t.get_state()[1:3] == (0, 0)  # clamped, no IndexError
        t.reset()
        assert (t.lines_cleared, t.moves_used, t.state) == (0, 0, None)


def test_ascii_render_matches_jax(capsys):
    outs = []
    for cls in (env_api.Tetris, jenv.Tetris):
        t = cls(2, 10, warm_reset=False, render=True, seed=4)  # frames while carving
        assert not t.warm_reset
        t.move(1, 3)
        t.render_frame(t.board)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    frames = outs[0].split("-" * 10 + "\n")
    assert len(frames) > 3 and all(len(f.splitlines()) == 20 for f in frames[:-1])


def test_play_obs_matches_engine_observe():
    """The observation ``play --policy greedy`` builds from ``get_state()``
    is the array engine's at every non-terminal step."""
    for seed in range(4):
        t = env_api.Tetris(3, 12, warm_reset=False, debug=True, seed=seed)
        s = engine.make_state(t.board, np.array(t._pieces_full), 3, 12)
        for rot, loc in list(t.solution):
            board, cur, nxt, lines_left, moves_left, _ = t.get_state()
            oh = np.zeros(14, np.float32)
            oh[cur] = 1.0
            oh[7 + nxt] = 1.0
            host = np.concatenate([board.astype(np.float32).reshape(-1), oh,
                                   np.array([lines_left, moves_left, 0.0], np.float32)])
            np.testing.assert_array_equal(host, engine.observe(s)[0].numpy())
            t.move(rot, loc)
            s = engine.step(s, torch.tensor([rot]), torch.tensor([loc])).state


def test_solver_display_matches_jax():
    g = pipeline.generate_batch(2, 12, 0, 4)[0]
    jg = jpipeline.generate_batch(2, 12, 0, 4)[0]
    s = solver.GreedyDFSSolver(g.board, g.sequence, 2)
    js = jsolver.GreedyDFSSolver(jg.board, jg.sequence, 2)
    ok, stack, _ = s.solve()
    assert ok and js.solve()[1] == stack
    assert s.visualize() == js.visualize() and s.visualize(g.board) == js.visualize(jg.board)
    got, want = [], []
    assert s.visualize_moves(stack, got.append) == js.visualize_moves(stack, want.append) >= 2
    assert got == want and len(got) == 3 * len(stack)


_WARM_SCRIPT = r"""
import json, multiprocessing, sys
sys.path.insert(0, sys.argv[1])
from tetris_piclim_tpu_torch.env_api import Tetris

out = {}
with Tetris(1, 8, warm_reset=True, seed=3) as t:
    out["first"] = [list(t.board.shape), int(t.board[-1].sum()), len(t.pieces)]
    t.move(0, 0)
    t.reset()
    out["reset"] = [t.moves_used, t.state, len(t.pieces)]
    rounds = []
    for _ in range(6):  # kill every producer; reset restarts them
        for proc, _r in list(t._pool.slots):
            proc.terminate()
            proc.join(timeout=10)
        try:
            t.reset()
            rounds.append(["ok", t._pool.restarts, len(t.pieces)])
        except RuntimeError as e:
            rounds.append(["failed fast", t._pool.restarts, "restarts" in str(e)])
            break
    out["rounds"] = rounds
    workers = [p for p, _r in t._pool.slots]
out["after"] = [t._pool.slots == [], any(p.is_alive() for p in workers),
                len(multiprocessing.active_children())]
print(json.dumps(out))
"""


def test_warm_reset_restarts_and_fails_fast():
    out = subprocess.run([sys.executable, "-c", _WARM_SCRIPT, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["first"][0] == [20, 10] and res["first"][1] <= 8 and res["first"][2] == 9
    assert res["reset"] == [0, None, 9]
    # 2 producers: restarts 2, 4, then 5 (the cap), then no producer left
    assert res["rounds"] == [["ok", 2, 9], ["ok", 4, 9], ["ok", 5, 9],
                             ["failed fast", 5, True]], res
    assert res["after"] == [True, False, 0]


_GEN = dict(family="forward", seed_start=0, seed_end=100, height_max=4,
            max_attempts=1000, count=100)
_PLAY = dict(render=False, seed=0, policy="solution")


@pytest.mark.parametrize("argv,cmd,kw", [
    (["generate", "--family", "carve", "-L", "2", "-M", "10", "--count", "6"],
     "cmd_generate", {**_GEN, "family": "carve", "lines": 2, "moves": 10, "count": 6}),
    (["generate", "-L", "1", "-M", "8", "--seed-start", "3", "--seed-end", "13",
      "--height-max", "5", "--max-attempts", "50"],
     "cmd_generate", {**_GEN, "lines": 1, "moves": 8, "seed_start": 3, "seed_end": 13,
                      "height_max": 5, "max_attempts": 50}),
    (["play", "-L", "2", "-M", "10", "--seed", "3"],
     "cmd_play", {**_PLAY, "lines": 2, "moves": 10, "seed": 3}),
    (["play", "-L", "3", "-M", "12", "--seed", "5", "--policy", "random"],
     "cmd_play", {**_PLAY, "lines": 3, "moves": 12, "seed": 5, "policy": "random"}),
], ids=["carve", "forward", "solution", "random"])
def test_cli_generate_play_match_jax(capsys, argv, cmd, kw):
    """The port's CLI prints the JSON of the JAX CLI's command on the same
    flags."""
    assert cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert getattr(jcli, cmd)(argparse.Namespace(**kw)) == 0
    assert got == json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_play_greedy_from_port_checkpoint(tmp_path, capsys):
    cfg = TrainConfig(env=EnvConfig(L=1, M=8), dqn=DQNConfig(batch_size=32),
                      num_envs=16, bank_capacity=16, replay_capacity=512,
                      warmup_steps=4, total_steps=8, log_every=8, seed=0)
    bank = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
    tr = DQNTrainer(cfg, bank=bank, device="cpu")
    tr.train(log_fn=None)
    path = tr.save_checkpoint(str(tmp_path / "ck"))
    assert cli.main(["play", "-L", "1", "-M", "8", "--seed", "2", "--policy", "greedy",
                     "--checkpoint", path, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["result"] in ("win", "loss") and 0 < out["moves_used"] <= 8
    assert cli.main(["play", "--policy", "greedy", "--device", "cpu"]) == 2


def test_bench_small():
    res = bench.run(num_envs=64, steps=16, bank=16, L=1, M=8, repeats=2, device="cpu",
                    train=False)
    assert "train_mfu" not in res
    assert (res["metric"], res["unit"]) == ("env_steps_per_sec_per_chip", "steps/s")
    assert res["value"] > 0 and res["vs_baseline"] == round(res["value"] / 49_000.0, 2)
    assert res["device"] == "cpu" and len(res["repeats_s"]) == 2
