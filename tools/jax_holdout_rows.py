"""The port's flagship policy on the JAX package's own held-out rows.

    JAX_PLATFORMS=cpu python3 tools/jax_holdout_rows.py [--windows 4]
        [--policy NPZ] [--save NPZ]

JAX's held-out reading of a flagship checkpoint (``cli eval --eval-holdout
--holdout-bank 2048``) builds its bank with ``gen/bank.py::
make_holdout_bank``: forward rows from the host DFS solver on seeds
100000, 100100, ... for as long as its 120 s budget lasts, then the first
winners of the device beam prover under the key of seed 1000003, then
device carves. Only the budget depends on the machine, so JAX's forward
rows for a host that proved h of them are its first h host rows and its
first 1024 - h beam rows. This tool builds them with the JAX package on the
CPU: ``make_holdout_bank`` with no host seeds (the beam rows, in order, and
the carves), and the host loop of ``make_holdout_bank`` over ``--windows``
windows of 100 seeds (its host rows, in order). It checks that the
policy file's own host rows are JAX's first host rows, plays the port's
policy (``--policy``, by default the 100k one) once on every row (greedy,
on the bitboard, CPU), and prints one JSON line: rows won per part, and
the forward win fraction of JAX's bank for each host count h that a whole
number of windows gives (0 included). Runs on the CPU; minutes, most of
them the host DFS. ``--save`` writes the rows themselves to a compressed
numpy file (``beam_``, ``carve_`` and ``host_`` ``boards`` bool[n, 20, 10]
and ``pieces`` int8[n, M+1], each part in JAX's order), so that a machine
without JAX can play them: ``tools/learning_check.py`` reads
``results/jax_holdout_rows_L5M25.npz``, written by ``--windows 3 --save``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

POLICY = ROOT / "results" / "flagship_L5M25_100k_h100_policy.npz"
L, M, CAPACITY = 5, 25, 2048
HOLDOUT_SEED, FORWARD_SEED_START = 1_000_003, 100_000  # make_holdout_bank's


def jax_rows(windows: int) -> dict:
    """JAX's held-out rows: the beam rows and carves of a bank built with
    no host seeds, and the host rows of ``windows`` windows in order
    (``make_holdout_bank``'s host loop, its translation draws included)."""
    from tetris_piclim_tpu.gen.bank import (
        FAMILY_FORWARD, ConfigBank, make_holdout_bank,
    )
    from tetris_piclim_tpu.gen.pipeline import generate_batch, translate_batch

    t0 = time.perf_counter()
    beam = make_holdout_bank(L, M, capacity=CAPACITY, seed=HOLDOUT_SEED,
                             forward_seed_budget=0)
    fwd = beam._family == FAMILY_FORWARD
    boards = np.asarray(beam.boards).astype(bool)  # bool[B, 20, 10]
    pieces = np.asarray(beam.pieces).astype(np.int8)
    device_s = time.perf_counter() - t0
    rng = ConfigBank(L, M, capacity=CAPACITY, seed=HOLDOUT_SEED)._rng
    host = []
    for s in range(FORWARD_SEED_START, FORWARD_SEED_START + 100 * windows, 100):
        games = generate_batch(L, M, seed_start=s, seed_end=s + 100)
        rows = translate_batch(games, M, rng=rng, parity=False)
        host.append([(np.asarray(b, dtype=bool),
                      np.asarray((p + [0] * (M + 1))[:M + 1], dtype=np.int8))
                     for b, p in rows])
    return {"beam": (boards[fwd], pieces[fwd]), "carve": (boards[~fwd], pieces[~fwd]),
            "host_windows": host, "device_s": device_s,
            "host_s": time.perf_counter() - t0 - device_s}


def play(net, boards: np.ndarray, pieces: np.ndarray) -> np.ndarray:
    """bool[n]: each row's greedy episode won, on the port's bitboard."""
    import torch

    from tetris_piclim_tpu_torch.dqn import agent
    from tetris_piclim_tpu_torch.ops import bitboard as bb

    with torch.no_grad():
        env = bb.make_state_batch(bb.pack_board(torch.as_tensor(boards)),
                                  torch.as_tensor(pieces), L, M)
        return (agent.greedy_rollout(net, env, M + 1, bb).status == 1).numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--windows", type=int, default=4,
                   help="windows of 100 host seeds to prove")
    p.add_argument("--policy", default=str(POLICY))
    p.add_argument("--save", metavar="NPZ", help="write JAX's held-out rows here")
    a = p.parse_args(argv)

    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.ops.bitboard import unpack_board
    from tetris_piclim_tpu_torch.utils.checkpoint import read_policy_npz

    pol = read_policy_npz(a.policy)
    net = ConvQNetwork(channels=tuple(pol["meta"]["net"]["channels"]),
                       dueling=True, joint=True)
    net.load_state_dict(pol["net"])
    net.eval()
    rows = jax_rows(a.windows)
    host = [r for w in rows["host_windows"] for r in w]
    if a.save:
        np.savez_compressed(
            a.save, beam_boards=rows["beam"][0], beam_pieces=rows["beam"][1],
            carve_boards=rows["carve"][0], carve_pieces=rows["carve"][1],
            host_boards=np.array([b for b, _ in host], bool).reshape(-1, 20, 10),
            host_pieces=np.array([q for _, q in host], np.int8).reshape(-1, M + 1))
    # the policy file's own host rows: the port's host loop, seed for seed
    n_own = pol["meta"]["eval"]["holdout"]["build"]["host_forward"]
    own = pol["banks"]["holdout"]
    own_boards = unpack_board(own.cols[:n_own]).numpy()
    own_pieces = own.pieces[:n_own].numpy()
    same_host = len(host) >= n_own and all(
        np.array_equal(own_boards[i], host[i][0])
        and np.array_equal(own_pieces[i], host[i][1]) for i in range(n_own))
    won_beam = play(net, *rows["beam"])
    won_carve = play(net, *rows["carve"])
    won_host = (play(net, np.stack([b for b, _ in host]), np.stack([q for _, q in host]))
                if host else np.zeros(0, bool))
    n_fwd = CAPACITY // 2
    by_host, h = [], 0
    for i, w in enumerate([[]] + rows["host_windows"]):
        h = min(h + len(w), n_fwd)
        won = int(won_host[:h].sum()) + int(won_beam[:n_fwd - h].sum())
        by_host.append({"seeds": 100 * i, "host_rows": h,
                        "forward_win_fraction": won / n_fwd})
    print(json.dumps({
        "tool": "jax_holdout_rows", "policy": os.path.relpath(a.policy, ROOT),
        "step": pol["meta"]["step"], "task": f"L={L},M={M}",
        "own_host_rows": n_own, "own_host_rows_are_jax_first_host_rows": bool(same_host),
        "beam": {"rows": int(won_beam.size), "won": int(won_beam.sum())},
        "carve": {"rows": int(won_carve.size), "won": int(won_carve.sum())},
        "host": {"rows": int(won_host.size), "won": int(won_host.sum()),
                 "per_window": [len(w) for w in rows["host_windows"]]},
        "jax_bank_forward_by_host_rows": by_host,
        "device_s": rows["device_s"], "host_s": rows["host_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
