"""Every held-out row of a carried flagship policy played once.

    python3 tools/holdout_rows.py [NPZ ...] [--device cpu|cuda] [--cross]

``cli eval`` reads a held-out win rate from 8192 greedy episodes on rows
drawn with replacement (``DQNTrainer.evaluate``), so the reading carries
the noise of that draw on top of the rows'. A greedy episode is a function
of its row, so playing each row once gives the policy's win fraction on
the rows themselves. For each policy file (``tools/flagship_policy.py``;
both flagship files by default) this plays the online net greedily on
each of the 2048 carried held-out rows for M+1 steps (``agent.
greedy_rollout`` on the bitboard, finished envs frozen) and prints one
JSON line: rows won and win fraction in all, per family, and for the
forward family per provenance (the host DFS solver's rows come first, then
the device beam prover's; ``holdout.build`` in the recorded reading), beside
the recorded 8192-episode readings.

``--cross`` plays every policy on every file's held-out rows (its own and
the others'), split by that file's families and provenance, and on JAX's
own held-out rows of the task (``learning_check.play_jax_rows``); one line
per policy and row set. Two readings of two training runs hold other rows
(each held-out bank is deduplicated against its own run's training bank,
and the host DFS proves a varying number of rows in its time budget), so
only such cross-play sets two policies side by side on the same rows. Then
one ``seed_gap`` line per row set: each policy's rows won against the
first policy's, part by part (``holdout_draws.seed_gap`` on one draw), the
difference of their win fractions and the rows only one of them won.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tetris_piclim_tpu_torch.dqn import agent  # noqa: E402
from tetris_piclim_tpu_torch.gen.bank import FAMILY_CARVE, FAMILY_FORWARD  # noqa: E402
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork  # noqa: E402
from tetris_piclim_tpu_torch.ops import bitboard as bb  # noqa: E402
from tetris_piclim_tpu_torch.utils.checkpoint import read_policy_npz  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import holdout_draws as hd  # noqa: E402
from learning_check import play_jax_rows  # noqa: E402

POLICIES = (ROOT / "results" / "flagship_L5M25_h100_policy.npz",
            ROOT / "results" / "flagship_L5M25_100k_h100_policy.npz")


def policy_net(pol: dict, device: torch.device) -> ConvQNetwork:
    net = ConvQNetwork(**{k: (tuple(v) if k == "channels" else v)
                          for k, v in pol["meta"]["net"].items() if k != "model"})
    net.load_state_dict(pol["net"])
    return net.to(device).eval()


def rows_won(path: Path, device: torch.device, rows: Optional[Path] = None) -> dict:
    """The policy of ``path`` played once on each held-out row of ``rows``
    (by default its own), counted in all, per family and per provenance
    part of that file's reading; ``won`` holds each row's outcome."""
    pol = read_policy_npz(str(path), device)
    net = policy_net(pol, device)
    if rows is not None and Path(rows).resolve() != Path(path).resolve():
        pol = read_policy_npz(str(rows), device)
    meta, hold = pol["meta"], pol["banks"]["holdout"]
    L, M = meta["L"], meta["M"]
    cols, pieces = hold.rows
    env = bb.make_state_batch(cols, pieces, L, M)
    won = (agent.greedy_rollout(net, env, M + 1, bb).status == 1).cpu()
    build = meta["eval"]["holdout"]["build"]
    n_host, n_dev = build["host_forward"], build["device_forward"]
    fam = torch.as_tensor(hold.family)
    parts = {"all": torch.ones_like(won), "carve": fam == FAMILY_CARVE,
             "forward": fam == FAMILY_FORWARD,
             "forward_host_dfs": torch.arange(won.numel()) < n_host,
             "forward_device_beam": (torch.arange(won.numel()) >= n_host)
             & (torch.arange(won.numel()) < n_host + n_dev)}
    out = {"policy": os.path.relpath(path, ROOT),
           "rows_of": os.path.relpath(Path(rows or path).resolve(), ROOT),
           "step": meta["step"], "device": str(device)}
    for name, mask in parts.items():
        n = int(mask.sum())
        k = int((won & mask).sum())
        out[name] = {"rows": n, "won": k, "win_fraction": k / n if n else None}
    out["won"] = {name: won[mask].cpu().numpy() for name, mask in parts.items()}
    ev = meta["eval"]
    out["recorded_8192_episodes"] = {
        "all": ev["holdout"]["win_rate"], "carve": ev["holdout_carve"]["win_rate"],
        "forward": ev["holdout_forward"]["win_rate"],
        "forward_by_provenance": meta.get("forward_by_provenance")}
    return out


def cross_gap(results: list[dict]) -> dict:
    """Each result (one policy on one row set, as :func:`rows_won` or
    ``play_jax_rows`` give it, with ``won`` per part) against the first,
    part by part, each part one draw of ``holdout_draws.seed_gap``."""
    base = results[0]
    return {"rows_of": base["rows_of"], "base": base["policy"], "policies": {
        res["policy"]: {part: (hd.seed_gap([res["won"][part]], [b]) if b.size
                               else {"rows": 0})
                        for part, b in base["won"].items()}
        for res in results[1:]}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("policies", nargs="*", default=[str(x) for x in POLICIES])
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--cross", action="store_true",
                   help="every policy on every file's rows and on JAX's rows")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda":  # TF32 off, as the other tools play rows on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    paths = [Path(x).resolve() for x in a.policies]
    with torch.no_grad():
        if not a.cross:
            for path in paths:
                res = rows_won(path, dev)
                res.pop("won")
                print(json.dumps(res), flush=True)
            return 0
        sets = []
        for rows in paths:
            sets.append([])
            for path in paths:
                sets[-1].append(rows_won(path, dev, rows))
        jax = []
        for path in paths:
            pol = read_policy_npz(str(path), dev)
            res = play_jax_rows(policy_net(pol, dev), pol["meta"]["L"],
                                pol["meta"]["M"], dev, keep_won=True)
            if res is not None:
                jax.append({"policy": os.path.relpath(path, ROOT),
                            "rows_of": res["rows"], **res})
        if jax:
            sets.append(jax)
        for results in sets:
            for res in results:
                print(json.dumps({k: v for k, v in res.items() if k != "won"}), flush=True)
            print(json.dumps({"seed_gap": cross_gap(results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
