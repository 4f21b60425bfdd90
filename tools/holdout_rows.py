"""Every held-out row of a carried flagship policy played once.

    python3 tools/holdout_rows.py [NPZ ...] [--device cpu|cuda]

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
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tetris_piclim_tpu_torch.dqn import agent  # noqa: E402
from tetris_piclim_tpu_torch.gen.bank import FAMILY_CARVE, FAMILY_FORWARD  # noqa: E402
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork  # noqa: E402
from tetris_piclim_tpu_torch.ops import bitboard as bb  # noqa: E402
from tetris_piclim_tpu_torch.utils.checkpoint import read_policy_npz  # noqa: E402

POLICIES = (ROOT / "results" / "flagship_L5M25_h100_policy.npz",
            ROOT / "results" / "flagship_L5M25_100k_h100_policy.npz")


def rows_won(path: Path, device: torch.device) -> dict:
    pol = read_policy_npz(str(path), device)
    meta, hold = pol["meta"], pol["banks"]["holdout"]
    net = ConvQNetwork(**{k: (tuple(v) if k == "channels" else v)
                          for k, v in meta["net"].items() if k != "model"})
    net.load_state_dict(pol["net"])
    net = net.to(device).eval()
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
    out = {"policy": os.path.relpath(path, ROOT), "step": meta["step"],
           "device": str(device)}
    for name, mask in parts.items():
        n = int(mask.sum())
        k = int((won & mask).sum())
        out[name] = {"rows": n, "won": k, "win_fraction": k / n if n else None}
    ev = meta["eval"]
    out["recorded_8192_episodes"] = {
        "all": ev["holdout"]["win_rate"], "carve": ev["holdout_carve"]["win_rate"],
        "forward": ev["holdout_forward"]["win_rate"],
        "forward_by_provenance": meta.get("forward_by_provenance")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("policies", nargs="*", default=[str(x) for x in POLICIES])
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    with torch.no_grad():
        for path in a.policies:
            print(json.dumps(rows_won(Path(path).resolve(), dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
