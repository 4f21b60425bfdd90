"""The flagship policy, carried out of a ``tools/learning_check.py --recipe
flagship`` run into one numpy file.

    python3 tools/flagship_policy.py OUT [--step N] [--out NPZ]

``OUT`` is the run's directory: its newest checkpoint ``OUT/ckpt/final``
(the train state and the live training bank) and a held-out reading of
that checkpoint, ``OUT/holdout_<step>.json`` with its rows in
``OUT/holdout_<step>/`` (the newest unless ``--step``). Writes
``--out``, by default ``results/flagship_L5M25_h100_policy.npz`` (the
175k-step policy; the unbroken 100k-step run's goes to
``results/flagship_L5M25_100k_h100_policy.npz``), with
``utils/checkpoint.py::save_policy_npz``: the online conv net's 1,681,321
float32 parameters under the port's ``state_dict`` names, the 4096
training-bank rows, the 2048 held-out rows with their family labels, and
under ``meta`` the task, the step, the run's training seed (from
``OUT/result.json``; ``cli eval`` draws its episodes from it), the net's
widths and the recorded
held-out evaluation (win rates in all, per family and on the training
bank, family counts, the rows' provenance, the forward win rate split by
provenance where the reading has it, the card). ``tests/test_torch_flagship_policy.py`` holds
it against the JAX package's conv net, and ``chip_smoke.py`` phase 19
evaluates it on the card; ``cli eval --checkpoint NPZ`` loads it. Runs on
the CPU; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

POLICY = ROOT / "results" / "flagship_L5M25_h100_policy.npz"
NET = {"model": "conv", "channels": [32, 64], "dueling": True, "joint": True}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run", help="the learning_check run's OUT directory")
    p.add_argument("--step", type=int, help="the held-out reading's step")
    p.add_argument("--out", default=str(POLICY))
    a = p.parse_args(argv)

    import torch

    from tetris_piclim_tpu_torch.utils.checkpoint import (
        read_policy_npz, restore_bank, save_policy_npz,
    )

    run = Path(a.run)
    steps = sorted(int(m.group(1)) for f in run.glob("holdout_*.json")
                   if (m := re.fullmatch(r"holdout_(\d+)\.json", f.name)))
    if not steps:
        raise SystemExit(f"no held-out reading in {run}")
    step = a.step if a.step is not None else steps[-1]
    reading = json.loads((run / f"holdout_{step}.json").read_text())
    ckpt = run / "ckpt" / "final"
    state = torch.load(ckpt / "state.pt", map_location="cpu", weights_only=True)
    if int(state["global_step"]) != step:
        raise SystemExit(f"the checkpoint is at step {state['global_step']}, "
                         f"the reading at {step}")
    train = restore_bank(str(ckpt), "cpu")
    holdout = restore_bank(str(run / f"holdout_{step}"), "cpu")
    overlap = holdout.row_keys() & train.row_keys()
    if overlap:
        raise SystemExit(f"{len(overlap)} held-out rows are training rows")
    n_params = sum(v.numel() for v in state["net"].values())
    record = run / "result.json"  # the run's training seed, which cli eval's draws follow
    seed = json.loads(record.read_text()).get("seed", 0) if record.exists() else 0
    meta = {"L": train.L, "M": train.M, "step": step, "seed": seed, "net": NET,
            "n_params": n_params, "updates_done": int(state["updates_done"]),
            "card": reading["card"], "reading_source": reading["source"],
            "eval": reading["eval"],
            "forward_by_provenance": reading.get("forward_by_provenance")}
    save_policy_npz(a.out, state["net"], {"train": train, "holdout": holdout}, meta)
    back = read_policy_npz(a.out)
    assert all(torch.equal(back["net"][k], v.float()) for k, v in state["net"].items())
    print(json.dumps({"out": str(a.out), "step": step, "n_params": n_params,
                      "train_rows": train.capacity, "holdout_rows": holdout.capacity,
                      "holdout_families": holdout.family_counts,
                      "bytes": Path(a.out).stat().st_size}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
