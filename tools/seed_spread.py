"""The spread of training seeds of one recipe, with and without each seed.

    python3 tools/seed_spread.py [RESULT.json ...] [--out FILE]

Reads ``tools/learning_check.py`` results of one recipe at several
``--seed`` values (by default ``results/flagship_L5M25_100k*_h100*.json``:
seeds 0, 1 and 2 to 100k, seeds 3 and 4 to 50k) and, for each row that
the runs report (the training win rate at each band step; the held-out
reading's held-out, carve, forward and training-bank win rates), gives
each seed's value and JAX's, then the seeds' mean and standard deviation
with the 95% interval of that standard deviation (chi-square, n - 1
degrees of freedom: from three readings it spans 0.52x to 6.3x), JAX's
z-score against them, and the same with each seed left out in turn, with
that seed's z-score against the others. A seed that lies far from the
others shows as a large left-out z with a small left-out sd; a spread
that one seed makes is then not the spread of the rest. Prints one JSON
line and writes it to ``--out`` (default
``results/training_seeds_L5M25_spread.json``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RESULTS = sorted((ROOT / "results").glob("flagship_L5M25_100k*_h100*.json"))
OUT = ROOT / "results" / "training_seeds_L5M25_spread.json"
HELD_OUT = ("holdout", "carve", "forward", "train_bank")


def readings(result: dict) -> dict:
    """Row name -> (the run's value, JAX's) for each row the run reached."""
    out = {f"training_{b['step'] // 1000}k": (b["port"], b["jax"])
           for b in result["band"]["training"] if b["port"] is not None}
    for key in HELD_OUT:
        row = (result["held_out"] or {}).get("rows", {}).get(key)
        if row and row["port"] is not None:
            out[key] = (row["port"], row["jax"])
    return out


def seed_stats(values: dict, jax: float) -> dict:
    """Mean, sd (with its 95% interval) and JAX's z over ``values``."""
    from scipy import stats

    x = np.array(list(values.values()), float)
    n = x.size
    out = {"n": n, "mean": float(x.mean())}
    if n < 2:
        return out
    sd = float(x.std(ddof=1))
    lo, hi = (math.sqrt((n - 1) / stats.chi2.ppf(q, n - 1)) for q in (0.975, 0.025))
    out.update(sd=sd, sd_95=[sd * lo, sd * hi],
               jax_z=(jax - out["mean"]) / sd if sd else None)
    return out


def seed_spread(results: list[dict]) -> dict:
    rows = {}
    for res in results:
        for name, (port, jax) in readings(res).items():
            row = rows.setdefault(name, {"jax": jax, "seeds": {}})
            if row["jax"] != jax:
                raise SystemExit(f"{name}: the results hold other JAX readings")
            row["seeds"][res["seed"]] = port
    for row in rows.values():
        seeds, jax = row["seeds"], row["jax"]
        row["all"] = seed_stats(seeds, jax)
        row["leave_one_out"] = {}
        if len(seeds) < 3:
            continue
        for s, v in seeds.items():
            rest = seed_stats({t: w for t, w in seeds.items() if t != s}, jax)
            rest["z_of_left_out"] = ((v - rest["mean"]) / rest["sd"]
                                     if rest.get("sd") else None)
            row["leave_one_out"][s] = rest
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results", nargs="*", default=[str(x) for x in RESULTS])
    p.add_argument("--out", default=str(OUT))
    a = p.parse_args(argv)
    results = [json.loads(Path(x).read_text()) for x in a.results]
    if len({r["seed"] for r in results}) != len(results):
        raise SystemExit("two results of one seed")
    text = json.dumps({"results": [os.path.relpath(Path(x).resolve(), ROOT)
                                   for x in a.results],
                       "rows": seed_spread(results)})
    Path(a.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
