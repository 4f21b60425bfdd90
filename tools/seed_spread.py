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

The results fall in groups by the device bank's stream (``bank_stream``;
a result without it was trained while the bank's unseeded fill and
refreshes drew the trainer's own stream, ``bank_seed``; ``jax_order`` is
the stream seeded from the bank's ``random.Random``, as JAX seeds it).
``groups`` holds the rows above for each stream, and ``rows`` those of the
newest stream present. ``curve`` gives each stream's seeds' mean and sd
(with its 95% interval) at every logged chunk row, and JAX's value there.
With both streams present, ``streams`` compares them at ``TEST_STEPS``
(Welch's t and an exact permutation test on the difference of means), sets
each old-stream seed (``z_against_new``) and JAX (``jax_z``) against each
group, and applies the rule for C-2 (``c2``, fixed before the new seeds
were read): (a) a new seed at or below ``SLOW`` at the last test step, or
old seed ``RULE_SEED`` less than ``RULE_Z`` new sd below the new mean: a
slow seed of the recipe; (b) else, the groups apart at p < ``ALPHA`` at a
test step: made by the shared stream; (c) otherwise open.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
from learning_check import BANK_STREAM

ROOT = Path(__file__).resolve().parents[1]
RESULTS = sorted((ROOT / "results").glob("flagship_L5M25_100k*_h100*.json"))
OUT = ROOT / "results" / "training_seeds_L5M25_spread.json"
HELD_OUT = ("holdout", "carve", "forward", "train_bank")
STREAMS = ("bank_seed", BANK_STREAM)   # old, new
TEST_STEPS = (25_000, 50_000)
ALPHA, SLOW, RULE_SEED, RULE_Z = 0.01, 0.30, 2, 3.0


def stream_of(result: dict) -> str:
    return result.get("bank_stream", STREAMS[0])


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


def curve(results: list[dict]) -> dict:
    """Per logged chunk row: each seed's training win rate, JAX's, and the
    seeds' mean and sd."""
    out = {}
    for res in results:
        for row in res.get("rows", []):
            r = out.setdefault(str(row["step"]), {"jax": row["jax_win_rate"], "seeds": {}})
            r["seeds"][res["seed"]] = row["port_win_rate"]
    for r in out.values():
        r.update(seed_stats(r["seeds"], r["jax"]))
    return dict(sorted(out.items(), key=lambda kv: int(kv[0])))


def permutation_p(x: np.ndarray, y: np.ndarray) -> float:
    """Exact two-sided permutation p of the difference of means."""
    from itertools import combinations

    pool, n = np.concatenate([x, y]), x.size
    obs = abs(x.mean() - y.mean())
    hits = total = 0
    for idx in combinations(range(pool.size), n):
        mask = np.zeros(pool.size, bool)
        mask[list(idx)] = True
        hits += abs(pool[mask].mean() - pool[~mask].mean()) >= obs - 1e-12
        total += 1
    return hits / total


def compare_streams(curves: dict) -> dict:
    """The old stream's seeds against the new one's at TEST_STEPS, and the
    rule for C-2."""
    from scipy import stats

    old, new = (curves[s] for s in STREAMS)
    out = {}
    for step in TEST_STEPS:
        a, b = old.get(str(step)), new.get(str(step))
        if a is None or b is None or a["n"] < 2 or b["n"] < 2:
            continue
        x = np.array(list(a["seeds"].values()), float)
        y = np.array(list(b["seeds"].values()), float)
        out[str(step)] = {
            "old": {k: a[k] for k in ("n", "mean", "sd", "sd_95")},
            "new": {k: b[k] for k in ("n", "mean", "sd", "sd_95")},
            "welch_p": float(stats.ttest_ind(x, y, equal_var=False).pvalue),
            "permutation_p": permutation_p(x, y),
            "z_against_new": {s: (v - b["mean"]) / b["sd"] for s, v in a["seeds"].items()},
            "jax": a["jax"], "jax_z": {"old": a["jax_z"], "new": b["jax_z"]},
            "new_min": float(y.min())}
    if str(TEST_STEPS[-1]) not in out:
        return {"tests": out, "c2": None}
    last = out[str(TEST_STEPS[-1])]
    slow = last["new_min"] <= SLOW
    z = last["z_against_new"].get(RULE_SEED)
    apart = any(t["welch_p"] < ALPHA or t["permutation_p"] < ALPHA for t in out.values())
    verdict = ("a" if slow or (z is not None and z > -RULE_Z)
               else "b" if apart else "c")
    return {"tests": out, "c2": {"verdict": verdict, "new_seed_at_or_below_slow": slow,
                                  "rule_seed_z": z, "apart_at_alpha": apart}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results", nargs="*", default=[str(x) for x in RESULTS])
    p.add_argument("--out", default=str(OUT))
    a = p.parse_args(argv)
    results = [json.loads(Path(x).read_text()) for x in a.results]
    if len({(stream_of(r), r["seed"]) for r in results}) != len(results):
        raise SystemExit("two results of one seed and stream")
    by_stream = {st: [r for r in results if stream_of(r) == st] for st in STREAMS}
    by_stream = {st: rs for st, rs in by_stream.items() if rs}
    groups = {st: {"seeds": sorted(r["seed"] for r in rs), "rows": seed_spread(rs)}
              for st, rs in by_stream.items()}
    curves = {st: curve(rs) for st, rs in by_stream.items()}
    out = {"results": [os.path.relpath(Path(x).resolve(), ROOT) for x in a.results],
           "rows": groups[list(groups)[-1]]["rows"], "groups": groups, "curve": curves}
    if len(by_stream) == len(STREAMS):
        out["streams"] = compare_streams(curves)
    text = json.dumps(out)
    Path(a.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
