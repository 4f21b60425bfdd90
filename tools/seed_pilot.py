"""How many training runs share one card well? The pilot of a multi-seed
run of the flagship 100k recipe.

    python3 tools/seed_pilot.py [--out DIR] [-- LEARNING_CHECK_FLAGS ...]

Runs ``tools/learning_check.py --recipe flagship100k`` for each layout of
``LAYOUTS`` in turn: seeds 0, 1 and 2 at the same time on the one card
(each a ``cli train`` process of its own), then seeds 0–3, ``STEPS`` steps
each, then seed ``ALONE`` alone for the same steps. The flags after ``--``
go to every run (``--device cpu`` and toy sizes on the CPU). Each run's
rate is read from its own log (the chunk rows' env-steps/s), not from the
layout's wall time, and set over the rate alone. A layout is ``ok`` when
every run in it keeps at least ``SHARE`` of the rate alone; ``best`` is
the ok layout with the highest total rate (the sum of its shares), or
None. The processes share no state, so a seed's rows (training win rate
and loss per chunk) must be the same in every run of it: ``rows_equal``
holds that for every seed, and ``runs_by_seed`` says how many runs each
seed's check compared (seed ``ALONE``'s includes its run alone). Every
checkpoint is deleted. Prints one JSON line and writes it to
``DIR/pilot.json``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHARE = 0.6
LAYOUTS = ((0, 1, 2), (0, 1, 2, 3))
ALONE = 0
STEPS = 3000


def command(seed: int, out: Path, extra: list) -> list:
    return [sys.executable, str(ROOT / "tools" / "learning_check.py"),
            "--recipe", "flagship100k", "--seed", str(seed), "--steps", str(STEPS),
            "--out", str(out), *extra]


def run(seeds: tuple, out: Path, extra: list) -> dict:
    """Run one learning check per seed at once; each run's record."""
    t0 = time.perf_counter()
    procs = {s: subprocess.Popen(command(s, out / f"s{s}", extra), cwd=ROOT,
                                 stdout=subprocess.DEVNULL)
             for s in seeds}
    rcs = {s: p.wait() for s, p in procs.items()}
    wall = time.perf_counter() - t0
    res = {}
    for s in seeds:
        if rcs[s]:
            raise SystemExit(f"seed {s}'s learning check exited with {rcs[s]}")
        r = json.loads((out / f"s{s}" / "result.json").read_text())
        res[s] = {"env_steps_per_s": r["env_steps_per_s"],
                  "sps_by_chunk": [row["port_sps"] for row in r["rows"]],
                  "rows": [(row["step"], row["port_win_rate"], row["port_loss"])
                           for row in r["rows"]],
                  "wall_s": r["wall_s"], "card": r["card"]}
    return {"seeds": list(seeds), "wall_s": wall, "runs": res}


def verdict(layouts: list, alone: dict) -> dict:
    """Each layout's runs' rates over the rate alone, the best layout, and
    whether every seed's rows are the same in all its runs."""
    solo = alone["runs"][ALONE]["env_steps_per_s"]
    for lay in layouts:
        share = {s: r["env_steps_per_s"] / solo for s, r in lay["runs"].items()}
        lay.update(share_of_alone=share, total_of_alone=sum(share.values()),
                   ok=min(share.values()) >= SHARE)
    ok = [lay for lay in layouts if lay["ok"]]
    best = max(ok, key=lambda lay: lay["total_of_alone"]) if ok else None
    rows: dict = {}
    for r in [alone, *layouts]:
        for s, run_s in r["runs"].items():
            rows.setdefault(s, []).append(run_s["rows"])
    equal = all(bool(rs[0]) and all(x == rs[0] for x in rs) for rs in rows.values())
    return {"best": None if best is None else len(best["seeds"]),
            "rows_equal": equal,
            "runs_by_seed": {s: len(rs) for s, rs in rows.items()},
            "steps_compared": [r[0] for r in alone["runs"][ALONE]["rows"]]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(ROOT / "build" / "seed_pilot"))
    out = Path(p.parse_args(argv).out)
    layouts = [run(seeds, out / f"together{len(seeds)}", extra) for seeds in LAYOUTS]
    alone = run((ALONE,), out / "alone", extra)
    for ckpt in out.glob("*/s*/ckpt"):
        shutil.rmtree(ckpt)
    res = {"tool": "seed_pilot", "steps": STEPS, "share_needed": SHARE,
           "alone": alone, **verdict(layouts, alone), "layouts": layouts}
    line = json.dumps(res)
    out.mkdir(parents=True, exist_ok=True)
    (out / "pilot.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
