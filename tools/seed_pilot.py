"""Do two training runs share one card at little cost? The pilot of a
multi-seed run of the flagship 100k recipe.

    python3 tools/seed_pilot.py [--out DIR] [-- LEARNING_CHECK_FLAGS ...]

Runs ``tools/learning_check.py --recipe flagship100k`` for seeds 1 and 2
(``SEEDS``) at the same time on the one card (each a ``cli train`` process
of its own), ``STEPS`` steps each, then seed 1 alone for the same steps. The
flags after ``--`` go to every run (``--device cpu`` and toy sizes on the
CPU). Each run's rate is read from its own log (the chunk rows' env-steps/s),
not from the pair's wall time. The processes share no state, so seed 1's
rows (training win rate and loss per chunk) must be equal together and
alone. ``share_ok`` is true when every process run together keeps at
least ``SHARE`` of seed 1's rate alone. Every checkpoint is deleted.
Prints one JSON line and writes it to ``DIR/pilot.json``.
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
SHARE = 0.8
SEEDS = (1, 2)
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
    return {"wall_s": wall, "runs": res}


def verdict(together: dict, alone: dict, first: int) -> dict:
    """Each run's rate together over the first seed's rate alone, and
    whether the first seed's rows are the same both ways."""
    solo = alone["runs"][first]["env_steps_per_s"]
    share = {s: r["env_steps_per_s"] / solo for s, r in together["runs"].items()}
    rows_t, rows_a = together["runs"][first]["rows"], alone["runs"][first]["rows"]
    return {"share_of_alone": share, "share_ok": min(share.values()) >= SHARE,
            "rows_equal": rows_t == rows_a and bool(rows_a),
            "steps_compared": [r[0] for r in rows_a]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(ROOT / "build" / "seed_pilot"))
    out = Path(p.parse_args(argv).out)
    together = run(SEEDS, out / "together", extra)
    alone = run(SEEDS[:1], out / "alone", extra)
    for ckpt in out.glob("*/s*/ckpt"):
        shutil.rmtree(ckpt)
    res = {"tool": "seed_pilot", "seeds": list(SEEDS), "steps": STEPS,
           "together": together, "alone": alone, "share_needed": SHARE,
           **verdict(together, alone, SEEDS[0])}
    line = json.dumps(res)
    out.mkdir(parents=True, exist_ok=True)
    (out / "pilot.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
