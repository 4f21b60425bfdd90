"""The port's curriculum (``cli curriculum``) against the JAX package's
recorded 40k-step run.

    python3 tools/curriculum_check.py [--seeds 0:4] [--tree DIR]
        [--out DIR] [--timeout S] [--device cuda|cpu] [-- CLI_FLAGS ...]
    python3 tools/curriculum_check.py --summarize-only --out DIR [--result FILE]

Runs ``python -m tetris_piclim_tpu_torch curriculum`` with the flags of
``results/curriculum_r1.log`` (``docs/RESULTS.md``, "Curriculum run"): levels
1:10, 2:15, 3:20, 5:25, 4096 envs, 40k steps in 2000-step chunks, promotion
threshold 0.5, and the JAX CLI's defaults for the rest, which the port's
share (1024 bank rows per level, replay 131072, warmup 1000, one update per
step, the MLP). One process per seed of ``--seeds A:B``, all at once, from
the tree at ``--tree``: the repo by default, whose runs are labelled
``repaired``, or a ``git archive`` directory of another tree, whose runs are
labelled ``parent`` and run beside this one's. The flags after
``--`` go to every run after the recipe's (``--device cpu`` and toy sizes on
the CPU; ``--device`` is passed by the tool).

Each run's stderr rows (``[  2000] loss=... wr=[...] dist=[...]``, the JAX
log's format) are stamped as they arrive; its rate (``env_steps_per_s``) is
the env steps between its first and last row over the time between them,
so the banks' carve and the final evaluation are left out (``wall_s`` has
them; it runs from the start of the call's runs until this run was seen
to end). A run's record (rows, the final JSON with its per-level greedy
evaluation, rates, exit code, the number of runs this call started
(``concurrent``), the card's name and power limit as
``nvidia-smi`` gives them, the host's load) goes to
``OUT/<label>_s<seed>.json``, its stderr to ``OUT/<label>_s<seed>.log`` and
its stdout to ``OUT/<label>_s<seed>.out``. A run past ``--timeout`` is
killed and keeps its rows so far (exit code 124).

Then every record in OUT, of this call and of earlier ones, is read into
one result (``--result``, default ``OUT/result.json``; ``--summarize-only``
runs nothing): each run, JAX's rows and final line, and the bands, fixed
before any run was read:

* level 0's training win rate at 10k / 20k / 26k within 0.05 of JAX's
  (0.264 / 0.41 / 0.473);
* the first promotion, the step of the first row whose level distribution
  moves, within 4000 steps of JAX's (28000); a run that never promotes
  counts as later than any step;
* level 1's training win rate at 40k within 0.05 of JAX's (0.089).

A band holds when the median of the ``repaired`` runs lies inside it. Each
band also gives those runs' mean and sd (``tools/seed_spread.py``'s
``seed_stats``, with the sd's 95% interval and JAX's z) and each run's z
against them; every ``parent`` run is set against the same mean and sd
(``parent_z``). A run outside a band is read against that sd, not as a
fault. Prints the result as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
from learning_check import card, host_load
from seed_spread import seed_stats

ROOT = Path(__file__).resolve().parents[1]
JAX_LOG = ROOT / "results" / "curriculum_r1.log"
RECIPE = ["--levels", "1:10,2:15,3:20,5:25", "--num-envs", "4096",
          "--steps", "40000", "--chunk", "2000", "--threshold", "0.5"]
LABELS = ("repaired", "parent")
# band -> (level, step) of a training win rate, or None for the first promotion
BANDS = {"level0_10k": (0, 10_000), "level0_20k": (0, 20_000),
         "level0_26k": (0, 26_000), "first_promotion": None,
         "level1_40k": (1, 40_000)}
WIN_RATE_BAND, PROMOTION_BAND = 0.05, 4000
_ROW = re.compile(r"^\[\s*(\d+)\] loss=(\S+) wr=\[([^\]]*)\] dist=\[([^\]]*)\]")


def command(seed: int, device: str, extra: list) -> list:
    return [sys.executable, "-m", "tetris_piclim_tpu_torch", "curriculum", *RECIPE,
            "--seed", str(seed), "--device", device, *extra]


def parse_row(line: str) -> Optional[dict]:
    m = _ROW.match(line.strip())
    if not m:
        return None
    return {"step": int(m.group(1)), "loss": float(m.group(2)),
            "win_rate_per_level": [float(x) for x in m.group(3).split(",")],
            "level_distribution": [int(x) for x in m.group(4).split(",")]}


def read_log(text: str) -> tuple[list[dict], Optional[dict]]:
    """The chunk rows of a curriculum log and its last JSON line, if any."""
    rows = [r for r in map(parse_row, text.splitlines()) if r]
    final = None
    for line in text.splitlines():
        if line.startswith("{"):
            final = json.loads(line)
    return rows, final


def first_promotion(rows: list[dict]) -> Optional[int]:
    """The step of the first row whose level distribution is not all at
    level 0, or None."""
    for r in rows:
        if any(r["level_distribution"][1:]):
            return r["step"]
    return None


def readings(rows: list[dict]) -> dict:
    """Band name -> the run's value (None where the run has no such row)."""
    by_step = {r["step"]: r for r in rows}
    out = {}
    for name, at in BANDS.items():
        if at is None:
            out[name] = first_promotion(rows)
        else:
            r = by_step.get(at[1])
            out[name] = None if r is None else r["win_rate_per_level"][at[0]]
    return out


def band(name: str, jax: float, values: dict, parent: dict, reached: dict) -> dict:
    """One band over the repaired runs' ``values`` (seed -> value; None for
    a first promotion that never came): median, spread, each run's z, and
    the parent runs against that spread. ``reached`` says, per seed,
    whether the run got to the band's row (a run cut short has no value)."""
    promotion = BANDS[name] is None
    tol = PROMOTION_BAND if promotion else WIN_RATE_BAND
    seeds = [s for s in values if reached[s]]
    x = sorted(np.inf if values[s] is None else values[s] for s in seeds)
    median = float(np.median(x)) if x else None
    if median is not None and not np.isfinite(median):
        median = None  # most runs never promoted
    finite = {s: values[s] for s in seeds if values[s] is not None}
    stats = seed_stats(finite, jax) if finite else {"n": 0}
    sd = stats.get("sd")

    def z(v):
        return None if v is None or not sd else (v - stats["mean"]) / sd

    holds = (None if not seeds or len(seeds) < len(values)
             else median is not None and abs(median - jax) <= tol)
    return {"jax": jax, "tolerance": tol, "seeds": values, "median": median,
            **{k: v for k, v in stats.items() if k != "n"}, "n": len(seeds),
            "never_promoted": [s for s in seeds if promotion and values[s] is None],
            "z": {s: z(v) for s, v in finite.items()},
            "parent_z": {s: z(v) for s, v in parent.items()},
            "parent": parent, "holds": holds}


def bands(runs: list[dict], jax_rows: list[dict]) -> dict:
    jax = readings(jax_rows)
    rep = {r["seed"]: r for r in runs if r["tree"] == LABELS[0]}
    par = {r["seed"]: readings(r["rows"]) for r in runs if r["tree"] == LABELS[1]}
    last = {s: r["rows"][-1]["step"] if r["rows"] else 0 for s, r in rep.items()}
    read = {s: readings(r["rows"]) for s, r in rep.items()}
    out = {}
    for name, at in BANDS.items():
        # a run that never promoted is read once it passed the band's end
        need = jax[name] + PROMOTION_BAND if at is None else at[1]
        values = {s: v[name] for s, v in read.items()}
        reached = {s: last[s] >= need or (at is None and values[s] is not None)
                   for s in values}
        out[name] = band(name, jax[name], values,
                         {s: v[name] for s, v in par.items()}, reached)
    return out


def verdict(b: dict) -> dict:
    held = {k: v["holds"] for k, v in b.items()}
    return {"bands_held": [k for k, v in held.items() if v],
            "bands_missed": [k for k, v in held.items() if v is False],
            "bands_unread": [k for k, v in held.items() if v is None],
            "all_hold": all(v is True for v in held.values())}


def stream(proc, log: Path, stamps: list) -> None:
    """Copy ``proc``'s stderr into ``log``, stamping every chunk row."""
    with open(log, "w") as f:
        for line in proc.stderr:
            f.write(line)
            f.flush()
            if _ROW.match(line.strip()):
                stamps.append(time.perf_counter())


def rate(rows: list[dict], stamps: list, num_envs: int) -> Optional[float]:
    if len(rows) < 2 or len(stamps) < len(rows):
        return None
    return ((rows[-1]["step"] - rows[0]["step"]) * num_envs
            / (stamps[len(rows) - 1] - stamps[0]))


def run_seeds(a: argparse.Namespace, extra: list, out: Path) -> None:
    """One ``cli curriculum`` process per seed, all at once; a record each."""
    tree = Path(a.tree).resolve()
    label = LABELS[tree != ROOT]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(tree), os.environ.get("PYTHONPATH")])))
    smi = card() if a.device == "cuda" else None
    num_envs = int(parse_flags(extra).num_envs)
    runs = {}
    t0 = time.perf_counter()
    for s in range(*a.seeds):
        cmd = command(s, a.device, extra)
        with open(out / f"{label}_s{s}.out", "w") as stdout:
            proc = subprocess.Popen(cmd, cwd=tree, env=env, stdout=stdout,
                                    stderr=subprocess.PIPE, text=True)
        stamps: list = []
        th = threading.Thread(target=stream, daemon=True,
                              args=(proc, out / f"{label}_s{s}.log", stamps))
        th.start()
        runs[s] = (cmd, proc, th, stamps)
    for s, (cmd, proc, th, stamps) in runs.items():
        try:
            rc = proc.wait(timeout=max(1.0, a.timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = 124
        wall = time.perf_counter() - t0
        th.join()
        rows, _ = read_log((out / f"{label}_s{s}.log").read_text())
        _, final = read_log((out / f"{label}_s{s}.out").read_text())
        # the tree and the interpreter as the repo names them, not by path
        rec = {"tree": label, "tree_dir": os.path.relpath(tree, ROOT), "seed": s,
               "command": ["python", *cmd[1:]],
               "rc": rc, "rows": rows, "final": final,
               "eval_per_level": (final or {}).get("eval_per_level"),
               "env_steps_per_s": rate(rows, stamps, num_envs),
               "wall_s": wall, "concurrent": len(runs), "card": smi,
               "host": host_load()}
        (out / f"{label}_s{s}.json").write_text(json.dumps(rec) + "\n")
        if rc:
            sys.stderr.write(f"{label} seed {s} exited with {rc}\n")


def parse_flags(extra: list) -> argparse.Namespace:
    """The recipe's flags with ``extra`` after them, as ``cli curriculum``
    reads them."""
    from tetris_piclim_tpu_torch import cli

    return cli.build_parser().parse_args(["curriculum", *RECIPE, *extra])


def summarize(out: Path) -> dict:
    runs = [json.loads(p.read_text()) for label in LABELS
            for p in sorted(out.glob(f"{label}_s[0-9]*.json"),
                            key=lambda p: int(p.stem.rsplit("_s", 1)[1]))]
    jax_rows, jax_final = read_log(JAX_LOG.read_text())
    b = bands(runs, jax_rows)
    cards = sorted({r["card"] for r in runs if r["card"]})
    return {"tool": "curriculum_check", "recipe": RECIPE,
            "jax": {"log": str(JAX_LOG.relative_to(ROOT)), "rows": jax_rows,
                    "final": jax_final, "readings": readings(jax_rows)},
            "bands": b, "verdict": verdict(b), "cards": cards,
            "runs": runs}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="0:4",
                   type=lambda s: tuple(int(x) for x in s.split(":")))
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--timeout", type=float, default=3000.0)
    p.add_argument("--out", default=str(ROOT / "build" / "curriculum"))
    p.add_argument("--result", default=None)
    p.add_argument("--summarize-only", action="store_true")
    a = p.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    if not a.summarize_only:
        earlier = sorted(p.name for p in out.glob("*_s[0-9]*.json"))
        if earlier:
            sys.stderr.write(f"{out} already holds {len(earlier)} records, read into "
                             f"this result too: {' '.join(earlier)}\n")
        run_seeds(a, extra, out)
    line = json.dumps(summarize(out))
    Path(a.result or out / "result.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
