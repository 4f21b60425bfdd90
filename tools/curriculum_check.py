"""The port's curriculum (``cli curriculum``) against the JAX package's
recorded 40k-step run.

    python3 tools/curriculum_check.py [--seeds 0:4] [--tree DIR]
        [--package torch|jax] [--matmul f32|bf16] [--out DIR] [--timeout S]
        [--device cuda|cpu] [-- CLI_FLAGS ...]
    python3 tools/curriculum_check.py --summarize-only --out DIR [--result FILE]
        [--apart A:B]

Runs ``python -m tetris_piclim_tpu_torch curriculum`` with the flags of
``results/curriculum_r1.log`` (``docs/RESULTS.md``, "Curriculum run"): levels
1:10, 2:15, 3:20, 5:25, 4096 envs, 40k steps in 2000-step chunks, promotion
threshold 0.5, and the JAX CLI's defaults for the rest, which the port's
share (1024 bank rows per level, replay 131072, warmup 1000, one update per
step, the MLP). One process per seed of ``--seeds A:B``, all at once, from
the tree at ``--tree``: the repo by default, whose runs are labelled
``repaired``, or a ``git archive`` directory of another tree, whose runs are
labelled ``parent`` and run beside this one's. The flags after
``--`` go to every run after the recipe's (``--num-envs 1024`` or toy sizes
on the CPU; ``--device`` is passed by the tool).

``--package jax`` runs the JAX package's own CLI instead, ``python -m
tetris_piclim_tpu curriculum`` with ``JAX_PLATFORMS=cpu`` and no
``--device`` (labelled ``jax``; the one path of the tool that reaches the
JAX package, as in ``tools/learning_probe.py``). ``--matmul bf16`` runs the
port's CLI in a process that first makes every ``nn.Linear`` multiply
bfloat16-rounded operands with float32 sums, in its forward product and
both backward products (``learning_probe.round_linear_fwd_bwd_to_bf16``):
one bfloat16 pass, as XLA's default precision runs a float32 layer on a
TPU (labelled ``port_bf16``). ``--swap banks|init|draws`` runs the port's
CLI with that part of JAX's run swapped in (``tools/curriculum_swap.py``;
labelled ``port_swap_<part>``), to find which part moves a reading that
differs.

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
its stdout to ``OUT/<label>_s<seed>.out``; a port run on the card is
``OUT/<label>_cuda_s<seed>.*``, so that the card's and the CPU's runs of
one seed can share OUT. A run past ``--timeout`` is killed and keeps its
rows so far (exit code 124).

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
fault. ``bands`` and ``verdict`` are those of the first ``repaired``
group; ``groups`` has them for every set of runs of one label, device and
flags (each summarized apart), and sets a ``jax`` or ``port_bf16`` group
against the ``repaired`` group of its device and flags
(``against_repaired``: each run's z on the repaired runs' spread, and
Welch's t test of the means).

Where OUT holds ``jax`` runs and port runs of the same flags,
``comparisons`` sets them side by side by ``RULE`` (fixed before any JAX
run of it was read): five readings per run (``compare_readings``), Welch's
two-sided t test per reading, Holm over the readings both arms reached
(the five, for runs of the recipe's length) at ``ALPHA``; each arm's
mean and sd with its 95% interval, and the difference's 95% interval. It
also places JAX's recorded run on the ``jax`` arm, as read and scaled to
the recorded recipe's width by the port's own ratio between its float32
runs of the recorded recipe on the card (``CARD_RESULT``) and these. The
port arm is each port group of those flags, the card's runs and the
CPU's apart (``device``); the rule is read on every seed (``seeds_read``
"all") and, with ``--apart A:B``, again on the seeds A..B-1 of both arms
alone (fresh seeds chosen before they ran). ``device_checks`` sets each
port label's CPU runs against its card runs of the same flags by the same
rule, on the seeds both ran: whether the device moves the distribution.
Prints the result as one JSON line.
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
SWAPS = ("banks", "init", "draws")
LABELS = ("repaired", "parent", "jax", "port_bf16", *(f"port_swap_{p}" for p in SWAPS))
CARD_RESULT = ROOT / "results" / "curriculum_r1_h100.json"
# band -> (level, step) of a training win rate, or None for the first promotion
BANDS = {"level0_10k": (0, 10_000), "level0_20k": (0, 20_000),
         "level0_26k": (0, 26_000), "first_promotion": None,
         "level1_40k": (1, 40_000)}
WIN_RATE_BAND, PROMOTION_BAND = 0.05, 4000
# the readings the packages are compared on: level 0 as the bands read it,
# the first promotion, and level 1 six 2000-step chunks after each run's
# own first promotion (so an earlier promotion does not move it)
COMPARE = ("level0_10k", "level0_20k", "level0_26k", "first_promotion",
           "level1_after_promotion")
AFTER_PROMOTION, ALPHA = 12_000, 0.01
RULE = ("For each reading (level 0's training win rate at 10k, 20k and 26k; the "
        "first promotion's step; level 1's training win rate 12000 steps after the "
        "run's own first promotion), Welch's two-sided t test between the jax runs "
        "and the port's CPU runs; Holm over the five readings at alpha 0.01. A run "
        "that never promotes enters the first promotion at one chunk past its last "
        "row and has no level-1 reading; a run whose first promotion comes later "
        "than 12000 steps before its end has no level-1 reading. No reading "
        "differs: one distribution on the CPU, C-4 closes as JAX's one run drawn "
        "from that spread. A reading differs: C-4 stays open as a fault, and the "
        "part that moves it is found by swapping one part at a time (JAX's banks, "
        "JAX's initial weights, the port's explicit draws).")
# runs the port's CLI with every nn.Linear's products on bfloat16 operands
BF16_MAIN = ("import sys; sys.path.insert(0, 'tools'); import learning_probe; "
             "learning_probe.round_linear_fwd_bwd_to_bf16(); "
             "from tetris_piclim_tpu_torch.cli import main; sys.exit(main())")
# runs the port's CLI with one part of JAX's run swapped in (tools/curriculum_swap.py)
SWAP_MAIN = ("import sys; sys.path.insert(0, 'tools'); import curriculum_swap; "
             "curriculum_swap.apply({!r}); "
             "from tetris_piclim_tpu_torch.cli import main; sys.exit(main())")
_ROW = re.compile(r"^\[\s*(\d+)\] loss=(\S+) wr=\[([^\]]*)\] dist=\[([^\]]*)\]")


def command(seed: int, device: str, extra: list, package: str = "torch",
            matmul: str = "f32", swap: Optional[str] = None) -> list:
    if package == "jax":
        return [sys.executable, "-m", "tetris_piclim_tpu", "curriculum", *RECIPE,
                "--seed", str(seed), *extra]
    head = (["-c", SWAP_MAIN.format(swap)] if swap else ["-c", BF16_MAIN]
            if matmul == "bf16" else ["-m", "tetris_piclim_tpu_torch"])
    return [sys.executable, *head, "curriculum", *RECIPE, "--seed", str(seed),
            "--device", device, *extra]


def label_of(tree: Path, package: str = "torch", matmul: str = "f32",
             swap: Optional[str] = None) -> str:
    if package == "jax":
        return "jax"
    if swap:
        return f"port_swap_{swap}"
    if matmul == "bf16":
        return "port_bf16"
    return LABELS[tree.resolve() != ROOT]


def run_env(tree: Path, package: str, swap: Optional[str] = None) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(tree), os.environ.get("PYTHONPATH")])))
    if package == "jax" or swap:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def same_recipe(a: list, b: list) -> bool:
    """Two runs' flags alike but for ``--steps``: a shorter run is read on
    the rows it reached."""
    def cut(flags):
        return [f for i, f in enumerate(flags)
                if f != "--steps" and (i == 0 or flags[i - 1] != "--steps")]
    return cut(a) == cut(b)


def flags_of(cmd: list) -> tuple[list, str]:
    """A run's command as (its flags after ``curriculum`` without ``--seed``
    and ``--device``, its device): what a group of runs shares."""
    args = cmd[cmd.index("curriculum") + 1:]
    flags, device, i = [], "cpu", 0
    while i < len(args):
        if args[i] in ("--seed", "--device"):
            device = args[i + 1] if args[i] == "--device" else device
            i += 2
            continue
        flags.append(args[i])
        i += 1
    return flags, device


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


def compare_readings(rows: list[dict], end: Optional[int] = None) -> dict:
    """A run's five readings for ``RULE`` (None where it has none). ``end``
    is the step the run reached its end at; a run that never promoted by
    then enters the first promotion one chunk past it."""
    by_step = {r["step"]: r for r in rows}
    read = readings(rows)
    out = {k: read[k] for k in COMPARE[:3]}
    promo = first_promotion(rows)
    if promo is None and end is not None and len(rows) > 1:
        promo = end + rows[-1]["step"] - rows[-2]["step"]
    out["first_promotion"] = promo
    after = by_step.get(promo + AFTER_PROMOTION) if promo is not None else None
    out["level1_after_promotion"] = None if after is None else after[
        "win_rate_per_level"][1]
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


def bands(runs: list[dict], jax_rows: list[dict], label: str = LABELS[0]) -> dict:
    """The bands over the ``label`` runs, with the ``parent`` runs set
    against them."""
    jax = readings(jax_rows)
    rep = {r["seed"]: r for r in runs if r["tree"] == label}
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


def record_stem(label: str, device: str, seed: int) -> str:
    """A record's file name without its suffix: ``<label>_s<seed>``, and
    ``<label>_cuda_s<seed>`` for a port run on the card, so that the card's
    and the CPU's runs of one seed sit side by side in one OUT."""
    return f"{label}_cuda_s{seed}" if device == "cuda" else f"{label}_s{seed}"


def run_seeds(a: argparse.Namespace, extra: list, out: Path) -> None:
    """One ``cli curriculum`` process per seed, all at once; a record each."""
    tree = Path(a.tree).resolve()
    package, matmul = getattr(a, "package", "torch"), getattr(a, "matmul", "f32")
    swap = getattr(a, "swap", None)
    label = label_of(tree, package, matmul, swap)
    env = run_env(tree, package, swap)
    device = "cpu" if package == "jax" else a.device
    smi = card() if device == "cuda" else None
    num_envs = int(parse_flags(extra).num_envs)
    runs = {}
    t0 = time.perf_counter()
    for s in range(*a.seeds):
        cmd = command(s, device, extra, package, matmul, swap)
        stem = record_stem(label, device, s)
        with open(out / f"{stem}.out", "w") as stdout:
            proc = subprocess.Popen(cmd, cwd=tree, env=env, stdout=stdout,
                                    stderr=subprocess.PIPE, text=True)
        stamps: list = []
        th = threading.Thread(target=stream, daemon=True,
                              args=(proc, out / f"{stem}.log", stamps))
        th.start()
        runs[s] = (cmd, stem, proc, th, stamps)
    for s, (cmd, stem, proc, th, stamps) in runs.items():
        try:
            rc = proc.wait(timeout=max(1.0, a.timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = 124
        wall = time.perf_counter() - t0
        th.join()
        rows, _ = read_log((out / f"{stem}.log").read_text())
        _, final = read_log((out / f"{stem}.out").read_text())
        # the tree and the interpreter as the repo names them, not by path
        rec = {"tree": label, "tree_dir": os.path.relpath(tree, ROOT), "seed": s,
               "command": ["python", *cmd[1:]], "package": package,
               "matmul": matmul, "swap": swap, "device": device,
               "rc": rc, "rows": rows, "final": final,
               "eval_per_level": (final or {}).get("eval_per_level"),
               "env_steps_per_s": rate(rows, stamps, num_envs),
               "wall_s": wall, "concurrent": len(runs), "card": smi,
               "host": host_load()}
        (out / f"{stem}.json").write_text(json.dumps(rec) + "\n")
        if rc:
            sys.stderr.write(f"{label} seed {s} exited with {rc}\n")


def parse_flags(extra: list) -> argparse.Namespace:
    """The recipe's flags with ``extra`` after them, as ``cli curriculum``
    reads them."""
    from tetris_piclim_tpu_torch import cli

    return cli.build_parser().parse_args(["curriculum", *RECIPE, *extra])


def keyed_runs(runs: list[dict]) -> dict:
    """(label, device, flags) -> the runs of that group, in record order."""
    keyed: dict = {}
    for r in runs:
        flags, device = flags_of(r["command"])
        keyed.setdefault((r["tree"], device, tuple(flags)), []).append(r)
    return keyed


def groups(runs: list[dict], jax_rows: list[dict]) -> list[dict]:
    """One entry per label, device and flags, in order of first record;
    ``parent`` runs are set against the ``repaired`` group of their flags."""
    keyed = keyed_runs(runs)
    out = []
    for (label, device, flags), rs in keyed.items():
        if label == LABELS[1] and (LABELS[0], device, flags) in keyed:
            continue
        with_parents = rs + (keyed.get((LABELS[1], device, flags), [])
                             if label == LABELS[0] else [])
        b = bands(with_parents, jax_rows, label)
        out.append({"label": label, "device": device, "flags": list(flags),
                    "seeds": [r["seed"] for r in rs], "bands": b,
                    "verdict": verdict(b)})
    for g in out:
        ref = next((h for h in out if h["label"] == LABELS[0] and h is not g
                    and h["device"] == g["device"]
                    and same_recipe(h["flags"], g["flags"])), None)
        if ref is not None and g["label"] != LABELS[1]:
            g["against_repaired"] = against(g["bands"], ref["bands"])
    return out


def against(b: dict, ref: dict) -> dict:
    """Each band's runs in ``b`` set against the ``repaired`` runs' spread
    in ``ref`` (each run's z, and Welch's t test of the means)."""
    out = {}
    for name, row in b.items():
        mine = {s: v for s, v in row["seeds"].items() if v is not None}
        theirs = {s: v for s, v in ref[name]["seeds"].items() if v is not None}
        sd = ref[name].get("sd")
        out[name] = {"median": row["median"], "repaired_median": ref[name]["median"],
                     "z": {s: (v - ref[name]["mean"]) / sd if sd else None
                           for s, v in mine.items()}}
        if len(mine) >= 2 and len(theirs) >= 2:
            out[name]["minus_repaired"] = welch(
                np.array(list(theirs.values()), float), np.array(list(mine.values()), float))
    return out


def welch(x: np.ndarray, y: np.ndarray) -> dict:
    """Welch's two-sided t test of mean(y) - mean(x), with the difference's
    95% interval."""
    from scipy import stats

    vx, vy = x.var(ddof=1) / x.size, y.var(ddof=1) / y.size
    diff = float(y.mean() - x.mean())
    se = float(np.sqrt(vx + vy))
    if se == 0.0:
        return {"diff": diff, "diff_95": [diff, diff], "t": None, "df": None,
                "p": 1.0 if diff == 0.0 else 0.0}
    df = float((vx + vy) ** 2 / (vx ** 2 / (x.size - 1) + vy ** 2 / (y.size - 1)))
    half = float(stats.t.ppf(0.975, df)) * se
    return {"diff": diff, "diff_95": [diff - half, diff + half], "t": diff / se,
            "df": df, "p": float(2 * stats.t.sf(abs(diff / se), df))}


def holm(p: dict, alpha: float = ALPHA) -> dict:
    """Holm's step-down over ``p`` (name -> p value): name -> rejected."""
    out, m = {k: False for k in p}, len(p)
    for i, k in enumerate(sorted(p, key=p.get)):
        if p[k] >= alpha / (m - i):
            break
        out[k] = True
    return out


def run_readings(r: dict) -> dict:
    """``compare_readings`` of a record; a run reached its end if it exited
    cleanly after the recipe's last step."""
    last = r["rows"][-1]["step"] if r["rows"] else 0
    done = r.get("rc", 0) == 0 and last >= int(RECIPE[RECIPE.index("--steps") + 1])
    return compare_readings(r["rows"], last if done else None)


def arm_stats(values: dict, recorded: Optional[float]) -> dict:
    """``seed_stats`` of one arm; JAX's z only where a recorded run is set
    on it."""
    stats = seed_stats(values, 0.0 if recorded is None else recorded)
    if recorded is None:
        stats.pop("jax_z", None)
    return stats


def compare(jax_runs: list[dict], port_runs: list[dict], recorded: Optional[dict],
            card_runs: list[dict], names: tuple = ("jax", "port")) -> dict:
    """The ``jax`` runs against the port's by ``RULE``, and JAX's recorded
    run (``recorded``, its readings) on the ``jax`` arm. With ``names`` and
    no ``recorded``, any two arms by the same rule (the port's CPU runs
    against its card runs)."""
    first, second = names
    arms = {first: {r["seed"]: run_readings(r) for r in jax_runs},
            second: {r["seed"]: run_readings(r) for r in port_runs}}
    card = [run_readings(r) for r in card_runs]
    out, p = {}, {}
    for name in COMPARE:
        vals = {arm: {s: v[name] for s, v in runs.items() if v[name] is not None}
                for arm, runs in arms.items()}
        row = {arm: {"values": v, **arm_stats(v, None if recorded is None else
                                              recorded[name])} if v else {"n": 0}
               for arm, v in vals.items()}
        x, y = (np.array(list(vals[a].values()), float) for a in names)
        if x.size >= 2 and y.size >= 2:
            row[f"{second}_minus_{first}"] = welch(x, y)
            p[name] = row[f"{second}_minus_{first}"]["p"]
        out[name] = row
        if recorded is None:
            continue
        c = [v[name] for v in card if v[name] is not None]
        scale = float(np.mean(c) / y.mean()) if c and y.size and y.mean() else None
        sd = row["jax"].get("sd")
        row["recorded"] = {
            "value": recorded[name], "z_on_jax_arm": row["jax"].get("jax_z"),
            "card_over_cpu": scale, "card_runs": len(c),
            "z_on_jax_arm_scaled": (None if scale is None or not sd else
                                    (recorded[name] - scale * row["jax"]["mean"])
                                    / (scale * sd))}
    rejected = holm(p)
    for name in p:
        out[name]["rejected"] = rejected[name]
    return {"rule": RULE, "alpha": ALPHA, "readings": out,
            "seeds": {a: sorted(v) for a, v in arms.items()},
            "tested": list(p), "differs": [k for k, v in rejected.items() if v],
            "one_distribution": (len(p) == len(COMPARE)
                                 and not any(rejected.values()))}


def in_range(runs: list[dict], seeds: Optional[tuple]) -> list[dict]:
    """The runs whose seed lies in ``seeds`` (A, B): A <= seed < B; all of
    them for None."""
    return [r for r in runs if seeds is None or seeds[0] <= r["seed"] < seeds[1]]


def comparisons(runs: list[dict], jax_rows: list[dict], card_runs: list[dict],
                apart: Optional[tuple] = None) -> list:
    """The ``jax`` group against each port group of the same flags (a
    shorter port run on the readings it reached), the port's runs on the
    CPU and on the card alike (``device`` tells them apart): on every seed
    (``seeds_read`` "all"), and with ``apart`` (A, B) again on the seeds
    A..B-1 of both arms alone."""
    gs, by_key = groups(runs, jax_rows), keyed_runs(runs)
    recorded = compare_readings(jax_rows)
    out = []
    for g in gs:
        if g["label"] != "jax":
            continue
        jax_runs = by_key[("jax", g["device"], tuple(g["flags"]))]
        for h in gs:
            if h["label"] in ("jax", LABELS[1]) or not same_recipe(h["flags"], g["flags"]):
                continue
            port_runs = by_key[(h["label"], h["device"], tuple(h["flags"]))]
            for seeds in ([None, apart] if apart else [None]):
                if not (in_range(jax_runs, seeds) and in_range(port_runs, seeds)):
                    continue
                out.append({"jax": "jax", "port": h["label"], "device": h["device"],
                            "flags": h["flags"],
                            "seeds_read": "all" if seeds is None else list(seeds),
                            **compare(in_range(jax_runs, seeds), in_range(port_runs, seeds),
                                      recorded, card_runs)})
    return out


def device_checks(runs: list[dict]) -> list:
    """Each port label's CPU runs against its card runs of the same flags,
    by ``RULE``, on the seeds both devices ran: whether the device moves
    the distribution."""
    keyed, out = keyed_runs(runs), []
    for (label, device, flags), cpu in keyed.items():
        if label in ("jax", LABELS[1]) or device != "cpu":
            continue
        for (other, dev, fl), cuda in keyed.items():
            if other != label or dev != "cuda" or not same_recipe(list(fl), list(flags)):
                continue
            both = {r["seed"] for r in cpu} & {r["seed"] for r in cuda}
            out.append({"port": label, "flags": list(flags), "seeds_read": sorted(both),
                        **compare([r for r in cpu if r["seed"] in both],
                                  [r for r in cuda if r["seed"] in both], None, [],
                                  names=("cpu", "cuda"))})
    return out


def summarize(out: Path, card_result: Path = CARD_RESULT,
              apart: Optional[tuple] = None) -> dict:
    runs = [json.loads(p.read_text()) for label in LABELS for stem in ("", "_cuda")
            for p in sorted(out.glob(f"{label}{stem}_s[0-9]*.json"),
                            key=lambda p: int(p.stem.rsplit("_s", 1)[1]))]
    jax_rows, jax_final = read_log(JAX_LOG.read_text())
    gs = groups(runs, jax_rows)
    first = next((g for g in gs if g["label"] == LABELS[0]), gs[0] if gs else None)
    b = first["bands"] if first else bands([], jax_rows)
    cards = sorted({r["card"] for r in runs if r["card"]})
    res = {"tool": "curriculum_check", "recipe": RECIPE,
           "jax": {"log": str(JAX_LOG.relative_to(ROOT)), "rows": jax_rows,
                   "final": jax_final, "readings": readings(jax_rows)},
           "bands": b, "verdict": verdict(b), "groups": gs, "cards": cards,
           "cpus": os.cpu_count(), "runs": runs}
    if any(r["tree"] == "jax" for r in runs):
        card_runs = [r for r in json.loads(Path(card_result).read_text())["runs"]
                     if r["tree"] == LABELS[0]] if Path(card_result).exists() else []
        res["card_result"] = os.path.relpath(Path(card_result).resolve(), ROOT)
        res["comparisons"] = comparisons(runs, jax_rows, card_runs, apart)
    checks = device_checks(runs)
    if checks:
        res["device_checks"] = checks
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="0:4",
                   type=lambda s: tuple(int(x) for x in s.split(":")))
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--package", choices=["torch", "jax"], default="torch")
    p.add_argument("--matmul", choices=["f32", "bf16"], default="f32")
    p.add_argument("--swap", choices=SWAPS, default=None,
                   help="one part of JAX's run in the port's (tools/curriculum_swap.py)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--timeout", type=float, default=3000.0)
    p.add_argument("--out", default=str(ROOT / "build" / "curriculum"))
    p.add_argument("--result", default=None)
    p.add_argument("--summarize-only", action="store_true")
    p.add_argument("--apart", default=None,
                   type=lambda s: tuple(int(x) for x in s.split(":")),
                   help="A:B: compare the seeds A..B-1 of both arms again on their own")
    a = p.parse_args(argv)
    if a.package == "jax" and a.matmul != "f32":
        raise SystemExit("--package jax runs the JAX package as it is, in float32")
    if a.swap and (a.package == "jax" or a.matmul != "f32"):
        raise SystemExit("--swap runs the port's float32 CLI")
    if (a.package == "jax" or a.matmul == "bf16" or a.swap) and Path(
            a.tree).resolve() != ROOT:
        raise SystemExit("--package jax, --matmul bf16 and --swap run this checkout's tree")
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    if not a.summarize_only:
        earlier = sorted(p.name for p in out.glob("*_s[0-9]*.json"))
        if earlier:
            sys.stderr.write(f"{out} already holds {len(earlier)} records, read into "
                             f"this result too: {' '.join(earlier)}\n")
        run_seeds(a, extra, out)
    line = json.dumps(summarize(out, apart=a.apart))
    Path(a.result or out / "result.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
