"""The port's learning curve against a JAX package run's.

    python3 tools/learning_check.py [--recipe l2|flagship|flagship100k]
        [--actor-fusion 8] [--resume CKPT] [--stop-at STEP] [--out DIR]
    python3 tools/learning_check.py --recipe flagship --holdout-only \
        --resume CKPT --out DIR
    python3 tools/learning_check.py --recipe flagship100k --summarize-only \
        --out DIR [--against RECORD]

Runs ``python -m tetris_piclim_tpu_torch train`` with the flags of a JAX
run and reads the JAX run's training win rates beside the port's.

``--recipe l2`` (the default) is the JAX package's first DQN run, behind
``results/train_L2M20_v2_summary.json`` (``docs/RESULTS.md``, "DQN
learning"): L=2/M=20, 4096 envs, a 4096-row device-carved bank, 100k steps
(409.6M env steps) in 10k-step chunks, a 4096-episode greedy evaluation,
seed 0, every other flag at its default (the per-step path unless
``--actor-fusion K``). The band: greedy win rate within ``--band`` of the
JAX run's 0.5632, and the training win rate within ``--band`` of the JAX
run's at 41M / 123M / 246M / 410M env steps.

``--recipe flagship`` is the flag set behind the README's held-out win
rates at L=5/M=25, as ``tools/round4a.sh`` stage C ran it (``--model conv
--dueling --joint --updates 4 --num-envs 2048 --bank 4096 --device-bank
--device-refresh 1 --device-forward 0.25``, 1000-step chunks, seed 0) for
its 500k steps (1.024G env steps), ending in its held-out evaluation
(``--eval-holdout --holdout-bank 2048``, 8192 greedy episodes). Its rows
are read from ``results/train_r4_L5df500.log``; the band holds the
training win rate at 25k / 50k / 75k / 100k / 150k / 200k / 300k / 400k /
500k steps (0.100 / 0.396 / 0.520 / 0.579 / 0.648 / 0.686 / 0.737 / 0.762
/ 0.791), and the ``held_out`` block holds the port's held-out evaluation
against the log's ``final_eval`` line: held-out in all within 0.03,
carve and forward within 0.05, greedy on the training bank within 0.03
(about five standard errors of 8192 episodes cycling 2048, 1024 and 1024
fixed rows; JAX has one seed, so training noise comes on top).

``--recipe flagship100k`` is the same flag set for 100k steps with a
4096-episode evaluation on the training bank and no held-out evaluation in
the run, as ``tools/round3e.sh`` stage 1 ran it (``results/train_r3_L5df.log``,
whose 100 rows are the first 100 of the 500k run's). JAX read that run's
held-out win rates afterwards, with ``cli eval`` on a 2048-row held-out bank
and 8192 episodes (``results/eval_r3_L5df.json``); ``--holdout-only`` is that
reading here. The band holds the training win rate at 25k / 50k / 75k /
100k (0.100 / 0.396 / 0.520 / 0.579), and the ``held_out`` block the four
rows above against the eval JSON's held-out win rates and the train log's
``final_eval`` (the training bank). The eval JSON's own greedy win rate on
a training bank (``"bank"``; the file does not say whether that bank was
restored or filled anew) stands beside the port's, with no band.

Either run checkpoints every ``--checkpoint-every`` steps (25k for ``l2``,
10k for ``flagship``) into ``OUT/ckpt/step_<n>``, so a run can span several
calls: ``--stop-at STEP`` ends this call at that step (the train process
ends normally and writes ``OUT/ckpt/final``), and ``--resume
OUT/ckpt/final`` (or ``step_<n>``) trains on from there. A resumed run
restores the whole train state (weights, optimizer, replay ring, envs,
generators); the device bank is filled anew from the seed, and a
``--device-refresh`` run draws its refresh seeds from the start of their
stream again, so across a resume the bank's rows are not those of one
unbroken run (unless ``--continue-run``, below). No flag of the flagship
recipe reads the total ``--steps`` (each call passes ``cli train`` its
own segment's length): epsilon decays by a constant, the forward height
is fixed at 4 and PER is off.

The held-out evaluation runs only in the segment that ends at ``--steps``
(``cli train --eval-holdout``). ``--holdout-only`` reads it from the
``--resume`` checkpoint instead, with ``cli eval --checkpoint CKPT
--restore-bank CKPT --eval-holdout`` (the checkpoint's weights and its live
training bank), and trains nothing: a reading of a run stopped short of
``--steps``, or of one whose last segment was cut. Either writes
``OUT/holdout_<step>.json`` (the evaluation's JSON, its held-out rows'
provenance and build time) and the held-out rows to ``OUT/holdout_<step>/``.

Each call's ``train`` output goes to ``OUT/segment_<first step>.log`` and
its record (steps, wall time, the card, the host's load) to
``OUT/segment_<first step>.json``; the curve is read back from every
segment in OUT (a later segment's rows replace an earlier one's from its
first step on), so a call cut at its time limit loses only the steps after
its last checkpoint. After every call OUT keeps one checkpoint, the
newest: the 131072-row replay ring, the weights and the optimizer moments,
~16 MB for the MLP and ~47 MB for the flagship's conv net.

``--continue-run`` (with ``--resume``) passes ``cli train --continue-run``:
the call goes on with the run as one unbroken call would have (the chunk
count and the bank's refresh seeds carry on from the checkpoint's step),
so a run cut at its time limit goes on from its last checkpoint with the
bits of an unbroken run. A segment that starts before an earlier
segment's last row logs those steps again; ``overlaps`` in the result says
whether each such row is the same in both.

``--against RECORD`` sets an earlier result JSON of this tool beside the
run (under ``against``): the steps at which both have a row with the same
training win rate and loss, the first step where they part, and each run's
mean gap to JAX per ``--window`` steps. ``--summarize-only`` trains and
evaluates nothing: it prints (and writes to ``OUT/result.json``) the run
as OUT holds it.

A held-out reading also splits the forward family by where its rows came
from: ``make_holdout_bank`` lays out the host DFS solver's rows first, then
the device beam prover's (``holdout.build`` counts each). The tool plays the
reading's checkpoint on each part in turn, with the episodes and draws of
``cli eval`` (``forward_by_provenance`` in ``OUT/holdout_<step>.json`` and in
the ``held_out`` block), and again on the whole forward family, which must
give the reading's forward win rate. The banded forward row stays the
whole family's. At L=5/M=25 it also plays the checkpoint once on each of
JAX's own held-out rows of that task, carried in
``results/jax_holdout_rows_L5M25.npz`` (``tools/jax_holdout_rows.py
--save``): JAX's beam rows and carves and its first host rows, and from
them the forward family and the whole bank JAX's reading would have held
had its host proved 0, 71 or 96 rows (``on_jax_rows``). The rows are
identical inputs for both packages, so the card needs no JAX for it.

Prints one JSON line, and writes it to ``OUT/result.json``: the run's
``bank_stream`` (``BANK_STREAM``), the port's training win rate at each
chunk beside the JAX run's, the band check, the
newest held-out reading against JAX's, each segment's env-steps/s and wall
time beside the card's name and power limit as ``nvidia-smi`` gives them,
and the rows around each resume. A call stopped by ``--timeout`` prints
the curve so far and exits with 124. The JAX runs' files are only read.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
REFERENCE = ROOT / "results" / "train_L2M20_v2_summary.json"
FLAGSHIP_REFERENCE = ROOT / "results" / "train_r4_L5df500.log"
FLAGSHIP100K_REFERENCE = ROOT / "results" / "train_r3_L5df.log"
FLAGSHIP100K_EVAL = ROOT / "results" / "eval_r3_L5df.json"
# How the device bank's unseeded fills and refreshes are seeded: from the
# bank's ``random.Random`` in the JAX bank's order. Results without the key
# were made while the bank's stream was the trainer's (seeded with the run's
# own seed on the same device).
BANK_STREAM = "jax_order"
# JAX's own held-out rows of a task (``tools/jax_holdout_rows.py --save``),
# and the host row counts h whose forward family a reading plays
JAX_ROWS = {(5, 25): ROOT / "results" / "jax_holdout_rows_L5M25.npz"}
JAX_HOST_ROWS = (0, 71, 96)

# each recipe's task, sizes, train flags, JAX run, evaluation and band rows
RECIPES = {
    "l2": {"lines": 2, "moves": 20, "num_envs": 4096, "bank": 4096,
           "steps": 100_000, "log_every": 10_000, "checkpoint_every": 25_000,
           "eval_episodes": 4096, "eval_holdout": False, "holdout_bank": 1024,
           "reference": str(REFERENCE), "band_steps": "10000,30000,60000,100000",
           "model_flags": [], "flags": []},
    "flagship": {"lines": 5, "moves": 25, "num_envs": 2048, "bank": 4096,
                 "steps": 500_000, "log_every": 1000, "checkpoint_every": 10_000,
                 "eval_episodes": 8192, "eval_holdout": True, "holdout_bank": 2048,
                 "reference": str(FLAGSHIP_REFERENCE),
                 "band_steps": "25000,50000,75000,100000,150000,200000,"
                               "300000,400000,500000",
                 "model_flags": ["--model", "conv", "--dueling", "--joint"],
                 "flags": ["--updates", "4", "--device-refresh", "1",
                           "--device-forward", "0.25"]},
}
RECIPES["flagship100k"] = {
    **RECIPES["flagship"], "steps": 100_000, "eval_episodes": 4096,
    "eval_holdout": False, "reference": str(FLAGSHIP100K_REFERENCE),
    "reference_eval": str(FLAGSHIP100K_EVAL), "holdout_episodes": 8192,
    "band_steps": "25000,50000,75000,100000"}

# the held-out block: (key in either evaluation JSON, band); the training
# bank is "train_bank" after ``cli train`` and "bank" after ``cli eval``
HELD_OUT = {"holdout": ("holdout", 0.03), "carve": ("holdout_carve", 0.05),
            "forward": ("holdout_forward", 0.05), "train_bank": ("train_bank", 0.03)}

# one row of DQNTrainer.train's log
_ROW = re.compile(r"^\[\s*(\d+)\] env_steps=(\S+) win_rate=(\S+) loss=(\S+) "
                  r"eps=(\S+) sps=(\S+)")
_SEGMENT = re.compile(r"^segment_(\d+)\.log$")
_HOLDOUT = re.compile(r"^holdout_(\d+)\.json$")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", choices=sorted(RECIPES), default="l2",
                   help="the JAX run to follow; it sets the defaults of the "
                        "task, sizes, reference and band steps")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("-L", "--lines", type=int)
    p.add_argument("-M", "--moves", type=int)
    p.add_argument("--num-envs", type=int)
    p.add_argument("--bank", type=int)
    p.add_argument("--steps", type=int, help="the whole run's length")
    p.add_argument("--log-every", type=int)
    p.add_argument("--eval-episodes", type=int)
    p.add_argument("--holdout-bank", type=int, metavar="N")
    p.add_argument("--holdout-episodes", type=int, metavar="N",
                   help="greedy episodes of a --holdout-only reading "
                        "(default: --eval-episodes)")
    p.add_argument("--holdout-only", action="store_true",
                   help="train nothing: read the held-out evaluation of the "
                        "--resume checkpoint with cli eval")
    p.add_argument("--summarize-only", action="store_true",
                   help="train and evaluate nothing: the run as OUT holds it")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--actor-fusion", type=int, default=0, metavar="K")
    p.add_argument("--checkpoint-every", type=int)
    p.add_argument("--resume", metavar="CKPT",
                   help="a checkpoint this tool wrote (OUT/ckpt/final or step_<n>)")
    p.add_argument("--continue-run", action="store_true",
                   help="with --resume: cli train --continue-run, so the call "
                        "goes on as one unbroken run would")
    p.add_argument("--stop-at", type=int, metavar="STEP",
                   help="end this call at STEP (default: --steps)")
    p.add_argument("--out", default=str(ROOT / "build" / "learning_check"),
                   help="checkpoints and the segments' logs")
    p.add_argument("--reference",
                   help="the JAX run: a summary JSON or a train log (read only)")
    p.add_argument("--reference-eval",
                   help="JAX's cli eval JSON of the run's checkpoint, whose "
                        "held-out win rates join the train log's final_eval")
    p.add_argument("--against", metavar="RECORD",
                   help="an earlier result JSON of this tool: the rows where "
                        "the two runs agree, and each one's mean gap to JAX "
                        "per --window steps")
    p.add_argument("--window", type=int, default=25_000,
                   help="steps per window of the mean gaps (--against)")
    p.add_argument("--band", type=float, default=0.05)
    p.add_argument("--band-steps",
                   help="chunk ends whose training win rates are held to the band")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before the train process is stopped")
    a = p.parse_args(argv)
    for k, v in RECIPES[a.recipe].items():
        if getattr(a, k, None) is None:
            setattr(a, k, v)
    if a.holdout_episodes is None:
        a.holdout_episodes = a.eval_episodes
    return a


def resume_step(ckpt: str) -> int:
    """The global step a checkpoint of ``cli train`` stopped at."""
    import torch

    sd = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu",
                    weights_only=True)
    return int(sd["global_step"])


def train_command(a: argparse.Namespace, steps: int, ckpt_dir: str,
                  holdout_dir: Optional[str] = None) -> list:
    """``cli train`` for one segment of ``steps`` steps; ``holdout_dir``
    (given for the segment that ends at ``--steps``) adds the held-out
    evaluation and keeps its rows there."""
    cmd = [sys.executable, "-m", "tetris_piclim_tpu_torch", "train",
           "-L", str(a.lines), "-M", str(a.moves), "--num-envs", str(a.num_envs),
           "--bank", str(a.bank), "--device-bank", "--steps", str(steps),
           "--log-every", str(a.log_every), "--eval-episodes", str(a.eval_episodes),
           "--seed", str(a.seed), "--actor-fusion", str(a.actor_fusion),
           "--checkpoint", ckpt_dir, "--checkpoint-every", str(a.checkpoint_every),
           "--device", a.device, *a.model_flags, *a.flags]
    if a.resume:
        cmd += ["--resume", a.resume]
        if a.continue_run:
            cmd.append("--continue-run")
    if holdout_dir is not None and a.eval_holdout:
        cmd += ["--eval-holdout", "--holdout-bank", str(a.holdout_bank),
                "--save-holdout", holdout_dir]
    return cmd


def eval_command(a: argparse.Namespace, ckpt: str, holdout_dir: str) -> list:
    """``cli eval`` of a checkpoint on its live training bank and on a
    held-out bank disjoint from it."""
    return [sys.executable, "-m", "tetris_piclim_tpu_torch", "eval",
            "-L", str(a.lines), "-M", str(a.moves), "--bank", str(a.bank),
            *a.model_flags, "--checkpoint", ckpt, "--restore-bank", ckpt,
            "--eval-holdout", "--holdout-bank", str(a.holdout_bank),
            "--episodes", str(a.holdout_episodes), "--seed", str(a.seed),
            "--device", a.device, "--save-holdout", holdout_dir]


def read_rows(text: str, offset: int) -> list[dict]:
    """The chunk rows of one segment's log, at global steps."""
    rows = []
    for line in text.splitlines():
        m = _ROW.match(line.strip())
        if m:
            step = int(m.group(1)) + offset
            rows.append({"step": step, "win_rate": float(m.group(3)),
                         "loss": float(m.group(4)), "sps": float(m.group(6))})
    return rows


def read_reference(path: str, num_envs: int, eval_path: Optional[str] = None) -> dict:
    """The JAX run's rows: a summary JSON as it is, or a ``train`` log's
    chunk rows and its last ``{"final_eval": ...}`` line (the greedy win
    rate on the training bank and, with ``--eval-holdout``, the held-out
    ones), under ``final_eval``; a log without one has no greedy win rate.
    ``eval_path``, a ``cli eval --eval-holdout`` JSON of the run's
    checkpoint, adds its held-out win rates to ``final_eval`` and its
    greedy win rate on a training bank as ``eval_bank``."""
    text = Path(path).read_text()
    if path.endswith(".json"):
        return json.loads(text)
    final = None
    for line in text.splitlines():
        if line.startswith("{") and '"final_eval"' in line:
            final = json.loads(line)["final_eval"]
    ref = {"num_envs": num_envs, "history": read_rows(text, 0),
           "final_greedy_win_rate": None if final is None
           else final["train_bank"]["win_rate"],
           "final_eval": final, "eval_bank": None}
    if eval_path:
        ev = json.loads(Path(eval_path).read_text())
        ref["final_eval"] = {**(final or {}), **{
            k: ev[k] for k in ("holdout", "holdout_carve", "holdout_forward")}}
        ref["eval_bank"] = ev["bank"]
    return ref


def read_curve(out: Path, num_envs: int) -> list[dict]:
    """Every segment's rows in step order; a segment starting at step s
    replaces the rows of earlier segments after s."""
    curve: dict[int, dict] = {}
    segs = sorted((int(m.group(1)), p) for p in out.glob("segment_*.log")
                  if (m := _SEGMENT.match(p.name)))
    for start, path in segs:
        curve = {s: r for s, r in curve.items() if s <= start}
        for r in read_rows(path.read_text(), start):
            curve[r["step"]] = {**r, "env_steps": r["step"] * num_envs}
    return [curve[s] for s in sorted(curve)]


def overlaps(out: Path) -> list[dict]:
    """Where a segment logged steps that an earlier segment had logged too
    (it went on from an older checkpoint than the earlier one's last row):
    the steps both logged, and per step whether the training win rate and
    loss are the same."""
    seen: dict[int, tuple] = {}
    found = []
    segs = sorted((int(m.group(1)), p) for p in out.glob("segment_*.log")
                  if (m := _SEGMENT.match(p.name)))
    for start, path in segs:
        rows = read_rows(path.read_text(), start)
        both = [r for r in rows if r["step"] in seen]
        if both:
            found.append({"segment": start, "steps": [r["step"] for r in both],
                          "equal": [(r["win_rate"], r["loss"]) == seen[r["step"]]
                                    for r in both]})
        seen.update({r["step"]: (r["win_rate"], r["loss"]) for r in rows})
    return found


def held_out_block(reading: Optional[dict], ref: dict) -> dict:
    """The port's held-out reading (``OUT/holdout_<step>.json``, None if
    there is none yet) beside JAX's ``final_eval``, each win rate inside or
    outside its band (None where either side is missing)."""
    port = reading["eval"] if reading else {}
    jax = ref.get("final_eval") or {}
    rows = {}
    for name, (key, width) in HELD_OUT.items():
        ev = port.get(key) or (port.get("bank") if name == "train_bank" else None)
        p = None if ev is None else ev["win_rate"]
        j = jax.get(key, {}).get("win_rate")
        rows[name] = {"port": p, "jax": j, "band": width,
                      "inside": None if p is None or j is None else abs(p - j) <= width}
    verdicts = [r["inside"] for r in rows.values()]
    holdout = port.get("holdout", {})
    eval_bank = ref.get("eval_bank")
    return {"port_step": reading["step"] if reading else None,
            "jax_step": max((int(r["step"]) for r in ref["history"]), default=None),
            "episodes": holdout.get("episodes"), "rows": rows,
            "eval_bank": {"port": (port.get("bank") or {}).get("win_rate"),
                          "jax": None if eval_bank is None else eval_bank["win_rate"],
                          "band": None},
            "families": {"port": holdout.get("families"),
                         "jax": jax.get("holdout", {}).get("families")},
            "build": holdout.get("build"),
            "forward_by_provenance": (reading or {}).get("forward_by_provenance"),
            "on_jax_rows": (reading or {}).get("on_jax_rows"),
            "inside": None if None in verdicts else all(verdicts)}


def compare(curve: list[dict], ref: dict, band: float, band_steps: list[int],
            greedy, held_out: Optional[dict] = None) -> dict:
    """The port's rows beside the JAX run's (matched by step), the band, and
    the held-out block (``held_out`` is the port's newest reading). The
    greedy win rate is held to JAX's only once the curve has reached the
    JAX run's last step."""
    jax_rows = {int(r["step"]): r for r in ref["history"]}
    rows = []
    for r in curve:
        j = jax_rows.get(r["step"])
        rows.append({"step": r["step"], "env_steps": r["env_steps"],
                     "port_win_rate": r["win_rate"],
                     "jax_win_rate": None if j is None else j["win_rate"],
                     "port_loss": r["loss"],
                     "jax_loss": None if j is None else j.get("loss"),
                     "port_sps": r["sps"]})
    by_step = {r["step"]: r for r in rows}
    checks = []
    for s in band_steps:
        r = by_step.get(s)
        jax_wr = jax_rows[s]["win_rate"]
        port_wr = None if r is None else r["port_win_rate"]
        checks.append({"step": s, "env_steps": s * ref["num_envs"],
                       "port": port_wr, "jax": jax_wr,
                       "inside": None if port_wr is None  # not reached yet
                       else abs(port_wr - jax_wr) <= band})
    jax_greedy = ref["final_greedy_win_rate"]
    reached = bool(curve) and curve[-1]["step"] >= max(jax_rows)
    if jax_greedy is None or not reached:  # nothing to hold it to yet
        greedy_ok = None
    else:
        greedy_ok = greedy is not None and abs(greedy - jax_greedy) <= band
    first_out = next((c["step"] for c in checks if c["inside"] is False), None)
    return {"rows": rows,
            "band": {"width": band, "training": checks,
                     "greedy": {"port": greedy, "jax": jax_greedy,
                                "inside": greedy_ok},
                     "first_row_outside": first_out,
                     "inside": greedy_ok is not False and all(
                         c["inside"] for c in checks)},
            "held_out": held_out_block(held_out, ref)}


def window_gaps(rows: list[dict], window: int) -> dict:
    """The mean port - JAX training win rate over the rows of each window
    (steps in ``(k * window, (k + 1) * window]``), keyed by its last step."""
    sums: dict[int, list] = {}
    for r in rows:
        if r["jax_win_rate"] is not None:
            end = -(-r["step"] // window) * window
            sums.setdefault(end, []).append(r["port_win_rate"] - r["jax_win_rate"])
    return {end: sum(g) / len(g) for end, g in sorted(sums.items())}


def against(rows: list[dict], earlier: dict, window: int) -> dict:
    """This run's rows beside an earlier record's at the same steps: how
    many have the same training win rate and loss, the last step up to
    which every row agrees, the first where they part, and each run's mean
    gap to JAX per window."""
    theirs = {r["step"]: r for r in earlier["rows"]}
    both = [r for r in rows if r["step"] in theirs]
    same = [(r["port_win_rate"], r["port_loss"])
            == (theirs[r["step"]]["port_win_rate"], theirs[r["step"]]["port_loss"])
            for r in both]
    first_apart = next((r["step"] for r, eq in zip(both, same) if not eq), None)
    agree = [r["step"] for r in both if first_apart is None or r["step"] < first_apart]
    return {"rows_compared": len(both), "rows_equal": sum(same),
            "equal_through": agree[-1] if agree else None,
            "first_apart": first_apart, "window": window,
            "gap": {"this": window_gaps(rows, window),
                    "earlier": window_gaps(earlier["rows"], window)}}


def boundaries(curve: list[dict], starts: list[int], log_every: int) -> list[dict]:
    """The training win rates from one chunk before each resume to two
    after it: a step in the curve there would be the resume's doing."""
    wr = {r["step"]: r["win_rate"] for r in curve}
    return [{"step": s, "win_rates": [wr.get(s + k * log_every) for k in (-1, 0, 1, 2)]}
            for s in starts if s > 0]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def keep_newest_checkpoint(ckpt: Path) -> None:
    """Leave one checkpoint in ``ckpt``: ``final`` if the run wrote it, else
    the ``step_<n>`` of the highest n."""
    steps = sorted(ckpt.glob("step_*"), key=lambda p: int(p.name.split("_")[1]))
    keep = ckpt / "final" if (ckpt / "final").exists() else (steps or [None])[-1]
    for old in steps:
        if old != keep:
            shutil.rmtree(old)


def run_logged(cmd: list, log: Path, timeout) -> tuple[int, str]:
    """Run ``cmd`` from the repo's root with its stderr in ``log``; its
    exit code (124 if ``timeout`` stopped it) and its stdout."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    with open(log, "w") as err:
        try:
            proc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=err, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            return 124, ""  # the process is killed; its rows so far count
    if proc.returncode:
        sys.stderr.write(log.read_text()[-4000:])
    return proc.returncode, proc.stdout


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def host_load() -> dict:
    """The host's 1/5/15-minute load averages and its cores: the eager
    trainer's rate moves with them."""
    return {"loadavg": list(os.getloadavg()), "cpus": os.cpu_count()}


def eval_trainer(a: argparse.Namespace, ckpt: str, L: int, M: int):
    """``cli eval``'s trainer on ``ckpt``: its weights and its bank."""
    from tetris_piclim_tpu_torch import cli
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.utils.checkpoint import restore_bank
    from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

    args = cli.build_parser().parse_args(["eval", *a.model_flags])
    cfg = TrainConfig(env=EnvConfig(L=L, M=M), num_envs=64,
                      bank_capacity=a.bank, replay_capacity=8192, seed=a.seed)
    trainer = DQNTrainer(cfg, bank=restore_bank(ckpt, a.device),
                         net=cli._net(args, a.seed), device=a.device)
    trainer.warm_start(ckpt)
    return trainer


def forward_by_provenance(a: argparse.Namespace, ckpt: str, holdout_dir: str,
                          ev: dict) -> dict:
    """The reading's forward win rate on the host DFS solver's rows and on
    the device beam prover's apart, and on the whole forward family again:
    ``ckpt``'s weights on the held-out rows saved in ``holdout_dir``, with
    ``cli eval``'s trainer, episodes and draws (``DQNTrainer.evaluate``)."""
    from tetris_piclim_tpu_torch.gen.bank import FAMILY_FORWARD, ConfigBank
    from tetris_piclim_tpu_torch.utils.checkpoint import restore_bank

    hold = restore_bank(holdout_dir, a.device)
    build, episodes = ev["holdout"]["build"], ev["holdout"]["episodes"]
    n_host, n_dev = build["host_forward"], build["device_forward"]
    if not (hold.family[:n_host + n_dev] == FAMILY_FORWARD).all():
        raise RuntimeError("the held-out bank's first rows are not its forward rows")
    trainer = eval_trainer(a, ckpt, hold.L, hold.M)
    cols, pieces = hold.rows
    out = {}
    for name, lo, hi in (("host_dfs", 0, n_host), ("device_beam", n_host, n_host + n_dev)):
        part = ConfigBank.from_rows(hold.L, hold.M, cols[lo:hi], pieces[lo:hi],
                                    hold.family[lo:hi]) if hi > lo else None
        out[name] = {"rows": hi - lo, "episodes": episodes,
                     "win_rate": None if part is None
                     else trainer.evaluate(episodes, bank=part)["win_rate"]}
    whole = hold.subset(FAMILY_FORWARD)
    out["whole_again"] = (None if whole is None
                          else trainer.evaluate(episodes, bank=whole)["win_rate"])
    return out


def on_jax_rows(a: argparse.Namespace, ckpt: str) -> Optional[dict]:
    """``ckpt``'s policy played once, greedy, on each of JAX's own held-out
    rows of the task (:func:`play_jax_rows`)."""
    if JAX_ROWS.get((a.lines, a.moves)) is None:
        return None
    net = eval_trainer(a, ckpt, a.lines, a.moves).state.net
    return play_jax_rows(net, a.lines, a.moves, a.device)


def play_jax_rows(net, L: int, M: int, device, keep_won: bool = False) -> Optional[dict]:
    """``net`` played once, greedy, on each of JAX's own held-out rows of
    the task (``JAX_ROWS``; None where the task has none): JAX's beam rows
    and carves under its key, and its host DFS rows in order. A JAX bank
    whose host proved h rows holds its first h host rows and its first
    1024 - h beam rows, so for each h of ``JAX_HOST_ROWS`` this gives the
    forward family's win fraction and, with the carves, the held-out
    bank's. ``keep_won`` adds ``won``: each part's rows won as bool
    arrays, the forward family and the whole bank of each h included."""
    path = JAX_ROWS.get((L, M))
    if path is None or not path.exists():
        return None
    import numpy as np

    sys.path.insert(0, str(ROOT / "tools"))
    from holdout_draws import play

    with np.load(path) as z:
        won = {part: play(net, z[f"{part}_boards"], z[f"{part}_pieces"], L, M, device)
               for part in ("beam", "carve", "host")}
    out = {"rows": os.path.relpath(path, ROOT)}
    for part, w in won.items():
        out[part] = {"rows": int(w.size), "won": int(w.sum()),
                     "win_fraction": float(w.mean()) if w.size else None}
    n_fwd = won["beam"].size
    out["by_host_rows"] = []
    parts = dict(won)
    for h in JAX_HOST_ROWS:
        h = min(h, won["host"].size)
        fwd = int(won["host"][:h].sum()) + int(won["beam"][:n_fwd - h].sum())
        out["by_host_rows"].append({
            "host_rows": h, "forward_win_fraction": fwd / n_fwd,
            "holdout_win_fraction": (fwd + int(won["carve"].sum()))
            / (n_fwd + won["carve"].size)})
        parts[f"forward_h{h}"] = np.concatenate([won["host"][:h], won["beam"][:n_fwd - h]])
        parts[f"holdout_h{h}"] = np.concatenate([parts[f"forward_h{h}"], won["carve"]])
    if keep_won:
        out["won"] = parts
    return out


def summarize(a: argparse.Namespace, out: Path) -> dict:
    """The whole run as OUT holds it: every segment's rows, records and
    rates, the band, and the newest held-out reading."""
    ref = read_reference(a.reference, a.num_envs, a.reference_eval)
    curve = read_curve(out, a.num_envs)
    segments = []
    for path in sorted(out.glob("segment_*.json"),
                       key=lambda p: int(p.stem.split("_")[1])):
        seg = json.loads(path.read_text())
        log = out / f"segment_{seg['first_step']}.log"
        seg_rows = read_rows(log.read_text(), seg["first_step"]) if log.exists() else []
        trained_s = sum(a.log_every * a.num_envs / r["sps"] for r in seg_rows)
        seg["env_steps_per_s"] = (len(seg_rows) * a.log_every * a.num_envs / trained_s
                                  if trained_s else None)
        seg["last_step"] = seg_rows[-1]["step"] if seg_rows else seg["first_step"]
        segments.append(seg)
    readings = sorted((int(m.group(1)), p) for p in out.glob("holdout_*.json")
                      if (m := _HOLDOUT.match(p.name)))
    reading = json.loads(readings[-1][1].read_text()) if readings else None
    greedy = segments[-1].get("greedy") if segments else None
    band_steps = [int(s) for s in a.band_steps.split(",")]
    res = {"tool": "learning_check", "recipe": a.recipe, "device": a.device,
           "card": segments[-1]["card"] if segments else None,
           "actor_fusion": a.actor_fusion, "seed": a.seed,
           "bank_stream": BANK_STREAM,
           "task": f"L={a.lines},M={a.moves}", "num_envs": a.num_envs,
           "bank": a.bank, "train_flags": a.model_flags + a.flags, "steps": a.steps,
           "last_step": curve[-1]["step"] if curve else 0,
           "total_env_steps": a.steps * a.num_envs,
           "eval_episodes": a.eval_episodes,
           "holdout_bank": a.holdout_bank if a.eval_holdout or a.reference_eval else None,
           "reference": os.path.relpath(a.reference, ROOT),
           "reference_eval": (os.path.relpath(a.reference_eval, ROOT)
                              if a.reference_eval else None)}
    res.update(compare(curve, ref, a.band, band_steps, greedy, reading))
    trained_s = sum(a.log_every * a.num_envs / r["sps"] for r in curve)
    res["env_steps_per_s"] = (len(curve) * a.log_every * a.num_envs / trained_s
                              if trained_s else None)
    res["wall_s"] = sum(seg["wall_s"] for seg in segments)
    res["segments"] = segments
    res["boundaries"] = boundaries(curve, [seg["first_step"] for seg in segments],
                                   a.log_every)
    res["overlaps"] = overlaps(out)
    res["held_out_readings"] = [json.loads(p.read_text()) for _, p in readings]
    if a.against:
        res["against"] = {"record": os.path.relpath(a.against, ROOT),
                          **against(res["rows"], json.loads(Path(a.against).read_text()),
                                    a.window)}
    return res


def write_result(a: argparse.Namespace, out: Path) -> None:
    line = json.dumps(summarize(a, out))
    (out / "result.json").write_text(line + "\n")
    print(line, flush=True)


def main(argv=None) -> int:
    a = parse(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    if a.summarize_only:
        write_result(a, out)
        return 0
    start = resume_step(a.resume) if a.resume else 0
    t0 = time.perf_counter()
    if a.holdout_only:
        if not a.resume:
            raise SystemExit("--holdout-only reads the --resume checkpoint")
        rc, stdout = run_logged(eval_command(a, a.resume, str(out / f"holdout_{start}")),
                                out / f"holdout_{start}.log", a.timeout)
    else:
        stop = min(a.stop_at or a.steps, a.steps)
        if stop <= start:
            raise SystemExit(f"the checkpoint is at step {start}; this call stops at {stop}")
        load = host_load()
        final = str(out / f"holdout_{stop}") if stop == a.steps else None
        rc, stdout = run_logged(train_command(a, stop - start, str(out / "ckpt"), final),
                                out / f"segment_{start}.log", a.timeout)
        keep_newest_checkpoint(out / "ckpt")
    if rc not in (0, 124):
        return rc
    card_name = card() if a.device == "cuda" else None
    ev = last_json(stdout) if rc == 0 else {}
    if not a.holdout_only:
        seg = {"first_step": start, "stop_step": stop, "timed_out": rc == 124,
               "wall_s": time.perf_counter() - t0, "card": card_name,
               "load_before": load, "load_after": host_load(),
               "greedy": ev.get("train_bank", {}).get("win_rate"),
               "eval_episodes": a.eval_episodes}
        (out / f"segment_{start}.json").write_text(json.dumps(seg) + "\n")
        start = stop
    if "holdout" in ev:
        reading = {"step": start, "source": "eval" if a.holdout_only else "train",
                   "card": card_name, "wall_s": time.perf_counter() - t0, "eval": ev}
        path = out / f"holdout_{start}.json"
        path.write_text(json.dumps(reading) + "\n")  # kept if the split fails
        ckpt = a.resume if a.holdout_only else str(out / "ckpt" / "final")
        reading["forward_by_provenance"] = forward_by_provenance(
            a, ckpt, str(out / f"holdout_{start}"), ev)
        reading["on_jax_rows"] = on_jax_rows(a, ckpt)
        path.write_text(json.dumps(reading) + "\n")
    write_result(a, out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
