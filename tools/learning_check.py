"""The port's learning curve against a JAX package run's.

    python3 tools/learning_check.py [--recipe l2|flagship] [--actor-fusion 8]
        [--resume CKPT] [--stop-at STEP] [--out DIR]

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
100k steps (204.8M env steps), less that run's 500k-step held-out
evaluation. Its rows are read from ``results/train_r4_L5df500.log``; the
band holds the training win rate at 25k / 50k / 75k / 100k steps (0.100 /
0.396 / 0.520 / 0.579); the greedy win rate has no JAX counterpart at 100k
and is only reported.

Either run checkpoints every ``--checkpoint-every`` steps (25k for ``l2``,
10k for ``flagship``) into ``OUT/ckpt/step_<n>``, so a run can span several
calls: ``--stop-at STEP`` ends this call at that step (the train process
ends normally and writes ``OUT/ckpt/final``), and ``--resume
OUT/ckpt/final`` (or ``step_<n>``) trains on from there. A resumed run
restores the whole train state (weights, optimizer, replay ring, envs,
generators); the device bank is filled anew from the seed, and a
``--device-refresh`` run draws its refresh seeds from the start of their
stream again, so across a resume the bank's rows are not those of one
unbroken run.

Each call's ``train`` output goes to ``OUT/segment_<first step>.log``; the
curve is read back from every segment in OUT (a later segment's rows
replace an earlier one's from its first step on), so a call cut at its
time limit loses only the steps after its last checkpoint. After every
call OUT keeps one checkpoint, the newest: the 131072-row replay ring,
the weights and the optimizer moments, ~16 MB for the MLP and ~47 MB for
the flagship's conv net.

Prints one JSON line, and writes it to ``OUT/result.json``: the port's
training win rate at each chunk beside the JAX run's, the band check, the
greedy win rate, env-steps/s, the wall time, and (on the GPU) the card's
name and power limit as ``nvidia-smi`` gives them. A call stopped by
``--timeout`` prints the curve so far and exits with 124. The JAX runs'
files are only read.
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

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "results" / "train_L2M20_v2_summary.json"
FLAGSHIP_REFERENCE = ROOT / "results" / "train_r4_L5df500.log"

# each recipe's task, sizes, train flags, JAX run and band rows
RECIPES = {
    "l2": {"lines": 2, "moves": 20, "num_envs": 4096, "bank": 4096,
           "log_every": 10_000, "checkpoint_every": 25_000,
           "reference": str(REFERENCE), "band_steps": "10000,30000,60000,100000",
           "flags": []},
    "flagship": {"lines": 5, "moves": 25, "num_envs": 2048, "bank": 4096,
                 "log_every": 1000, "checkpoint_every": 10_000,
                 "reference": str(FLAGSHIP_REFERENCE),
                 "band_steps": "25000,50000,75000,100000",
                 "flags": ["--model", "conv", "--dueling", "--joint",
                           "--updates", "4", "--device-refresh", "1",
                           "--device-forward", "0.25"]},
}

# one row of DQNTrainer.train's log
_ROW = re.compile(r"^\[\s*(\d+)\] env_steps=(\S+) win_rate=(\S+) loss=(\S+) "
                  r"eps=(\S+) sps=(\S+)")
_SEGMENT = re.compile(r"^segment_(\d+)\.log$")


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
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--log-every", type=int)
    p.add_argument("--eval-episodes", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--actor-fusion", type=int, default=0, metavar="K")
    p.add_argument("--checkpoint-every", type=int)
    p.add_argument("--resume", metavar="CKPT",
                   help="a checkpoint this tool wrote (OUT/ckpt/final or step_<n>)")
    p.add_argument("--stop-at", type=int, metavar="STEP",
                   help="end this call at STEP (default: --steps)")
    p.add_argument("--out", default=str(ROOT / "build" / "learning_check"),
                   help="checkpoints and the segments' logs")
    p.add_argument("--reference",
                   help="the JAX run: a summary JSON or a train log (read only)")
    p.add_argument("--band", type=float, default=0.05)
    p.add_argument("--band-steps",
                   help="chunk ends whose training win rates are held to the band")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before the train process is stopped")
    a = p.parse_args(argv)
    for k, v in RECIPES[a.recipe].items():
        if getattr(a, k, None) is None:
            setattr(a, k, v)
    return a


def resume_step(ckpt: str) -> int:
    """The global step a checkpoint of ``cli train`` stopped at."""
    import torch

    sd = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu",
                    weights_only=True)
    return int(sd["global_step"])


def train_command(a: argparse.Namespace, steps: int, ckpt_dir: str) -> list:
    cmd = [sys.executable, "-m", "tetris_piclim_tpu_torch", "train",
           "-L", str(a.lines), "-M", str(a.moves), "--num-envs", str(a.num_envs),
           "--bank", str(a.bank), "--device-bank", "--steps", str(steps),
           "--log-every", str(a.log_every), "--eval-episodes", str(a.eval_episodes),
           "--seed", str(a.seed), "--actor-fusion", str(a.actor_fusion),
           "--checkpoint", ckpt_dir, "--checkpoint-every", str(a.checkpoint_every),
           "--device", a.device, *a.flags]
    if a.resume:
        cmd += ["--resume", a.resume]
    return cmd


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


def read_reference(path: str, num_envs: int) -> dict:
    """The JAX run's rows: a summary JSON as it is, or a ``train`` log's
    chunk rows (which carry no greedy win rate)."""
    text = Path(path).read_text()
    if path.endswith(".json"):
        return json.loads(text)
    return {"num_envs": num_envs, "final_greedy_win_rate": None,
            "history": read_rows(text, 0)}


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


def compare(curve: list[dict], ref: dict, band: float, band_steps: list[int],
            greedy) -> dict:
    """The port's rows beside the JAX run's (matched by step), and the band."""
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
    if jax_greedy is None:  # nothing to hold the greedy win rate to
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
                         c["inside"] for c in checks)}}


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


def main(argv=None) -> int:
    a = parse(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    ref = read_reference(a.reference, a.num_envs)
    band_steps = [int(s) for s in a.band_steps.split(",")]
    start = resume_step(a.resume) if a.resume else 0
    stop = min(a.stop_at or a.steps, a.steps)
    if stop <= start:
        raise SystemExit(f"the checkpoint is at step {start}; this call stops at {stop}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    seg = out / f"segment_{start}.log"
    t0 = time.perf_counter()
    greedy, rc = None, 0
    with open(seg, "w") as err:
        try:
            proc = subprocess.run(train_command(a, stop - start, str(out / "ckpt")),
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=err, text=True, timeout=a.timeout)
        except subprocess.TimeoutExpired:
            rc = 124  # the train process is killed; its rows so far count
    wall = time.perf_counter() - t0
    keep_newest_checkpoint(out / "ckpt")
    if not rc:
        if proc.returncode:
            sys.stderr.write(seg.read_text()[-4000:])
            return proc.returncode
        greedy = json.loads(proc.stdout.strip().splitlines()[-1])["train_bank"]["win_rate"]
    curve = read_curve(out, a.num_envs)
    res = {"tool": "learning_check", "recipe": a.recipe, "device": a.device,
           "card": card() if a.device == "cuda" else None,
           "actor_fusion": a.actor_fusion, "seed": a.seed,
           "task": f"L={a.lines},M={a.moves}", "num_envs": a.num_envs,
           "bank": a.bank, "train_flags": a.flags, "steps": a.steps,
           "first_step": start, "stop_step": stop, "timed_out": bool(rc),
           "total_env_steps": a.steps * a.num_envs,
           "eval_episodes": a.eval_episodes,
           "reference": os.path.relpath(a.reference, ROOT)}
    res.update(compare(curve, ref, a.band, band_steps, greedy))
    trained_s = sum(a.log_every * a.num_envs / r["sps"] for r in curve)
    res["env_steps_per_s"] = (len(curve) * a.log_every * a.num_envs / trained_s
                              if trained_s else None)
    res["wall_s"] = wall
    line = json.dumps(res)
    (out / "result.json").write_text(line + "\n")
    print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
