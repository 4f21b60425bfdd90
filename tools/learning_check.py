"""The port's learning curve against the JAX package's first DQN run.

    python3 tools/learning_check.py [--actor-fusion 8] [--resume CKPT] [--out DIR]

Runs ``python -m tetris_piclim_tpu_torch train`` with the flags of the JAX
run behind ``results/train_L2M20_v2_summary.json`` (``docs/RESULTS.md``,
"DQN learning"): L=2/M=20, 4096 envs, a 4096-row device-carved bank,
100k steps (409.6M env steps) in 10k-step chunks, a 4096-episode greedy
evaluation, seed 0, every other flag at its default (the per-step path
unless ``--actor-fusion K``). It checkpoints every ``--checkpoint-every``
steps into ``OUT/ckpt/step_<n>``, so a run can span several calls:
``--resume OUT/ckpt/step_<n>`` trains the remaining steps from there,
exactly where the checkpoint stopped.

Each call's ``train`` output goes to ``OUT/segment_<first step>.log``; the
curve is read back from every segment in OUT (a later segment's rows
replace an earlier one's from its first step on), so a call cut at its
time limit loses only the steps after its last checkpoint. A run that ends
keeps only ``OUT/ckpt/final`` (each checkpoint holds the 131072-row replay
ring, ~16 MB).

Prints one JSON line: the port's training win rate at each chunk beside
the JAX run's, the band check, the greedy win rate, env-steps/s, the wall
time, and (on the GPU) the card's name and power limit as ``nvidia-smi``
gives them. The band: greedy win rate within ``--band`` of the JAX run's
0.5632, and the training win rate within ``--band`` of the JAX run's at
each of ``--band-steps`` (41M / 123M / 246M / 410M env steps). The JAX
summary is only read.
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

# one row of DQNTrainer.train's log
_ROW = re.compile(r"^\[\s*(\d+)\] env_steps=(\S+) win_rate=(\S+) loss=(\S+) "
                  r"eps=(\S+) sps=(\S+)")
_SEGMENT = re.compile(r"^segment_(\d+)\.log$")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("-L", "--lines", type=int, default=2)
    p.add_argument("-M", "--moves", type=int, default=20)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--bank", type=int, default=4096)
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--log-every", type=int, default=10_000)
    p.add_argument("--eval-episodes", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--actor-fusion", type=int, default=0, metavar="K")
    p.add_argument("--checkpoint-every", type=int, default=25_000)
    p.add_argument("--resume", metavar="CKPT",
                   help="a checkpoint this tool wrote (OUT/ckpt/step_<n>)")
    p.add_argument("--out", default=str(ROOT / "build" / "learning_check"),
                   help="checkpoints and the segments' logs")
    p.add_argument("--reference", default=str(REFERENCE),
                   help="the JAX run's summary (read only)")
    p.add_argument("--band", type=float, default=0.05)
    p.add_argument("--band-steps", default="10000,30000,60000,100000",
                   help="chunk ends whose training win rates are held to the band")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before the train process is stopped")
    return p.parse_args(argv)


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
           "--device", a.device]
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
                       "inside": port_wr is not None
                       and abs(port_wr - jax_wr) <= band})
    jax_greedy = ref["final_greedy_win_rate"]
    greedy_ok = greedy is not None and abs(greedy - jax_greedy) <= band
    first_out = next((c["step"] for c in checks if not c["inside"]), None)
    return {"rows": rows,
            "band": {"width": band, "training": checks,
                     "greedy": {"port": greedy, "jax": jax_greedy,
                                "inside": greedy_ok},
                     "first_row_outside": first_out,
                     "inside": greedy_ok and first_out is None}}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    a = parse(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    ref = json.loads(Path(a.reference).read_text())
    band_steps = [int(s) for s in a.band_steps.split(",")]
    start = resume_step(a.resume) if a.resume else 0
    remaining = a.steps - start
    if remaining <= 0:
        raise SystemExit(f"the checkpoint is at step {start} of {a.steps}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    seg = out / f"segment_{start}.log"
    t0 = time.perf_counter()
    with open(seg, "w") as err:
        proc = subprocess.run(train_command(a, remaining, str(out / "ckpt")),
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=err, text=True, timeout=a.timeout)
    wall = time.perf_counter() - t0
    if proc.returncode:
        sys.stderr.write(seg.read_text()[-4000:])
        return proc.returncode
    for old in (out / "ckpt").glob("step_*"):
        shutil.rmtree(old)
    greedy = json.loads(proc.stdout.strip().splitlines()[-1])["train_bank"]["win_rate"]
    curve = read_curve(out, a.num_envs)
    res = {"tool": "learning_check", "device": a.device,
           "card": card() if a.device == "cuda" else None,
           "actor_fusion": a.actor_fusion, "seed": a.seed,
           "task": f"L={a.lines},M={a.moves}", "num_envs": a.num_envs,
           "bank": a.bank, "steps": a.steps, "first_step": start,
           "total_env_steps": a.steps * a.num_envs,
           "eval_episodes": a.eval_episodes}
    res.update(compare(curve, ref, a.band, band_steps, greedy))
    trained_s = sum(a.log_every * a.num_envs / r["sps"] for r in curve)
    res["env_steps_per_s"] = (len(curve) * a.log_every * a.num_envs / trained_s
                              if trained_s else None)
    res["wall_s"] = wall
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
