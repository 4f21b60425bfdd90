"""JAX's 300k-step curriculum run (``results/curriculum_to_L5.log``) on the
port, split over calls by carrying the trainer's whole state between them.

    python3 tools/curriculum_segment.py segment [--restore STATE] [--stop-at N]
        [--save DIR] -- CLI_CURRICULUM_FLAGS
    python3 tools/curriculum_segment.py run --seeds 0:4 --stop-at N --out DIR
        [--device cuda|cpu] [--timeout S] [-- FLAGS]
    python3 tools/curriculum_segment.py proof --out DIR [--device cuda|cpu] [--timeout S]
        [-- FLAGS]
    python3 tools/curriculum_segment.py summarize --out DIR [--result FILE]
    python3 tools/curriculum_segment.py jax --seeds 0:8 [--concurrent N] --out DIR
        [--timeout S] [-- FLAGS]
    python3 tools/curriculum_segment.py compare --out DIR --jax DIR
        [--port-result FILE ...] [--result FILE]

``segment`` runs the port's own ``cli curriculum`` in this process with the
given flags, from step 0 or from the state ``--restore`` names (a directory
that holds ``state.pt``, or that directory packed by ``tools/ckpt_pack.py``),
up to ``--stop-at`` (default ``--steps``), and writes the state it ends on to
``--save DIR/state.pt``. The state is everything ``CurriculumTrainer``
holds: the online and target nets, ``AmsgradW``'s moments and count, the
replay ring with ``pos`` / ``size`` / priorities / ``max_prio``, the envs,
the device generator's state, ``global_step``, the per-env level array and
the promotion RNG's bit-generator state; with them every recipe flag and
the SHA-256 of the level banks, which are rebuilt from the seed. A state is
restored only under the same flags, on a chunk boundary, with banks of the
same digest; a segment stops only on a chunk boundary or at ``--steps``.
The stderr rows carry the unbroken run's step numbers, and only the
segment that ends at ``--steps`` evaluates and prints the final JSON line.
So the stderr of the segments one after the other is the unbroken run's,
and the last segment's JSON line is its line (``steps_per_s``, a
measurement, aside). ``cli curriculum`` and ``CurriculumTrainer`` are not
changed: the segment puts a subclass of the trainer in the CLI's way.

``run`` starts one ``segment`` process per seed of ``--seeds``, all at
once, with the recipe's flags (``RECIPE``: levels 1:10,2:15,3:20,5:25, 4096
envs, 300000 steps in 10000-step chunks, threshold 0.4, the JAX CLI's
defaults for the rest), ``--seed S --device D`` and the flags after
``--``. Seed S goes on from the newest ``OUT/s<S>/state_<step>.xz`` and
stops at ``--stop-at``; its state is packed to ``OUT/s<S>/state_<stop>.xz``
(``ckpt_pack.pack``: checked word for word before it is written) and the
older packed state and the raw one are deleted. Each segment's record
(rows, final JSON, rate from the rows' arrival times, wall time, exit
code, the card's name and power limit, the host's load, the state's bytes
raw and packed) goes to ``OUT/s<S>/segment_<start>.json`` with its stderr
and stdout beside it. A segment past ``--timeout`` is killed (exit code
124) and leaves no state: the next call runs it again.

``proof`` runs the recipe's full width (the flags after ``--`` shrink it
on the CPU) for ``PROOF_CHUNKS`` chunks of ``PROOF_CHUNK`` steps (or the
``--chunk`` after ``--``) unbroken,
then the same as two segments with the state written, packed, unpacked
and restored between them, and writes ``OUT/proof.json``: whether the
stderr rows, the final JSON and the whole final state (every weight) are
equal word for word.

``summarize`` joins each seed's segments (each must start where the one
before it stopped) and reads the bands, fixed before any run was read, on
the median of the seeds that reached 300000, each with the seeds' mean and
sd (``tools/seed_spread.py``'s ``seed_stats``) and each seed's z:

* level 2's training win rate at 300k within 0.05 of JAX's 0.118 (ROADMAP
  A5's band, the headline); level 1's at 300k within 0.05 of 0.408;
* level 0's at 10k / 20k within 0.05 of 0.173 / 0.366;
* the first entry into level 1 (the first row with an env at level 1 or
  above) within 10000 steps of 30000, into level 2 within 20000 of 140000;
  a seed that never enters counts as later than any step;
* no env at level 3 at 300k (JAX: 0).

The result (``--result``, default ``OUT/result.json``) also holds JAX's rows
and final line, every seed's rows, each segment's rate and wall time, and
``OUT/proof.json`` where it exists. Prints it as one JSON line.

``jax`` is the jax arm: the JAX package's own CLI, ``python -m
tetris_piclim_tpu curriculum`` with the recipe's flags, ``--seed S`` and the
flags after ``--``, on the CPU (``JAX_PLATFORMS=cpu``), each seed unbroken
to the end, ``--concurrent`` at a time. Each run's record (rows, final
JSON, exit code, its env-steps/s on this CPU from the rows' arrival times,
wall time, the host's load) goes to ``OUT/jax_s<S>.json`` with its stderr
and stdout beside it; a run past ``--timeout`` is killed and keeps its rows
(exit code 124).

``compare`` sets that arm (``--jax DIR``) against the port arm (the seeds of
each ``--port-result``, an earlier ``summarize`` result, and the segments in
``--out``) by ``RULE_300K``, fixed before any jax run of the recipe was
read: six readings per run (``readings_300k``), Welch's two-sided t test per
reading, Holm over the six at ``ALPHA``. The result holds both arms' runs
and readings, each arm's mean and sd with their 95% intervals, the
difference's 95% interval, the verdict, JAX's recorded TPU run's readings
and their z on each arm, the runs short of 300000 with their exit codes,
and the bands read on each arm.
"""

from __future__ import annotations

import argparse
import hashlib
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
from ckpt_pack import pack, read_packed, same
from curriculum_check import ALPHA, holm, parse_row, rate, read_log, run_env, stream, welch
from learning_check import card, host_load
from seed_spread import seed_stats

ROOT = Path(__file__).resolve().parents[1]
TOOL = Path(__file__).resolve()
JAX_LOG = ROOT / "results" / "curriculum_to_L5.log"
RECIPE = ["--levels", "1:10,2:15,3:20,5:25", "--num-envs", "4096",
          "--steps", "300000", "--chunk", "10000", "--threshold", "0.4"]
# band -> (kind, level, step, tolerance): a training win rate at a step, the
# first entry into a level, or the envs at a level or above at a step
BANDS = {
    "level2_300k": ("win_rate", 2, 300_000, 0.05),
    "level1_300k": ("win_rate", 1, 300_000, 0.05),
    "level0_10k": ("win_rate", 0, 10_000, 0.05),
    "level0_20k": ("win_rate", 0, 20_000, 0.05),
    "enter_level1": ("entry", 1, None, 10_000),
    "enter_level2": ("entry", 2, None, 20_000),
    "level3_envs_300k": ("envs", 3, 300_000, 0),
}
# the readings RULE_300K compares, one value per run
READINGS_300K = ("level0_10k", "level0_20k", "enter_level1", "enter_level2",
                 "level1_after_entry", "level2_300k")
AFTER_ENTRY = 40_000
RULE_300K = (
    "Six readings per run of the recipe: level 0's training win rate at 10k and at 20k; "
    "the first entry into level 1 and into level 2 (the first row with an env at that "
    "level or above); level 1's training win rate 40000 steps after the run's own entry "
    "into level 1; level 2's training win rate at 300k. A win rate is read only from a "
    "row with an env at its level. A run that reached 300k and never entered a level "
    "enters it one chunk past its last row; a run cut short counts only for the "
    "readings it reached. Level 1 at 300k is not compared: it is read on the 3-64 envs "
    "that promotion leaves behind, so it measures promotion, not learning. Welch's "
    "two-sided t test per reading between the jax arm (the JAX package's own CLI on the "
    "CPU, seeds 0-7) and the port arm (cli curriculum on the H100, seeds 0-7); Holm "
    "over the six readings at alpha 0.01. No reading differs: one distribution on this "
    "recipe, A5 closes, and JAX's recorded TPU run is read as a draw from the jax "
    "arm's spread (its z there per reading). A reading differs: C-5 opens with the "
    "readings, both arms' means and sds and the difference's 95% interval, and the "
    "first step it can be read at; nothing is tuned after an arm is read.")
STEPS = int(RECIPE[RECIPE.index("--steps") + 1])
PROOF_CHUNK, PROOF_CHUNKS = 1000, (2, 2)
STATE = "state.pt"
# what a result keeps of each segment's record
SEGMENT_KEYS = ("start", "stop", "rc", "env_steps_per_s", "wall_s", "concurrent", "card",
                "host", "state_bytes", "state_packed_bytes")
_STEP = re.compile(r"^\[\s*(\d+)\]")


class Refused(SystemExit):
    """A state or a stop the segment will not run from."""


def recipe_of(args: argparse.Namespace) -> dict:
    """Every flag of a parsed ``cli curriculum`` command line."""
    return {k: v for k, v in vars(args).items() if not callable(v) and not k.startswith("_")}


def bank_digest(bank) -> str:
    h = hashlib.sha256()
    for t in bank:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def trainer_state(tr, recipe: dict) -> dict:
    """What ``CurriculumTrainer`` ``tr`` holds, the recipe and the banks'
    digest."""
    import torch

    ts = tr.state
    return {"recipe": recipe, "step": ts.global_step, "bank_sha256": bank_digest(tr.bank),
            "net": ts.net.state_dict(), "target_net": ts.target_net.state_dict(),
            "opt": ts.opt.state_dict(), "replay": ts.replay.state_dict(),
            "env": ts.env._asdict(), "gen": ts.gen.get_state(),
            "level": torch.from_numpy(tr.level.copy()),
            "rng": json.dumps(tr._rng.bit_generator.state)}


def load_state(path) -> dict:
    """A saved state: ``DIR/state.pt``, or that directory packed."""
    import torch

    path = Path(path)
    if path.is_dir():
        return torch.load(path / STATE, map_location="cpu", weights_only=True)
    return read_packed(path)[STATE]


def check(sd: dict, recipe: dict) -> None:
    """Refuse a saved state of other flags or off a chunk boundary."""
    if sd["recipe"] != recipe:
        diff = sorted(k for k in set(recipe) | set(sd["recipe"])
                      if recipe.get(k) != sd["recipe"].get(k))
        raise Refused(f"the carried state's flags differ: {diff}")
    if sd["step"] % recipe["chunk"]:
        raise Refused(f"the carried state's step {sd['step']} is not on a chunk "
                      f"boundary ({recipe['chunk']})")


def restore(tr, sd: dict) -> None:
    """Put a checked saved state into a freshly built trainer ``tr``, or
    refuse it if the rebuilt banks differ."""
    if sd["bank_sha256"] != bank_digest(tr.bank):
        raise Refused("the rebuilt level banks differ from the carried state's")
    ts, dev = tr.state, tr.device
    ts.net.load_state_dict(sd["net"])
    ts.target_net.load_state_dict(sd["target_net"])
    ts.opt.load_state_dict(sd["opt"])
    ts.replay.load_state_dict(sd["replay"])
    ts.env = type(ts.env)(**{k: v.to(dev).contiguous() for k, v in sd["env"].items()})
    ts.gen.set_state(sd["gen"].cpu())
    ts.global_step = int(sd["step"])
    tr.level = sd["level"].numpy().astype(np.int64)
    tr._rng.bit_generator.state = json.loads(sd["rng"])


def parse_flags(flags: list) -> argparse.Namespace:
    from tetris_piclim_tpu_torch import cli

    return cli.build_parser().parse_args(["curriculum", *flags])


class _SegmentEnd(Exception):
    """Raised past the segment's last chunk, before the CLI evaluates."""


def run_segment(flags: list, restore_from=None, stop_at: Optional[int] = None,
                save: Optional[str] = None) -> int:
    """``cli curriculum FLAGS`` from the state at ``restore_from`` (or step
    0) to ``stop_at`` (or ``--steps``), the state it ends on saved to
    ``save``. Returns the CLI's exit code."""
    import torch

    from tetris_piclim_tpu_torch import cli
    from tetris_piclim_tpu_torch.dqn import curriculum_train

    args = parse_flags(flags)
    recipe = recipe_of(args)
    carried = load_state(restore_from) if restore_from is not None else None
    start = int(carried["step"]) if carried is not None else 0
    stop = args.steps if stop_at is None else int(stop_at)
    if carried is not None:
        check(carried, recipe)
    if not start < stop <= args.steps or (stop % args.chunk and stop != args.steps):
        raise Refused(f"a segment from {start} cannot stop at {stop} (chunk "
                      f"{args.chunk}, steps {args.steps})")
    base = curriculum_train.CurriculumTrainer

    class SegmentTrainer(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if carried is not None:
                restore(self, carried)

        def train(self, total_steps, chunk=500, threshold=0.7, fraction=0.5,
                  log_fn=print):
            def shifted(msg):
                m = _STEP.match(msg)
                if m:
                    msg = f"[{int(m.group(1)) + start:>6}]" + msg[m.end():]
                log_fn(msg)

            hist = super().train(stop - start, chunk=chunk, threshold=threshold,
                                 fraction=fraction, log_fn=log_fn and shifted)
            for row in hist:
                row["step"] += start
            if save is not None:
                os.makedirs(save, exist_ok=True)
                torch.save(trainer_state(self, recipe), Path(save) / STATE)
            if stop < total_steps:
                raise _SegmentEnd
            return hist

    curriculum_train.CurriculumTrainer = SegmentTrainer
    try:
        return cli.main(["curriculum", *flags])
    except _SegmentEnd:
        return 0
    finally:
        curriculum_train.CurriculumTrainer = base


# -- many seeds, one segment each ----------------------------------------------

def _env() -> dict:
    """The environment of a ``segment`` process: this checkout first."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))


def segment_command(flags: list, restore_from=None, stop_at=None, save=None) -> list:
    cmd = [sys.executable, str(TOOL), "segment"]
    if restore_from is not None:
        cmd += ["--restore", str(restore_from)]
    if stop_at is not None:
        cmd += ["--stop-at", str(stop_at)]
    if save is not None:
        cmd += ["--save", str(save)]
    return [*cmd, "--", *flags]


def newest_state(seed_dir: Path) -> Optional[Path]:
    states = sorted(seed_dir.glob("state_*.xz"), key=state_step)
    return states[-1] if states else None


def state_step(path: Optional[Path]) -> int:
    """The step of a packed ``state_<step>.xz`` (0 for none)."""
    return 0 if path is None else int(path.name[len("state_"):-len(".xz")])


def run_seeds(seeds: range, stop_at: int, out: Path, device: str, timeout: float,
              extra: list) -> list[dict]:
    """One ``segment`` process per seed, all at once; a record each."""
    env = _env()
    smi = card() if device == "cuda" else None
    runs, t0 = {}, time.perf_counter()
    for s in seeds:
        d = out / f"s{s}"
        d.mkdir(parents=True, exist_ok=True)
        prev = newest_state(d)
        start = state_step(prev)
        flags = [*RECIPE, "--seed", str(s), "--device", device, *extra]
        cmd = segment_command(flags, prev, stop_at, d / f"raw_{stop_at}")
        with open(d / f"segment_{start}.out", "w") as stdout:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=stdout,
                                    stderr=subprocess.PIPE, text=True)
        stamps: list = []
        th = threading.Thread(target=stream, daemon=True,
                              args=(proc, d / f"segment_{start}.log", stamps))
        th.start()
        runs[s] = (d, prev, start, flags, proc, th, stamps)
    recs = []
    for s, (d, prev, start, flags, proc, th, stamps) in runs.items():
        try:
            rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = 124
        wall = time.perf_counter() - t0
        th.join()
        rows, _ = read_log((d / f"segment_{start}.log").read_text())
        _, final = read_log((d / f"segment_{start}.out").read_text())
        packed = None
        raw = d / f"raw_{stop_at}"
        if rc == 0 and (raw / STATE).exists():
            packed = pack(str(raw), str(d / f"state_{stop_at}.xz"))
            (raw / STATE).unlink()
            raw.rmdir()
            if prev is not None:
                prev.unlink()
        rec = {"seed": s, "start": start, "stop": stop_at, "restored_from": (
                   None if prev is None else prev.name), "flags": flags, "rc": rc,
               "rows": rows, "final": final,
               "env_steps_per_s": rate(rows, stamps, parse_flags(flags).num_envs),
               "wall_s": wall, "concurrent": len(runs), "device": device, "card": smi,
               "host": host_load(),
               "state_bytes": None if packed is None else packed["bytes"],
               "state_packed_bytes": None if packed is None else packed["packed_bytes"]}
        (d / f"segment_{start}.json").write_text(json.dumps(rec) + "\n")
        recs.append(rec)
        if rc:
            sys.stderr.write(f"seed {s} segment from {start} exited with {rc}\n")
    return recs


# -- the jax arm: the JAX package's own CLI on the CPU, unbroken ---------------

def jax_command(seed: int, extra: list) -> list:
    return [sys.executable, "-m", "tetris_piclim_tpu", "curriculum", *RECIPE,
            "--seed", str(seed), *extra]


def run_jax_seed(seed: int, out: Path, timeout: float, extra: list,
                 concurrent: int) -> dict:
    """One unbroken JAX run of the recipe on the CPU; its record goes to
    ``OUT/jax_s<seed>.json`` (stderr ``.log``, stdout ``.out``). A run past
    ``timeout`` is killed and keeps its rows (exit code 124)."""
    cmd, stem = jax_command(seed, extra), out / f"jax_s{seed}"
    t0 = time.perf_counter()
    with open(stem.with_suffix(".out"), "w") as stdout:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=run_env(ROOT, "jax"), stdout=stdout,
                                stderr=subprocess.PIPE, text=True)
    stamps: list = []
    th = threading.Thread(target=stream, daemon=True,
                          args=(proc, stem.with_suffix(".log"), stamps))
    th.start()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = 124
    wall = time.perf_counter() - t0
    th.join()
    rows, _ = read_log(stem.with_suffix(".log").read_text())
    _, final = read_log(stem.with_suffix(".out").read_text())
    flags = [*RECIPE, *extra]
    rec = {"package": "jax", "seed": seed, "command": ["python", *cmd[1:]], "flags": flags,
           "device": "cpu", "rc": rc, "rows": rows, "final": final,
           "cpu_env_steps_per_s": rate(rows, stamps, parse_flags(flags).num_envs),
           "wall_s": wall, "concurrent": concurrent, "host": host_load()}
    stem.with_suffix(".json").write_text(json.dumps(rec) + "\n")
    if rc:
        sys.stderr.write(f"jax seed {seed} exited with {rc}\n")
    return rec


def run_jax(seeds: range, concurrent: int, out: Path, timeout: float,
            extra: list) -> list[dict]:
    """The jax arm: each seed of ``seeds`` unbroken, ``concurrent`` at a
    time; each run is given ``timeout`` seconds from its own start."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=concurrent) as pool:
        return list(pool.map(lambda s: run_jax_seed(s, out, timeout, extra, concurrent),
                             seeds))


# -- the proof: two segments against one unbroken run --------------------------

def proof(out: Path, device: str, extra: list, seed: int = 0,
          timeout: Optional[float] = None) -> dict:
    """``PROOF_CHUNKS`` segments of ``PROOF_CHUNK``-step chunks through the
    packed carry against one unbroken run of the same flags; each process
    is given ``timeout`` seconds."""
    first, second = PROOF_CHUNKS
    flags = [*RECIPE, "--chunk", str(PROOF_CHUNK), "--seed", str(seed),
             "--device", device, *extra]
    chunk = parse_flags(flags).chunk
    flags += ["--steps", str((first + second) * chunk)]
    d = out / "proof"
    d.mkdir(parents=True, exist_ok=True)
    env = _env()

    def go(name, **kw) -> dict:
        t0 = time.perf_counter()
        with open(d / f"{name}.out", "w") as o, open(d / f"{name}.log", "w") as e:
            rc = subprocess.run(segment_command(flags, **kw), cwd=ROOT, env=env,
                                stdout=o, stderr=e, timeout=timeout).returncode
        text = (d / f"{name}.log").read_text()
        rows, _ = read_log(text)
        _, final = read_log((d / f"{name}.out").read_text())
        return {"rc": rc, "s": time.perf_counter() - t0, "final": final, "rows": rows,
                "lines": [ln for ln in text.splitlines()
                          if parse_row(ln) or ln.startswith("eval level ")]}

    whole = go("unbroken", save=d / "unbroken")
    a = go("first", stop_at=first * chunk, save=d / "first")
    packed = pack(str(d / "first"), str(d / "first.xz"))
    b = go("second", restore_from=d / "first.xz", save=d / "second")
    sa, sb = (load_state(d / n) for n in ("unbroken", "second"))
    differ = sorted(k for k in sa if not same(sa[k], sb.get(k)))

    def bare(final):
        if final is None:
            return None
        return {**final, "train": {k: v for k, v in final["train"].items()
                                   if k != "steps_per_s"}}

    res = {"flags": flags, "device": device, "card": card() if device == "cuda" else None,
           "chunks": [first, second], "chunk": chunk,
           "rcs": [whole["rc"], a["rc"], b["rc"]],
           "seconds": {"unbroken": whole["s"], "first": a["s"], "second": b["s"]},
           "rows_unbroken": whole["rows"], "rows_segmented": a["rows"] + b["rows"],
           "same_lines": whole["lines"] == a["lines"] + b["lines"],
           "first_prints_no_json": a["final"] is None,
           "same_final": whole["final"] is not None and bare(whole["final"]) == bare(b["final"]),
           "state_keys": sorted(sa), "state_differs": differ,
           "same_state": not differ and sorted(sa) == sorted(sb),
           "state_bytes": packed["bytes"], "state_packed_bytes": packed["packed_bytes"],
           "host": host_load()}
    res["equal"] = (res["rcs"] == [0, 0, 0] and res["same_lines"] and res["same_final"]
                    and res["same_state"] and res["first_prints_no_json"])
    (out / "proof.json").write_text(json.dumps(res) + "\n")
    return res


# -- bands ---------------------------------------------------------------------

def first_entry(rows: list[dict], level: int) -> Optional[int]:
    """The step of the first row with an env at ``level`` or above."""
    for r in rows:
        if any(r["level_distribution"][level:]):
            return r["step"]
    return None


def reading(rows: list[dict], name: str):
    kind, level, step, _ = BANDS[name]
    if kind == "entry":
        return first_entry(rows, level)
    r = next((r for r in rows if r["step"] == step), None)
    if r is None:
        return None
    return (r["win_rate_per_level"][level] if kind == "win_rate"
            else sum(r["level_distribution"][level:]))


def bands(seed_rows: dict, jax_rows: list[dict], steps: int) -> dict:
    """Each band over the seeds whose rows reached ``steps``; unread
    (``holds`` None) when no seed did."""
    out = {}
    done = {s: rows for s, rows in seed_rows.items() if rows and rows[-1]["step"] >= steps}
    for name, (kind, _, _, tol) in BANDS.items():
        jax = reading(jax_rows, name)
        values = {s: reading(rows, name) for s, rows in done.items()}
        x = sorted(np.inf if v is None else v for v in values.values())
        median = float(np.median(x)) if x else None
        if median is not None and not np.isfinite(median):
            median = None
        finite = {s: v for s, v in values.items() if v is not None}
        stats = seed_stats(finite, jax) if finite else {"n": 0}
        sd = stats.get("sd")
        out[name] = {
            "jax": jax, "tolerance": tol, "seeds": values, "median": median,
            **{k: v for k, v in stats.items() if k != "n"}, "n": len(values),
            "never_entered": [s for s, v in values.items() if kind == "entry" and v is None],
            "z": {s: (v - stats["mean"]) / sd if sd else None for s, v in finite.items()},
            "holds": (None if not values else
                      median is not None and abs(median - jax) <= tol)}
    return out


def verdict(b: dict) -> dict:
    held = {k: v["holds"] for k, v in b.items()}
    return {"bands_held": [k for k, v in held.items() if v],
            "bands_missed": [k for k, v in held.items() if v is False],
            "bands_unread": [k for k, v in held.items() if v is None],
            "all_hold": all(v is True for v in held.values())}


def seed_runs(out: Path) -> dict:
    """seed -> its segments in order, joined; raises unless each starts where
    the one before it stopped."""
    runs = {}
    for d in sorted(out.glob("s[0-9]*"), key=lambda p: int(p.name[1:])):
        segs = sorted((json.loads(p.read_text()) for p in d.glob("segment_*.json")),
                      key=lambda r: r["start"])
        at, rows = 0, []
        for seg in segs:
            if seg["start"] != at:
                raise SystemExit(f"{d.name}: a segment starts at {seg['start']}, "
                                 f"the one before it stopped at {at}")
            rows += seg["rows"]
            at = seg["stop"] if seg["rc"] == 0 else at
        runs[int(d.name[1:])] = {"rows": rows, "reached": at, "segments": segs,
                                 "final": segs[-1]["final"] if segs else None}
    return runs


def summarize(out: Path) -> dict:
    jax_rows, jax_final = read_log(JAX_LOG.read_text())
    runs = seed_runs(out)
    b = bands({s: r["rows"] for s, r in runs.items()}, jax_rows, STEPS)
    proof_file = out / "proof.json"
    return {"tool": "curriculum_segment", "recipe": RECIPE,
            "jax": {"log": str(JAX_LOG.relative_to(ROOT)), "rows": jax_rows,
                    "final": jax_final,
                    "readings": {k: reading(jax_rows, k) for k in BANDS}},
            "bands": b, "verdict": verdict(b),
            "proof": json.loads(proof_file.read_text()) if proof_file.exists() else None,
            "cards": sorted({g["card"] for r in runs.values() for g in r["segments"]
                             if g["card"]}),
            "seeds": {s: {"reached": r["reached"], "rows": r["rows"], "final": r["final"],
                          "segments": [{k: g[k] for k in SEGMENT_KEYS}
                                       for g in r["segments"]]}
                      for s, r in runs.items()}}


# -- the jax arm against the port arm, by RULE_300K ----------------------------

def readings_300k(rows: list[dict], ended: bool) -> dict:
    """A run's six readings for ``RULE_300K`` (None where it has none);
    ``ended``: the run reached the recipe's last step."""
    by_step = {r["step"]: r for r in rows}

    def win_rate(step, level):
        r = by_step.get(step)
        return (r["win_rate_per_level"][level]
                if r is not None and r["level_distribution"][level] else None)

    def entry(level):
        at = first_entry(rows, level)
        if at is None and ended and len(rows) > 1:
            at = rows[-1]["step"] + rows[-1]["step"] - rows[-2]["step"]
        return at

    e1 = entry(1)
    return {"level0_10k": win_rate(10_000, 0), "level0_20k": win_rate(20_000, 0),
            "enter_level1": e1, "enter_level2": entry(2),
            "level1_after_entry": None if e1 is None else win_rate(e1 + AFTER_ENTRY, 1),
            "level2_300k": win_rate(STEPS, 2)}


def arm_stats(values: dict, recorded: float) -> dict:
    """``seed_stats`` of one arm with the mean's 95% interval, and JAX's
    recorded run's z on it (``recorded_z``)."""
    from scipy import stats

    out = seed_stats(values, recorded)
    if out["n"] >= 2:
        half = float(stats.t.ppf(0.975, out["n"] - 1)) * out["sd"] / np.sqrt(out["n"])
        out["mean_95"] = [out["mean"] - half, out["mean"] + half]
        out["recorded_z"] = out.pop("jax_z")
    return out


def compare_arms(jax: dict, port: dict, recorded: dict) -> dict:
    """``RULE_300K`` on two arms (seed -> readings), with JAX's recorded
    run's readings (``recorded``) placed on each."""
    out, p = {}, {}
    for name in READINGS_300K:
        vals = {arm: {s: v[name] for s, v in runs.items() if v[name] is not None}
                for arm, runs in (("jax", jax), ("port", port))}
        row = {arm: {"values": v, **arm_stats(v, recorded[name])} if v else {"n": 0}
               for arm, v in vals.items()}
        row["recorded"] = recorded[name]
        x, y = (np.array(list(vals[a].values()), float) for a in ("jax", "port"))
        if x.size >= 2 and y.size >= 2:
            row["port_minus_jax"] = welch(x, y)
            p[name] = row["port_minus_jax"]["p"]
        out[name] = row
    rejected = holm(p)
    for name in p:
        out[name]["rejected"] = rejected[name]
    differs = [k for k, v in rejected.items() if v]
    return {"rule": RULE_300K, "alpha": ALPHA, "readings": out, "tested": list(p),
            "differs": differs,
            "one_distribution": len(p) == len(READINGS_300K) and not differs}


def jax_runs(jax_dir: Path) -> dict:
    """seed -> the jax arm's record in ``jax_dir`` (``jax_s<S>.json``)."""
    recs = (json.loads(p.read_text()) for p in jax_dir.glob("jax_s[0-9]*.json"))
    return {r["seed"]: r for r in sorted(recs, key=lambda r: r["seed"])}


def port_runs(out: Path, results: list) -> dict:
    """seed -> the port arm's joined run: the seeds of each earlier
    ``summarize`` result in ``results`` and the segments in ``out``."""
    runs = {}
    for res in results:
        for s, r in json.loads(Path(res).read_text())["seeds"].items():
            runs[int(s)] = {**r, "source": os.path.relpath(Path(res).resolve(), ROOT)}
    for s, r in seed_runs(out).items():
        if s in runs:
            raise SystemExit(f"seed {s} is both in {runs[s]['source']} and in {out}")
        runs[s] = {"reached": r["reached"], "rows": r["rows"], "final": r["final"],
                   "segments": [{k: g[k] for k in SEGMENT_KEYS} for g in r["segments"]],
                   "source": os.path.relpath(out.resolve(), ROOT)}
    return dict(sorted(runs.items()))


def spread(out: Path, jax_dir: Path, results: list) -> dict:
    """The jax arm in ``jax_dir`` against the port arm (``port_runs``) by
    ``RULE_300K``, with the bands read on each arm."""
    jax_rows, jax_final = read_log(JAX_LOG.read_text())
    jr, pr = jax_runs(jax_dir), port_runs(out, results)
    for r in jr.values():
        r["reached"] = r["rows"][-1]["step"] if r["rows"] else 0
    jax_read = {s: readings_300k(r["rows"], r["rc"] == 0 and r["reached"] >= STEPS)
                for s, r in jr.items()}
    port_read = {s: readings_300k(r["rows"], r["reached"] >= STEPS) for s, r in pr.items()}
    recorded = readings_300k(jax_rows, True)
    res = compare_arms(jax_read, port_read, recorded)
    short = ([{"arm": "jax", "seed": s, "reached": r["reached"], "rc": r["rc"]}
              for s, r in jr.items() if r["rc"] or r["reached"] < STEPS]
             + [{"arm": "port", "seed": s, "reached": r["reached"],
                 "rc": [g["rc"] for g in r["segments"]]}
                for s, r in pr.items() if r["reached"] < STEPS])
    return {"tool": "curriculum_segment", "mode": "compare", "recipe": RECIPE, **res,
            "jax_recorded": {"log": str(JAX_LOG.relative_to(ROOT)), "final": jax_final,
                             "readings": recorded, "device": "TPU"},
            "short_runs": short,
            "bands": {"port": bands({s: r["rows"] for s, r in pr.items()}, jax_rows, STEPS),
                      "jax": bands({s: r["rows"] for s, r in jr.items()}, jax_rows, STEPS)},
            "arms": {
                "jax": {"device": "cpu", "package": "tetris_piclim_tpu",
                        "seeds": {s: {**r, "readings": jax_read[s]} for s, r in jr.items()}},
                "port": {"device": "cuda", "package": "tetris_piclim_tpu_torch",
                         "cards": sorted({g["card"] for r in pr.values()
                                          for g in r["segments"] if g["card"]}),
                         "seeds": {s: {**r, "readings": port_read[s]}
                                   for s, r in pr.items()}}}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["segment", "run", "proof", "summarize", "jax", "compare"])
    p.add_argument("--restore", default=None)
    p.add_argument("--stop-at", type=int, default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--seeds", default="0:4", type=lambda s: range(*map(int, s.split(":"))))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--timeout", type=float, default=3000.0)
    p.add_argument("--out", default=str(ROOT / "build" / "curriculum_to_L5"))
    p.add_argument("--result", default=None)
    p.add_argument("--concurrent", type=int, default=4, help="jax: runs at a time")
    p.add_argument("--jax", default=str(ROOT / "build" / "curriculum_to_L5_jax"),
                   help="compare: the jax arm's records")
    p.add_argument("--port-result", action="append", default=[],
                   help="compare: an earlier summarize result whose seeds join the port arm")
    a = p.parse_args(argv)
    if a.mode == "segment":
        return run_segment(extra, a.restore, a.stop_at, a.save)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    if a.mode == "run":
        if a.stop_at is None:
            raise SystemExit("run needs --stop-at")
        run_seeds(a.seeds, a.stop_at, out, a.device, a.timeout, extra)
    elif a.mode == "jax":
        run_jax(a.seeds, a.concurrent, out, a.timeout, extra)
        return 0
    elif a.mode == "proof":
        res = proof(out, a.device, extra, timeout=a.timeout)
        print(json.dumps({k: v for k, v in res.items() if not k.startswith("rows")}),
              flush=True)
        return 0 if res["equal"] else 1
    res = spread(out, Path(a.jax), a.port_result) if a.mode == "compare" else summarize(out)
    line = json.dumps(res)
    Path(a.result or out / "result.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
