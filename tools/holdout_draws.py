"""Many draws of the held-out and training-bank rows by each package, and
the tests that hold the port's draws against JAX's in distribution.

    python3 tools/holdout_draws.py --package port [--device cpu|cuda]
        --task L5M25 [--seeds 0:16] [--families holdout,train] [--reference]
    JAX_PLATFORMS=cpu python3 tools/holdout_draws.py --package jax --task L5M25
    python3 tools/holdout_draws.py --analyze [--seeds A:B] [--dir DIR]
    python3 tools/holdout_draws.py --package jax|port ... --policy NPZ ...
        --check RECORDED.jsonl --out FILE.jsonl
    python3 tools/holdout_draws.py --paired FILE.jsonl

A draw is one bank built from one seed, as the package builds it:

* ``holdout``: ``make_holdout_bank(L, M, 2048, seed=...)`` with no host
  seeds (``forward_seed_budget=0``, ``forward_time_budget_s=0``), so its
  1024 forward rows are the first winners of up to 8 chunks of the device
  beam prover (family ``beam``) and the rest device carves (family
  ``carve``); ``train_bank=None`` on both sides, so the dedup treats them
  alike. The host DFS rows are left out: they are JAX's word for word.
* ``train``: the flagship training bank, ``ConfigBank(L, M, 4096,
  seed=...)`` after ``fill_device(forward_fraction=0.25)`` and one
  ``refresh_device(forward_fraction=0.25)``.

For each bank the tool writes one JSON line per family to
``results/holdout_draws_<task>.jsonl`` (``--out``): the row statistics
(:func:`row_stats`: filled cells, column heights, holes, the pieces by
position), for beam rows the prover's yield (chunks run, candidates,
winners; JAX's counted by wrapping its jitted generator), and for each
policy of the task the rows won by greedy play, one episode per row, on
the port's bitboard evaluator (``agent.greedy_rollout``) whichever
package drew the rows, with each row's outcome as a bit string. On the
card the evaluator runs with TF32 off, and the line carries the card's
name and power limit as ``nvidia-smi`` gives them.

``--package port`` imports no JAX and runs on the CPU or the card;
``--package jax`` imports the JAX package and runs on the CPU (the JAX
package is the reference, and is never run on the card). The seeds are
``SEEDS[a:b]`` of the holdout and ``TRAIN_SEEDS[a:b]`` of the training
bank, disjoint from the held-out bank's own seed (1000003) and the
flagship run's (0); ``--reference`` adds one holdout draw at seed 1000003
(the rows behind the flagship readings), which the tests leave out.

``--analyze [--seeds A:B]`` reads every ``holdout_draws_L<l>M<m>.jsonl``
in ``--dir`` (``results/`` by default), keeps every draw or those of the
seeds given, and prints one JSON line, also written there as
``holdout_draws_analysis[_A_B].json``: for
each task, family and pair of sides (``jax/cpu`` against ``port/cuda``
and ``port/cpu``, and the port's two devices against each other), each
side's mean and standard deviation per draw, and the p-values of Welch's t
and a permutation test on the per-draw win fractions, chi-square tests on
the pooled row histograms (filled cells, highest column, column-height
sum, holes, pieces by position), and Kolmogorov-Smirnov tests on the
per-draw means, the beam yield and the training bank's forward rows, each
with its Holm-adjusted value over all tests of that task and pair, at
alpha 0.01; apart from those, the spread tests (each side's dispersion
index, the per-draw variance of the rows won over its binomial value,
against 1 by chi-square, and the variance ratio of the two sides by F),
Holm-adjusted among themselves; and the reference bank's win fraction with
its z-score within its side's draws.

``--check RECORDED`` rebuilds draws that an earlier run recorded and plays
the ``--policy`` files on them: each rebuilt bank's line must equal its
recorded line (same task, package, device, family and seed) in the row
statistics and, for every policy both lines hold, in the rows won
(``won_hex``); else the tool stops before it writes the line. So new
policies (another training seed of a run) are played on exactly the rows
the recorded policies were played on. Write such lines to a file outside
``--analyze``'s glob (``results/training_seeds_L5M25.jsonl``), so that the
recorded analysis reads what it read.

``--paired FILE`` reads such a file and writes ``FILE``'s stem +
``_analysis.json`` beside it: per task, side (and both sides together)
and family, for each policy against the lines' first policy (the base),
the per-draw difference of their win fractions on the same rows, its mean,
standard deviation and standard error over the draws, a paired t test's
p-value, and the rows only one of the two won; the same in ``pairs`` for
each later policy against each other one before it. The bank's draw
cancels in the pairing: what is left is the gap between the two policies.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RESULTS = ROOT / "results"
HOLDOUT_ROWS, TRAIN_ROWS = 2048, 4096
FORWARD_FRACTION = 0.25                  # the flagship's --device-forward
REFERENCE_SEED = 1_000_003               # make_holdout_bank's default seed
SEEDS = tuple(2_000_000 + i for i in range(64))
TRAIN_SEEDS = tuple(3_000_000 + i for i in range(64))
ALPHA = 0.01
PERMUTATIONS = 99_999
# the task's policies: the port's two flagship policies (100k steps first),
# the TPU-trained one
POLICIES = {
    (5, 25): ("results/flagship_L5M25_100k_h100_policy.npz",
              "results/flagship_L5M25_h100_policy.npz"),
    (2, 20): ("results/tpu_L2M20_v2_params.npz",),
}
# the device-beam rows of the 100k flagship policy's held-out reading, made
# under REFERENCE_SEED after 71 host rows: the first 953 winners of its stream
FLAGSHIP_BEAM_ROWS = 953
H = 20


def task_of(name: str) -> tuple[int, int]:
    m = re.fullmatch(r"L(\d+)M(\d+)", name)
    if not m:
        raise SystemExit(f"task {name!r} is not of the form L<lines>M<moves>")
    return int(m.group(1)), int(m.group(2))


# -- row statistics ------------------------------------------------------------

def _hist(values: np.ndarray) -> dict:
    vals, counts = np.unique(values, return_counts=True)
    return {str(int(v)): int(c) for v, c in zip(vals, counts)}


def row_stats(boards: np.ndarray, pieces: np.ndarray, M: int) -> dict:
    """Statistics of rows ``boards`` bool[n, 20, 10] (row 0 at the top) and
    ``pieces`` int[n, >= M+1]: per row the filled cells, the column heights
    (a column's height is 20 less the row of its topmost filled cell, 0 when
    empty), their maximum and sum, and the holes (empty cells under a
    column's top); histograms of each over the rows and their means; and
    ``pieces``, a [M+1][7] count of each piece at each of the first M+1
    positions."""
    boards = np.asarray(boards, dtype=bool)
    filled = boards.sum(axis=(1, 2))
    any_col = boards.any(axis=1)
    heights = np.where(any_col, H - boards.argmax(axis=1), 0)
    hsum = heights.sum(axis=1)
    holes = hsum - filled
    hmax = heights.max(axis=1)
    p = np.asarray(pieces)[:, :M + 1].astype(np.int64)
    by_pos = np.zeros((M + 1, 7), dtype=np.int64)
    np.add.at(by_pos, (np.broadcast_to(np.arange(M + 1), p.shape), p), 1)
    n = len(boards)
    return {"rows": n,
            "filled": _hist(filled), "max_height": _hist(hmax),
            "height_sum": _hist(hsum), "holes": _hist(holes),
            "mean_filled": float(filled.mean()) if n else None,
            "mean_max_height": float(hmax.mean()) if n else None,
            "mean_height": float(hsum.mean() / 10) if n else None,
            "mean_holes": float(holes.mean()) if n else None,
            "pieces": by_pos.tolist()}


# -- banks -----------------------------------------------------------------------

def port_banks(L: int, M: int, families: list, seed: int, train_seed: int,
               device, holdout_rows: int, train_rows: int) -> list[dict]:
    """The port's banks of one draw: dicts of family, seed, boards bool[n,
    20, 10], pieces int8[n, M+1], the build's seconds and, for beam rows,
    the prover's yield (``make_holdout_bank``'s provenance)."""
    import torch

    from tetris_piclim_tpu_torch.gen.bank import (
        FAMILY_FORWARD, ConfigBank, make_holdout_bank,
    )
    from tetris_piclim_tpu_torch.ops.bitboard import unpack_board

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    out = []
    if "holdout" in families:
        t0 = time.perf_counter()
        hold = make_holdout_bank(L, M, holdout_rows, seed=seed, forward_seed_budget=0,
                                 forward_time_budget_s=0, device=device)
        sync()
        build_s = time.perf_counter() - t0
        boards = unpack_board(hold.cols).cpu().numpy()
        pieces = hold.pieces.cpu().numpy()
        fwd = hold.family == FAMILY_FORWARD
        prov = hold.provenance
        yield_ = {"chunks": prov["beam_chunks"], "candidates": prov["beam_candidates"],
                  "winners": prov["beam_winners"], "rows": int(fwd.sum()),
                  "shortfall": int(holdout_rows * 0.5) - int(fwd.sum())}
        out.append({"family": "beam", "seed": seed, "boards": boards[fwd],
                    "pieces": pieces[fwd], "build_s": build_s, "beam": yield_})
        out.append({"family": "carve", "seed": seed, "boards": boards[~fwd],
                    "pieces": pieces[~fwd], "build_s": build_s})
    if "train" in families:
        t0 = time.perf_counter()
        bank = ConfigBank(L, M, capacity=train_rows, seed=train_seed, device=device)
        bank.fill_device(forward_fraction=FORWARD_FRACTION)
        bank.refresh_device(forward_fraction=FORWARD_FRACTION)
        sync()
        out.append({"family": "train", "seed": train_seed,
                    "boards": unpack_board(bank.cols).cpu().numpy(),
                    "pieces": bank.pieces.cpu().numpy(),
                    "build_s": time.perf_counter() - t0,
                    "forward_rows": int((bank.family == FAMILY_FORWARD).sum())})
    return out


def jax_banks(L: int, M: int, families: list, seed: int, train_seed: int,
              holdout_rows: int, train_rows: int) -> list[dict]:
    """The JAX package's banks of one draw, as :func:`port_banks`. The beam
    prover's yield is counted by wrapping the jitted generator that
    ``make_holdout_bank`` and ``refresh_device`` look up when called."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tetris_piclim_tpu.gen import jax_forward
    from tetris_piclim_tpu.gen.bank import (
        FAMILY_FORWARD, ConfigBank, make_holdout_bank,
    )

    chunks = []
    inner = jax_forward.generate_batch_device_jit

    def counted(*args, **kw):
        fb = inner(*args, **kw)
        chunks.append((int(fb.winnable.shape[0]), int(np.asarray(fb.winnable).sum())))
        return fb

    jax_forward.generate_batch_device_jit = counted
    try:
        out = []
        if "holdout" in families:
            t0 = time.perf_counter()
            hold = make_holdout_bank(L, M, capacity=holdout_rows, seed=seed,
                                     forward_seed_budget=0, forward_time_budget_s=0)
            build_s = time.perf_counter() - t0
            boards = np.asarray(hold.boards).astype(bool)
            pieces = np.asarray(hold.pieces).astype(np.int8)
            fwd = hold._family == FAMILY_FORWARD
            yield_ = {"chunks": len(chunks), "candidates": sum(c for c, _ in chunks),
                      "winners": sum(w for _, w in chunks), "rows": int(fwd.sum()),
                      "shortfall": int(holdout_rows * 0.5) - int(fwd.sum())}
            out.append({"family": "beam", "seed": seed, "boards": boards[fwd],
                        "pieces": pieces[fwd], "build_s": build_s, "beam": yield_})
            out.append({"family": "carve", "seed": seed, "boards": boards[~fwd],
                        "pieces": pieces[~fwd], "build_s": build_s})
        if "train" in families:
            t0 = time.perf_counter()
            bank = ConfigBank(L, M, capacity=train_rows, seed=train_seed)
            bank.fill_device(forward_fraction=FORWARD_FRACTION)
            bank.refresh_device(forward_fraction=FORWARD_FRACTION)
            out.append({"family": "train", "seed": train_seed,
                        "boards": np.asarray(bank.boards).astype(bool),
                        "pieces": np.asarray(bank.pieces).astype(np.int8),
                        "build_s": time.perf_counter() - t0,
                        "forward_rows": int((bank._family == FAMILY_FORWARD).sum())})
        return out
    finally:
        jax_forward.generate_batch_device_jit = inner


# -- play --------------------------------------------------------------------------

def load_policy(path: str, device):
    """The online net of a policy file: a flagship ``.npz``
    (``utils/checkpoint.py::save_policy_npz``) or a JAX train state's
    parameters (``load_flax_npz``), in eval mode on ``device``."""
    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.models.qnet import QNetwork
    from tetris_piclim_tpu_torch.utils.checkpoint import (
        is_policy_npz, load_flax_npz, read_policy_npz,
    )

    if is_policy_npz(path):
        pol = read_policy_npz(path)
        kw = {k: (tuple(v) if k == "channels" else v)
              for k, v in pol["meta"]["net"].items() if k != "model"}
        net = ConvQNetwork(**kw)
        net.load_state_dict(pol["net"])
    else:
        net = QNetwork()
        net.load_state_dict(load_flax_npz(path, "cpu")[0])
    return net.to(device).eval()


def play(net, boards: np.ndarray, pieces: np.ndarray, L: int, M: int,
         device) -> np.ndarray:
    """bool[n]: each row's greedy episode won, on the port's bitboard
    evaluator (``agent.greedy_rollout``, M+1 steps, finished envs frozen)."""
    import torch

    from tetris_piclim_tpu_torch.dqn import agent
    from tetris_piclim_tpu_torch.ops import bitboard as bb

    if len(boards) == 0:
        return np.zeros(0, dtype=bool)
    with torch.no_grad():
        env = bb.make_state_batch(
            bb.pack_board(torch.as_tensor(np.asarray(boards, bool), device=device)),
            torch.as_tensor(np.asarray(pieces, np.int8), device=device), L, M)
        return (agent.greedy_rollout(net, env, M + 1, bb).status == 1).cpu().numpy()


def flagship_rows_equal(boards: np.ndarray, pieces: np.ndarray) -> int:
    """How many leading beam rows equal, board and pieces, the device-beam
    rows of the 100k flagship policy's held-out bank (those after its host
    rows), which were made under the same seed on the card."""
    from tetris_piclim_tpu_torch.ops.bitboard import unpack_board
    from tetris_piclim_tpu_torch.utils.checkpoint import read_policy_npz

    pol = read_policy_npz(str(ROOT / POLICIES[(5, 25)][0]))
    build = pol["meta"]["eval"]["holdout"]["build"]
    lo = build["host_forward"]
    hold = pol["banks"]["holdout"]
    fb = unpack_board(hold.cols[lo:lo + build["device_forward"]]).numpy()
    fp = hold.pieces[lo:lo + build["device_forward"]].numpy()
    n = 0
    while (n < min(len(fb), len(boards)) and np.array_equal(fb[n], boards[n])
           and np.array_equal(fp[n], pieces[n])):
        n += 1
    return n


def card() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def line_key(line: dict) -> tuple:
    return (line["task"], line["package"], line["device"], line["family"], line["seed"])


def check_recorded(line: dict, recorded: Optional[dict]) -> None:
    """Stop unless a rebuilt bank's line is its recorded one: the same row
    statistics (and beam yield), and the same rows won by every policy
    both lines hold (at least one)."""
    where = f"the rebuilt {line['family']} draw at seed {line['seed']} ({side_of(line)})"
    if recorded is None:
        raise SystemExit(f"{where} has no recorded line")
    bad = [k for k in ("stats", "beam", "forward_rows")
           if json.loads(json.dumps(line[k])) != recorded.get(k)]
    shared = sorted(set(line["policies"]) & set(recorded["policies"]))
    if not shared:
        bad.append("no policy in common")
    bad += [f"{name} rows won" for name in shared
            if (line["policies"][name]["rows"], line["policies"][name]["won_hex"])
            != (recorded["policies"][name]["rows"], recorded["policies"][name]["won_hex"])]
    if bad:
        raise SystemExit(f"{where} differs from its recorded line in: {', '.join(bad)}")


def draw(a: argparse.Namespace) -> int:
    L, M = task_of(a.task)
    families = a.families.split(",")
    lo, hi = (int(x) for x in (a.seeds or "0:16").split(":"))
    seeds = list(zip(SEEDS[lo:hi], TRAIN_SEEDS[lo:hi]))
    if a.reference:
        seeds.append((REFERENCE_SEED, None))
    device = a.device
    if a.package == "jax" and device != "cpu":
        raise SystemExit("the JAX package's draws run on the CPU")
    import torch

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    policies = a.policy if a.policy is not None else list(POLICIES.get((L, M), ()))
    nets = {os.path.basename(p): load_policy(str(ROOT / p), device) for p in policies}
    smi = card() if device == "cuda" else None
    out = Path(a.out or RESULTS / f"holdout_draws_{a.task}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    recorded = ({line_key(ln): ln for ln in read_lines([a.check])}
                if a.check else None)
    for seed, train_seed in seeds:
        fams = [f for f in families if train_seed is not None or f == "holdout"]
        if a.package == "port":
            banks = port_banks(L, M, fams, seed, train_seed, device,
                               a.holdout_rows, a.train_rows)
        else:
            banks = jax_banks(L, M, fams, seed, train_seed, a.holdout_rows, a.train_rows)
        for b in banks:
            if b["seed"] == REFERENCE_SEED and b["family"] == "beam" and (L, M) == (5, 25):
                b["flagship_beam_rows_equal"] = flagship_rows_equal(b["boards"], b["pieces"])
            t0 = time.perf_counter()
            won = {name: play(net, b["boards"], b["pieces"], L, M, device)
                   for name, net in nets.items()}
            line = {"tool": "holdout_draws", "task": a.task, "L": L, "M": M,
                    "package": a.package, "device": device, "card": smi,
                    "family": b["family"], "seed": b["seed"],
                    "reference": b["seed"] == REFERENCE_SEED,
                    "build_s": b["build_s"], "play_s": time.perf_counter() - t0,
                    "stats": row_stats(b["boards"], b["pieces"], M),
                    "beam": b.get("beam"), "forward_rows": b.get("forward_rows"),
                    "flagship_beam_rows_equal": b.get("flagship_beam_rows_equal"),
                    "policies": {name: {"rows": int(w.size), "won": int(w.sum()),
                                        "win_fraction": float(w.mean()) if w.size else None,
                                        "won_hex": np.packbits(w).tobytes().hex()}
                                 for name, w in won.items()}}
            if recorded is not None:
                check_recorded(line, recorded.get(line_key(line)))
                line["checked_against"] = os.path.relpath(Path(a.check).resolve(), ROOT)
            with out.open("a") as f:
                f.write(json.dumps(line) + "\n")
            print(json.dumps({k: line[k] for k in ("task", "package", "device", "family",
                                                    "seed", "build_s", "play_s")}
                             | {"win": {k: v["win_fraction"]
                                        for k, v in line["policies"].items()}}),
                  flush=True)
    return 0


# -- analysis ----------------------------------------------------------------------

def read_lines(paths) -> list[dict]:
    """Every line of the files; a later line of the same (package, device,
    family, seed) replaces an earlier one."""
    keep = {}
    for path in paths:
        for text in Path(path).read_text().splitlines():
            if text.strip():
                ln = json.loads(text)
                keep[line_key(ln)] = ln
    return list(keep.values())


def side_of(line: dict) -> str:
    return f"{line['package']}/{line['device']}"


def holm(pvalues: list[float]) -> list[float]:
    """Holm's step-down adjusted p-values, in the input's order."""
    m = len(pvalues)
    order = sorted(range(m), key=lambda i: pvalues[i])
    adj, running = [0.0] * m, 0.0
    for rank, i in enumerate(order):
        running = max(running, min(1.0, (m - rank) * pvalues[i]))
        adj[i] = running
    return adj


def pooled_table(a: list[dict], b: list[dict]) -> np.ndarray:
    """A 2 x k table of two pooled histograms (dicts of value: count), with
    adjacent values merged until every expected count is at least 5."""
    ca, cb = {}, {}
    for h, acc in [(x, ca) for x in a] + [(x, cb) for x in b]:
        for k, v in h.items():
            acc[int(k)] = acc.get(int(k), 0) + v
    values = sorted(set(ca) | set(cb))
    na, nb = sum(ca.values()), sum(cb.values())
    cols, cur = [], [0, 0]
    for v in values:
        cur = [cur[0] + ca.get(v, 0), cur[1] + cb.get(v, 0)]
        tot = cur[0] + cur[1]
        if min(na, nb) * tot / (na + nb) >= 5:
            cols.append(cur)
            cur = [0, 0]
    if cur[0] + cur[1]:
        if cols:
            cols[-1] = [cols[-1][0] + cur[0], cols[-1][1] + cur[1]]
        else:
            cols.append(cur)
    return np.asarray(cols, dtype=np.int64).T


def chi2_p(table: np.ndarray) -> Optional[float]:
    from scipy import stats

    table = table[:, table.sum(axis=0) > 0]
    if table.shape[1] < 2:
        return None
    return float(stats.chi2_contingency(table, correction=False).pvalue)


def permutation_p(x: np.ndarray, y: np.ndarray) -> float:
    from scipy import stats

    res = stats.permutation_test(
        (x, y), lambda u, v, axis: np.mean(u, axis=axis) - np.mean(v, axis=axis),
        permutation_type="independent", vectorized=True, n_resamples=PERMUTATIONS,
        alternative="two-sided", random_state=0)
    return float(res.pvalue)


def spread(x: np.ndarray) -> dict:
    return {"draws": int(x.size), "mean": float(x.mean()),
            "sd": float(x.std(ddof=1)) if x.size > 1 else None,
            "min": float(x.min()), "max": float(x.max())}


def dispersion(won: np.ndarray, rows: int) -> dict:
    """The per-draw variance of the rows won over its binomial value, for
    draws of ``rows`` independent rows: the index (1 expected), the
    binomial standard deviation of a draw's win fraction, and the two-sided
    p of the index's chi-square with K-1 degrees of freedom."""
    from scipy import stats

    k = won.size
    p = won.sum() / (rows * k)
    if k < 2 or p in (0, 1):
        return {"index": None, "binomial_sd": 0.0, "p": None}
    chi2 = float(((won - rows * p) ** 2).sum() / (rows * p * (1 - p)))
    tail = stats.chi2.cdf(chi2, k - 1)
    return {"index": chi2 / (k - 1), "binomial_sd": math.sqrt(p * (1 - p) / rows),
            "p": float(min(1.0, 2 * min(tail, 1 - tail)))}


def variance_ratio_p(x: np.ndarray, y: np.ndarray) -> Optional[float]:
    """Two-sided F test of equal variances."""
    from scipy import stats

    vx, vy = x.var(ddof=1), y.var(ddof=1)
    if vx == 0 or vy == 0:
        return None
    tail = stats.f.cdf(vx / vy, x.size - 1, y.size - 1)
    return float(min(1.0, 2 * min(tail, 1 - tail)))


def compare_family(la: list[dict], lb: list[dict]) -> tuple[dict, list, list]:
    """Each side's spread and the tests of one family between two sides;
    returns (the family's block, the design's (name, p) tests, the spread
    tests: each side's dispersion and the variance ratio)."""
    from scipy import stats

    tests, spread_tests, block = [], [], {"policies": {}, "stats": {}}
    for name in sorted(set(la[0]["policies"]) & set(lb[0]["policies"])):
        x = np.array([ln["policies"][name]["win_fraction"] for ln in la])
        y = np.array([ln["policies"][name]["win_fraction"] for ln in lb])
        rows = la[0]["policies"][name]["rows"]
        da, db = (dispersion(np.array([ln["policies"][name]["won"] for ln in ls]), rows)
                  for ls in (la, lb))
        ratio = variance_ratio_p(x, y)
        spread_tests += [(f"win {name} dispersion {side}", d["p"])
                         for side, d in (("a", da), ("b", db)) if d["p"] is not None]
        spread_tests += [(f"win {name} variance ratio", ratio)] * (ratio is not None)
        welch = float(stats.ttest_ind(x, y, equal_var=False).pvalue)
        welch = None if math.isnan(welch) else welch  # no spread on either side
        perm = permutation_p(x, y)
        block["policies"][name] = {"a": spread(x), "b": spread(y),
                                   "diff": float(x.mean() - y.mean()),
                                   "se_diff": float(math.sqrt(x.var(ddof=1) / x.size
                                                              + y.var(ddof=1) / y.size)),
                                   "welch_p": welch, "permutation_p": perm,
                                   "dispersion_a": da, "dispersion_b": db,
                                   "variance_ratio_p": ratio}
        tests += [(f"win {name} welch", welch)] * (welch is not None)
        tests.append((f"win {name} permutation", perm))
    for key in ("filled", "max_height", "holes", "height_sum"):
        p = chi2_p(pooled_table([ln["stats"][key] for ln in la],
                                [ln["stats"][key] for ln in lb]))
        block["stats"][f"{key}_chi2_p"] = p
        if p is not None:
            tests.append((f"{key} chi2", p))
    pa = np.sum([ln["stats"]["pieces"] for ln in la], axis=0).reshape(-1)
    pb = np.sum([ln["stats"]["pieces"] for ln in lb], axis=0).reshape(-1)
    p = chi2_p(np.stack([pa, pb]))
    block["stats"]["pieces_by_position_chi2_p"] = p
    if p is not None:
        tests.append(("pieces by position chi2", p))
    scalars = {k: lambda ln, k=k: ln["stats"][k]
               for k in ("mean_filled", "mean_max_height", "mean_height", "mean_holes")}
    if la[0].get("beam"):
        scalars["beam_yield"] = lambda ln: ln["beam"]["winners"] / ln["beam"]["candidates"]
        for side, ls in (("a", la), ("b", lb)):
            block[f"beam_{side}"] = {
                k: spread(np.array([ln["beam"][k] for ln in ls], dtype=float))
                for k in ("chunks", "candidates", "winners", "rows", "shortfall")}
    if la[0].get("forward_rows") is not None:
        scalars["forward_rows"] = lambda ln: ln["forward_rows"]
    for key, get in scalars.items():
        x = np.array([get(ln) for ln in la], dtype=float)
        y = np.array([get(ln) for ln in lb], dtype=float)
        p = float(stats.ks_2samp(x, y).pvalue)
        block["stats"][f"{key}_ks_p"] = p
        block["stats"][key] = {"a": spread(x), "b": spread(y)}
        tests.append((f"{key} ks", p))
    return block, tests, spread_tests


PAIRS = (("jax/cpu", "port/cuda"), ("jax/cpu", "port/cpu"), ("port/cpu", "port/cuda"))


def holm_block(tests: list) -> dict:
    adj = holm([p for _, _, p in tests])
    rows = [{"family": f, "test": n, "p": p, "holm_p": q}
            for (f, n, p), q in zip(tests, adj)]
    return {"tests": len(tests), "smallest": sorted(rows, key=lambda r: r["p"])[:5],
            "rejected": [r for r in rows if r["holm_p"] < ALPHA]}


def analyze(lines: list[dict], seeds: Optional[tuple] = None) -> dict:
    """The tests of every task, family and pair of sides, Holm-adjusted
    over all tests of a task and pair; the spread tests apart, adjusted
    among themselves. ``seeds=(a, b)`` keeps the draws of SEEDS[a:b] and
    TRAIN_SEEDS[a:b]."""
    if seeds is not None:
        keep = set(SEEDS[seeds[0]:seeds[1]]) | set(TRAIN_SEEDS[seeds[0]:seeds[1]])
        lines = [ln for ln in lines if ln["reference"] or ln["seed"] in keep]
    res = {"alpha": ALPHA, "permutations": PERMUTATIONS, "seeds": seeds, "tasks": {}}
    for task in sorted({ln["task"] for ln in lines}):
        tl = [ln for ln in lines if ln["task"] == task and not ln["reference"]]
        out = {"pairs": {}, "reference": {}}
        for a_side, b_side in PAIRS:
            fams, tests, spread_tests = {}, [], []
            for fam in ("beam", "carve", "train"):
                la = sorted((ln for ln in tl if side_of(ln) == a_side and ln["family"] == fam),
                            key=lambda ln: ln["seed"])
                lb = sorted((ln for ln in tl if side_of(ln) == b_side and ln["family"] == fam),
                            key=lambda ln: ln["seed"])
                if len(la) < 2 or len(lb) < 2:
                    continue
                fams[fam], t, st = compare_family(la, lb)
                tests += [(fam, name, p) for name, p in t]
                spread_tests += [(fam, name, p) for name, p in st]
            if not fams:
                continue
            out["pairs"][f"{a_side} vs {b_side}"] = {
                "families": fams, **holm_block(tests),
                "spread": holm_block(spread_tests)}
        for ln in lines:
            if ln["task"] == task and ln["reference"]:
                draws = [d for d in tl if side_of(d) == side_of(ln)
                         and d["family"] == ln["family"]]
                out["reference"].setdefault(side_of(ln), {})[ln["family"]] = {
                    "flagship_beam_rows_equal": ln.get("flagship_beam_rows_equal"),
                    **{name: reference_z(v, [d["policies"][name] for d in draws])
                       for name, v in ln["policies"].items()}}
        res["tasks"][task] = out
    return res


def won_rows(policy: dict) -> np.ndarray:
    """bool[rows]: each row's outcome from a line's ``won_hex``."""
    bits = np.unpackbits(np.frombuffer(bytes.fromhex(policy["won_hex"]), np.uint8))
    return bits[:policy["rows"]].astype(bool)


def reference_z(ref: dict, draws: list[dict]) -> dict:
    """The reference bank's win fraction and its z-score within the
    draws' (None with fewer than two draws), on all its rows and on its
    first FLAGSHIP_BEAM_ROWS (the flagship reading's beam rows), each
    draw cut alike."""
    out = {"rows": ref["rows"], "won": ref["won"], "win_fraction": ref["win_fraction"]}
    for key, n in (("z", None), ("prefix", FLAGSHIP_BEAM_ROWS)):
        f = won_rows(ref)[:n].mean()
        x = np.array([won_rows(d)[:n].mean() for d in draws])
        z = float((f - x.mean()) / x.std(ddof=1)) if x.size > 1 else None
        if n is None:
            out["z"] = z
        else:
            out["prefix"] = {"rows": min(n, ref["rows"]),
                             "won": int(won_rows(ref)[:n].sum()),
                             "win_fraction": float(f), "z": z}
    return out


def seed_gap(won: list, base: list) -> dict:
    """One policy against the base on the same draws: ``won`` and ``base``
    hold, per draw, bool[rows] of the rows each won. The per-draw
    difference of the win fractions (mean, sd, standard error, a paired t
    test's two-sided p) and the rows only one of the two won, pooled."""
    from scipy import stats

    d = np.array([w.mean() - b.mean() for w, b in zip(won, base)])
    k = d.size
    sd = float(d.std(ddof=1)) if k > 1 else None
    se = sd / math.sqrt(k) if sd is not None else None
    if se is None:
        p = None
    elif se == 0:  # every draw the same gap
        p = 1.0 if d.mean() == 0 else 0.0
    else:
        p = float(2 * stats.t.sf(abs(d.mean()) / se, k - 1))
    return {"draws": k, "rows": int(sum(w.size for w in won)),
            "win": spread(np.array([w.mean() for w in won])),
            "gap": {"mean": float(d.mean()), "sd": sd, "se": se, "paired_t_p": p,
                    "min": float(d.min()), "max": float(d.max())},
            "rows_only_this": int(sum((w & ~b).sum() for w, b in zip(won, base))),
            "rows_only_base": int(sum((~w & b).sum() for w, b in zip(won, base)))}


def paired(lines: list[dict]) -> dict:
    """Per task, side (and ``all``: every side's draws) and family, each
    policy of the lines against their first policy on the same rows
    (:func:`seed_gap`), and in ``pairs`` each later policy against each
    other one before it (``"B - A"``); reference banks are left out."""
    res = {"tasks": {}}
    for task in sorted({ln["task"] for ln in lines}):
        tl = sorted((ln for ln in lines if ln["task"] == task and not ln["reference"]),
                    key=lambda ln: (side_of(ln), ln["seed"]))
        out = {}
        for side in sorted({side_of(ln) for ln in tl}) + ["all"]:
            for fam in ("beam", "carve", "train"):
                ls = [ln for ln in tl if ln["family"] == fam
                      and side in ("all", side_of(ln))]
                if not ls:
                    continue
                names = list(ls[0]["policies"])
                if any(list(ln["policies"]) != names for ln in ls):
                    raise SystemExit(f"{task} {side} {fam}: the lines hold other policies")
                won = {n: [won_rows(ln["policies"][n]) for ln in ls] for n in names}
                base = won[names[0]]
                out.setdefault(side, {})[fam] = {
                    "base": names[0], "draws": len(ls),
                    "base_win": spread(np.array([b.mean() for b in base])),
                    "policies": {n: seed_gap(won[n], base) for n in names[1:]},
                    "pairs": {f"{n} - {m}": seed_gap(won[n], won[m])
                              for i, m in enumerate(names[1:], 1) for n in names[i + 1:]}}
        res["tasks"][task] = out
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=["port", "jax"])
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--task", default="L5M25")
    p.add_argument("--seeds", metavar="A:B",
                   help="SEEDS[A:B] (and TRAIN_SEEDS[A:B]); default 0:16, and "
                        "for --analyze every draw")
    p.add_argument("--families", default="holdout,train")
    p.add_argument("--reference", action="store_true",
                   help=f"also the holdout at seed {REFERENCE_SEED}")
    p.add_argument("--policy", action="append",
                   help="a policy file (repeatable; default: the task's)")
    p.add_argument("--holdout-rows", type=int, default=HOLDOUT_ROWS)
    p.add_argument("--train-rows", type=int, default=TRAIN_ROWS)
    p.add_argument("--out", help="JSON lines file (default results/holdout_draws_<task>.jsonl)")
    p.add_argument("--check", metavar="RECORDED",
                   help="stop unless each rebuilt draw equals its line in this file")
    p.add_argument("--paired", metavar="FILE",
                   help="the policies' gaps to the first one on the same rows")
    p.add_argument("--analyze", action="store_true")
    p.add_argument("--dir", default=str(RESULTS),
                   help="where --analyze reads the draws and writes its result")
    a = p.parse_args(argv)
    if a.paired:
        src = Path(a.paired)
        text = json.dumps({"lines": os.path.relpath(src.resolve(), ROOT),
                           **paired(read_lines([src]))})
        (src.parent / f"{src.stem}_analysis.json").write_text(text + "\n")
        print(text, flush=True)
        return 0
    if a.analyze:
        d = Path(a.dir)
        seeds = tuple(int(x) for x in a.seeds.split(":")) if a.seeds else None
        res = analyze(read_lines(sorted(d.glob("holdout_draws_L*M*.jsonl"))), seeds)
        text = json.dumps(res)
        name = ("holdout_draws_analysis.json" if seeds is None
                else f"holdout_draws_analysis_{seeds[0]}_{seeds[1]}.json")
        (d / name).write_text(text + "\n")
        print(text, flush=True)
        return 0
    if a.package is None:
        raise SystemExit("--package port|jax (or --analyze)")
    return draw(a)


if __name__ == "__main__":
    sys.exit(main())
