"""The port's bank draws against JAX's in distribution, and
``tools/holdout_draws.py``.

The generators are held word for word on explicit draws elsewhere
(``test_torch_forward.py``, ``test_torch_generators.py``); here the draws
that the port makes from a ``torch.Generator`` are held against those JAX
makes from its keys: the prefill's and the carver's pieces, rotations and
uniforms (captured from the port's own calls, and rebuilt split by split
for JAX), and the prefill boards they give, at n=4096 and L=2/M=20, by
chi-square and Kolmogorov-Smirnov tests at alpha 0.01 after Holm. Each
test also holds that the same tests reject a sample skewed by a few
percent, so a pass is not for want of power. Fixed seeds: deterministic.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tetris_piclim_tpu.gen import jax_forward as jf
from tetris_piclim_tpu_torch.gen import device_carver as tc
from tetris_piclim_tpu_torch.gen import device_forward as tf
from tetris_piclim_tpu_torch.gen.bank import ConfigBank, make_holdout_bank
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
from tetris_piclim_tpu_torch.ops.bitboard import unpack_board
from tetris_piclim_tpu_torch.utils.checkpoint import save_policy_npz

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import holdout_draws as hd  # noqa: E402

torch.set_num_threads(1)

N, ITERS, ALPHA = 4096, 4, 0.01
L, M = 2, 20


def _captured(monkeypatch, call) -> list:
    """Every tensor that ``torch.randint`` and ``torch.rand`` return during
    ``call()``, in order."""
    got = []
    for name in ("randint", "rand"):
        real = getattr(torch, name)

        def wrapped(*args, _real=real, **kw):
            out = _real(*args, **kw)
            got.append(out)
            return out

        monkeypatch.setattr(torch, name, wrapped)
    call()
    monkeypatch.undo()
    return got


@jax.jit
def _jax_iteration_draws(key):
    """JAX's per-iteration draws of the prefill and the carver, split by
    split (gen/jax_forward.py:105-111, gen/jax_carver.py:85-92): ITERS
    iterations of ``split(key, 4)``, randint(0, 7), randint(0, 4),
    uniform, each over N boards; then the carver's pad after the last
    iteration (:192-196)."""
    def body(k, _):
        k, k_p, k_r, k_l = jax.random.split(k, 4)
        return k, (jax.random.randint(k_p, (N,), 0, 7),
                   jax.random.randint(k_r, (N,), 0, 4),
                   jax.random.uniform(k_l, (N,)))

    k, (piece, rot, u) = jax.lax.scan(body, key, None, length=ITERS)
    pad = jax.random.randint(jax.random.split(k)[1], (N, M + 1), 0, 7, dtype=jnp.int8)
    return piece, rot, u, pad


def _count(x, k: int) -> np.ndarray:
    return np.bincount(np.asarray(x).reshape(-1).astype(np.int64), minlength=k)


def _draw_tests(port: dict, jax_: dict) -> list[float]:
    """p-values: chi-square on each discrete draw's counts, KS on each
    uniform draw."""
    ps = []
    for name, (a, b) in {k: (port[k], jax_[k]) for k in port}.items():
        if name.startswith("u"):
            ps.append(stats.ks_2samp(np.asarray(a).reshape(-1),
                                     np.asarray(b).reshape(-1)).pvalue)
        else:
            k = 7 if name.startswith("piece") or name == "pad" else 4
            ps.append(stats.chi2_contingency(np.stack([_count(a, k), _count(b, k)]),
                                             correction=False).pvalue)
    return ps


def _skewed(d: dict, seed: int) -> dict:
    """The draws with 3% of the pieces set to 0, 3% of the rotations to 0
    and 3% of the uniforms squared: a bias a few percent wide."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, x in d.items():
        x = np.asarray(x).copy()
        hit = rng.random(x.shape) < 0.03
        out[name] = np.where(hit, x * x, x) if name.startswith("u") else np.where(hit, 0, x)
    return out


def _holds(port: dict, jax_: dict, seed: int) -> None:
    ps = _draw_tests(port, jax_)
    assert min(hd.holm(ps)) >= ALPHA, ps
    assert min(hd.holm(_draw_tests(_skewed(port, seed), jax_))) < ALPHA


def test_prefill_draws_match_jax_in_distribution(monkeypatch):
    g = torch.Generator().manual_seed(11)
    got = _captured(monkeypatch, lambda: tf.prefill_boards_device(
        N, max_iters=ITERS, generator=g))
    assert [tuple(t.shape) for t in got] == [(ITERS, N)] * 3
    piece, rot, u, _ = _jax_iteration_draws(jax.random.PRNGKey(11))
    _holds({"piece": got[0], "rot": got[1], "u": got[2]},
           {"piece": piece, "rot": rot, "u": u}, seed=1)


def test_carver_draws_match_jax_in_distribution(monkeypatch):
    g = torch.Generator().manual_seed(12)
    # the carver draws per iteration, then the pad; at ITERS iterations no
    # row is done, so the loop runs them all
    got = _captured(monkeypatch, lambda: tc.generate_batch_device(
        N, L, M, max_iters=ITERS, generator=g))
    assert [tuple(t.shape) for t in got] == [(N,)] * (3 * ITERS) + [(N, M + 1)]
    piece, rot, u, pad = _jax_iteration_draws(jax.random.PRNGKey(12))
    port = {"piece": torch.stack(got[0:-1:3]), "rot": torch.stack(got[1:-1:3]),
            "u": torch.stack(got[2:-1:3]), "pad": got[-1]}
    _holds(port, {"piece": piece, "rot": rot, "u": u, "pad": pad}, seed=2)


def test_prefill_boards_match_jax_in_distribution():
    """The prefill boards themselves (96 iterations, height cap 4): the
    pooled histograms of filled cells, highest column and holes."""
    g = torch.Generator().manual_seed(13)
    port = unpack_board(tf.prefill_boards_device(N, 4, generator=g)).numpy()
    cols = jax.jit(jf.prefill_boards_device, static_argnames=("n",))(
        jax.random.PRNGKey(13), n=N)
    want = unpack_board(torch.as_tensor(np.array(cols).view(np.int32))).numpy()
    pieces = np.zeros((N, M + 1), np.int8)
    sa, sb = hd.row_stats(port, pieces, M), hd.row_stats(want, pieces, M)
    keys = ("filled", "max_height", "holes")
    ps = [hd.chi2_p(hd.pooled_table([sa[k]], [sb[k]])) for k in keys]
    assert min(hd.holm(ps)) >= ALPHA, ps
    # a bias: 5% of the boards emptied
    skew = port.copy()
    skew[np.random.default_rng(3).random(N) < 0.05] = False
    sc = hd.row_stats(skew, pieces, M)
    ps = [hd.chi2_p(hd.pooled_table([sc[k]], [sb[k]])) for k in keys]
    assert min(hd.holm(ps)) < ALPHA


def _board(cells) -> np.ndarray:
    b = np.zeros((20, 10), bool)
    for r, c in cells:
        b[r, c] = True
    return b


def test_row_stats_against_hand_counts():
    # row 0 is the top, row 19 the bottom
    empty = _board([])
    # a bottom row of 9 cells, and a column-3 tower of 3 above it with a
    # gap: (18, 3) empty under (17, 3) and (16, 3)
    tower = _board([(19, c) for c in range(9)] + [(17, 3), (16, 3)])
    # column 0 filled at row 10 only: height 10, 9 holes; column 9 full
    # to row 15: height 5, no hole
    mixed = _board([(10, 0)] + [(r, 9) for r in range(15, 20)])
    pieces = np.array([[0, 1, 2], [6, 6, 6], [0, 0, 3]], np.int8)
    s = hd.row_stats(np.stack([empty, tower, mixed]), pieces, 2)
    # filled: 0, 11, 6; heights: all 0 / 1 x8 + 4 (col 3) / 10 + 5
    assert s["rows"] == 3
    assert s["filled"] == {"0": 1, "11": 1, "6": 1}
    assert s["max_height"] == {"0": 1, "4": 1, "10": 1}
    assert s["height_sum"] == {"0": 1, "12": 1, "15": 1}
    # holes: 0; 12 - 11 = 1 (the gap at (18, 3)); 15 - 6 = 9
    assert s["holes"] == {"0": 1, "1": 1, "9": 1}
    assert s["mean_filled"] == pytest.approx(17 / 3)
    assert s["mean_max_height"] == pytest.approx(14 / 3)
    assert s["mean_height"] == pytest.approx(2.7 / 3)
    assert s["mean_holes"] == pytest.approx(10 / 3)
    assert s["pieces"] == [[2, 0, 0, 0, 0, 0, 1], [1, 1, 0, 0, 0, 0, 1],
                           [0, 0, 1, 1, 0, 0, 1]]


LINE_KEYS = {"tool", "task", "L", "M", "package", "device", "card", "family", "seed",
             "reference", "build_s", "play_s", "stats", "beam", "forward_rows",
             "flagship_beam_rows_equal", "bank_stream", "policies"}


def test_holdout_draws_tool_toy(tmp_path):
    """The tool at L=1/M=8 with 32-row holdouts and 64-row training banks,
    2 seeds a side, a toy conv policy played on every row; then the
    analysis of the lines."""
    hold = make_holdout_bank(1, 8, 16, device="cpu", forward_seed_budget=0)
    train = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
    net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                       generator=torch.Generator().manual_seed(2))
    ev = {"holdout": {"win_rate": 0.5, "build": hold.provenance},
          "holdout_carve": {"win_rate": 0.5}, "holdout_forward": {"win_rate": 0.5}}
    meta = {"L": 1, "M": 8, "step": 10, "eval": ev,
            "net": {"model": "conv", "channels": [4, 8], "dueling": True, "joint": True}}
    policy = tmp_path / "toy_policy.npz"
    save_policy_npz(str(policy), net.state_dict(), {"train": train, "holdout": hold}, meta)
    out = tmp_path / "holdout_draws_L1M8.jsonl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    for package in ("port", "jax"):
        cmd = [sys.executable, str(ROOT / "tools" / "holdout_draws.py"), "--package",
               package, "--task", "L1M8", "--seeds", "0:2", "--holdout-rows", "32",
               "--train-rows", "64", "--policy", str(policy), "--out", str(out)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                             env=env, cwd=str(ROOT))
        assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(t) for t in out.read_text().splitlines()]
    assert len(lines) == 12  # 2 packages x 2 seeds x (beam, carve, train)
    for ln in lines:
        assert set(ln) == LINE_KEYS
        # the port's training banks say how their device stream was seeded
        port_train = (ln["package"], ln["family"]) == ("port", "train")
        assert ln["bank_stream"] == ("jax_order" if port_train else None)
        assert ln["card"] is None and ln["device"] == "cpu" and not ln["reference"]
        pol = ln["policies"]["toy_policy.npz"]
        assert pol["rows"] == ln["stats"]["rows"]
        assert int(hd.won_rows(pol).sum()) == pol["won"]
        assert len(ln["stats"]["pieces"]) == 9
    beam = [ln for ln in lines if ln["family"] == "beam"]
    assert all(ln["stats"]["rows"] == 16 and ln["beam"]["rows"] == 16
               and ln["beam"]["shortfall"] == 0
               and ln["beam"]["winners"] <= ln["beam"]["candidates"]
               and ln["beam"]["chunks"] >= 1 for ln in beam)
    assert sorted(ln["seed"] for ln in beam) == [2_000_000, 2_000_000, 2_000_001, 2_000_001]
    train_lines = [ln for ln in lines if ln["family"] == "train"]
    assert all(ln["stats"]["rows"] == 64 and ln["forward_rows"] == 16
               for ln in train_lines)
    # --analyze reads every holdout_draws_L<l>M<m>.jsonl of --dir
    assert hd.main(["--analyze", "--dir", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "holdout_draws_analysis.json").read_text())
    pair = res["tasks"]["L1M8"]["pairs"]["jax/cpu vs port/cpu"]
    assert set(pair["families"]) == {"beam", "carve", "train"}
    block = pair["families"]["beam"]["policies"]["toy_policy.npz"]
    assert block["a"]["draws"] == block["b"]["draws"] == 2
    assert block["welch_p"] is None or 0 <= block["welch_p"] <= 1
    assert 0 < block["permutation_p"] <= 1
    assert pair["tests"] > 0 and all(0 <= r["p"] <= r["holm_p"] <= 1
                                     for r in pair["smallest"])


def test_holm_and_pooled_table():
    assert hd.holm([0.01, 0.04, 0.03]) == pytest.approx([0.03, 0.06, 0.06])
    t = hd.pooled_table([{"0": 100, "1": 3}, {"2": 1}], [{"0": 90, "1": 9}])
    # values 1 and 2 merge into one column (too few alone)
    assert t.tolist() == [[100, 4], [90, 9]]


def _line(seed: int, family: str, won: dict, side=("port", "cuda")) -> dict:
    """A draw's line with hand-made rows won per policy."""
    return {"task": "L5M25", "package": side[0], "device": side[1], "family": family,
            "seed": seed, "reference": False, "stats": {"rows": len(next(iter(won.values())))},
            "beam": None, "forward_rows": None,
            "policies": {name: {"rows": len(w), "won": int(sum(w)),
                                "win_fraction": sum(w) / len(w),
                                "won_hex": np.packbits(np.array(w, bool)).tobytes().hex()}
                         for name, w in won.items()}}


def test_seed_gap_on_hand_made_bits():
    """``--paired``: each policy against the first on the same rows, draw by
    draw: the mean, sd and standard error of the per-draw gaps, a paired t
    test, and the rows only one of the two won."""
    base = [[1, 1, 0, 0, 1, 0, 1, 0, 1, 1], [0, 1, 1, 1, 0, 0, 0, 1, 1, 0],
            [1, 0, 0, 1, 1, 1, 0, 0, 0, 1]]
    other = [[1, 1, 1, 0, 1, 0, 1, 0, 1, 1], [0, 1, 1, 1, 1, 1, 0, 1, 1, 0],
             [0, 0, 0, 1, 1, 1, 0, 0, 0, 1]]
    lines = [_line(2_000_000 + i, "beam", {"s0.npz": b, "s1.npz": o})
             for i, (b, o) in enumerate(zip(base, other))]
    lines.append(_line(2_000_000, "beam", {"s0.npz": base[0], "s1.npz": base[0]},
                       side=("jax", "cpu")))
    res = hd.paired(lines)["tasks"]["L5M25"]
    blk = res["port/cuda"]["beam"]
    assert blk["base"] == "s0.npz" and blk["draws"] == 3
    gap = blk["policies"]["s1.npz"]
    d = np.array([0.1, 0.2, -0.1])
    assert gap["gap"]["mean"] == pytest.approx(d.mean())
    assert gap["gap"]["sd"] == pytest.approx(d.std(ddof=1))
    assert gap["gap"]["se"] == pytest.approx(d.std(ddof=1) / np.sqrt(3))
    assert gap["gap"]["paired_t_p"] == pytest.approx(
        stats.ttest_rel([np.mean(o) for o in other], [np.mean(b) for b in base]).pvalue)
    assert (gap["rows_only_this"], gap["rows_only_base"]) == (3, 1)
    assert gap["win"]["mean"] == pytest.approx(np.mean([np.mean(o) for o in other]))
    # a side whose every draw has the same gap, and both sides' draws together
    assert res["jax/cpu"]["beam"]["policies"]["s1.npz"]["gap"]["sd"] is None
    assert res["all"]["beam"]["draws"] == 4
    assert res["all"]["beam"]["policies"]["s1.npz"]["gap"]["mean"] == pytest.approx(
        d.sum() / 4)
    same = hd.seed_gap([np.ones(4, bool)] * 2, [np.ones(4, bool)] * 2)["gap"]
    assert (same["mean"], same["sd"], same["paired_t_p"]) == (0.0, 0.0, 1.0)
    # lines that hold other policies are refused
    lines.append(_line(2_000_009, "beam", {"s0.npz": base[0]}))
    with pytest.raises(SystemExit):
        hd.paired(lines)


def test_paired_pairs_of_later_policies():
    """``--paired`` also sets each later policy against each other one before
    it (``pairs``), not only against the first: the gap of seed 2 to seed 1
    is measured without seed 0 in it."""
    b = [[1, 1, 0, 0, 1, 0, 1, 0], [0, 1, 1, 1, 0, 0, 0, 1]]
    s1 = [[1, 1, 1, 0, 1, 0, 1, 0], [0, 1, 1, 1, 1, 1, 0, 1]]
    s2 = [[1, 0, 1, 1, 1, 0, 0, 0], [0, 1, 0, 1, 1, 1, 0, 0]]
    lines = [_line(3_000_000 + i, "carve", {"s0": x, "s1": y, "s2": z})
             for i, (x, y, z) in enumerate(zip(b, s1, s2))]
    blk = hd.paired(lines)["tasks"]["L5M25"]["port/cuda"]["carve"]
    assert list(blk["policies"]) == ["s1", "s2"] and list(blk["pairs"]) == ["s2 - s1"]
    pair = blk["pairs"]["s2 - s1"]
    d = [np.mean(z) - np.mean(y) for y, z in zip(s1, s2)]
    assert pair["gap"]["mean"] == pytest.approx(np.mean(d))
    assert pair["gap"]["sd"] == pytest.approx(np.std(d, ddof=1))
    assert (pair["rows_only_this"], pair["rows_only_base"]) == (1, 4)
    assert pair == hd.seed_gap([np.array(z, bool) for z in s2],
                               [np.array(y, bool) for y in s1])


def test_check_recorded_refuses_another_draw():
    """``--check``: a rebuilt draw passes only if its row statistics and the
    rows each shared policy won are its recorded line's."""
    rec = _line(2_000_000, "beam", {"s0.npz": [1, 0, 1, 1, 0, 0, 1, 0, 1]})
    rebuilt = _line(2_000_000, "beam", {"s0.npz": [1, 0, 1, 1, 0, 0, 1, 0, 1],
                                        "s1.npz": [0, 0, 1, 1, 0, 0, 1, 0, 1]})
    hd.check_recorded(rebuilt, rec)
    flipped = _line(2_000_000, "beam", {"s0.npz": [1, 0, 1, 1, 0, 0, 1, 0, 0]})
    with pytest.raises(SystemExit, match="s0.npz rows won"):
        hd.check_recorded(flipped, rec)
    other_stats = dict(rebuilt, stats={"rows": 9, "filled": {"3": 9}})
    with pytest.raises(SystemExit, match="stats"):
        hd.check_recorded(other_stats, rec)
    with pytest.raises(SystemExit, match="no policy in common"):
        hd.check_recorded(_line(2_000_000, "beam", {"s9.npz": [1] * 9}), rec)
    with pytest.raises(SystemExit, match="no recorded line"):
        hd.check_recorded(rebuilt, None)


def _toy_policy(path: Path, seed: int) -> None:
    hold = make_holdout_bank(1, 8, 16, device="cpu", forward_seed_budget=0)
    train = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
    net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                       generator=torch.Generator().manual_seed(seed))
    ev = {"holdout": {"win_rate": 0.5, "build": hold.provenance},
          "holdout_carve": {"win_rate": 0.5}, "holdout_forward": {"win_rate": 0.5}}
    meta = {"L": 1, "M": 8, "step": 10, "eval": ev,
            "net": {"model": "conv", "channels": [4, 8], "dueling": True, "joint": True}}
    save_policy_npz(str(path), net.state_dict(), {"train": train, "holdout": hold}, meta)


# per package: the families drawn (JAX's CPU jit of the training bank is
# the slow part, so its case draws the holdout alone), and whether the case
# also shows the rebuild stopping at a line of another draw
TOY_RUNS = {"port": ("holdout,train", True), "jax": ("holdout", False)}


@pytest.mark.parametrize("package", sorted(TOY_RUNS))
def test_training_seeds_tool_toy(tmp_path, package):
    """The second training seed's play at L=1/M=8, 2 seeds: draws recorded
    with one policy, rebuilt with ``--check`` and played by two, and the
    paired analysis of the lines; a recorded line that another draw would
    give stops the rebuild."""
    families, refusal = TOY_RUNS[package]
    for seed in (2, 3):
        _toy_policy(tmp_path / f"toy_s{seed}.npz", seed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    base = [sys.executable, str(ROOT / "tools" / "holdout_draws.py"), "--package",
            package, "--task", "L1M8", "--seeds", "0:2", "--holdout-rows", "32",
            "--train-rows", "64", "--families", families,
            "--policy", str(tmp_path / "toy_s2.npz")]
    recorded, out = tmp_path / "holdout_draws_L1M8.jsonl", tmp_path / "seeds_L1M8.jsonl"

    def run(*extra):
        return subprocess.run(base + list(extra), capture_output=True, text=True,
                              timeout=120, env=env, cwd=str(ROOT))

    res = run("--out", str(recorded))
    assert res.returncode == 0, res.stderr[-2000:]
    res = run("--policy", str(tmp_path / "toy_s3.npz"), "--check", str(recorded),
              "--out", str(out))
    assert res.returncode == 0, res.stderr[-2000:]
    rec = {hd.line_key(ln): ln for ln in hd.read_lines([recorded])}
    lines = hd.read_lines([out])
    fams = {"beam", "carve"} | ({"train"} if "train" in families else set())
    assert len(lines) == 2 * len(fams)  # 2 seeds
    for ln in lines:
        assert list(ln["policies"]) == ["toy_s2.npz", "toy_s3.npz"]
        assert ln["checked_against"] == os.path.relpath(recorded, ROOT)
        assert ln["policies"]["toy_s2.npz"] == rec[hd.line_key(ln)]["policies"]["toy_s2.npz"]
    assert hd.main(["--paired", str(out)]) == 0
    got = json.loads((tmp_path / "seeds_L1M8_analysis.json").read_text())
    side = got["tasks"]["L1M8"][f"{package}/cpu"]
    assert set(side) == fams
    for fam, blk in side.items():
        gap = blk["policies"]["toy_s3.npz"]
        fam_lines = [ln for ln in lines if ln["family"] == fam]
        want = np.mean([ln["policies"]["toy_s3.npz"]["win_fraction"]
                        - ln["policies"]["toy_s2.npz"]["win_fraction"] for ln in fam_lines])
        assert blk["draws"] == 2 and gap["gap"]["mean"] == pytest.approx(want)
    if not refusal:
        return
    # a recorded line of another draw: the rebuild stops before writing it
    first = json.loads(recorded.read_text().splitlines()[0])
    bits = bytearray.fromhex(first["policies"]["toy_s2.npz"]["won_hex"])
    bits[0] ^= 0x80  # the first row's outcome flipped
    first["policies"]["toy_s2.npz"]["won_hex"] = bits.hex()
    recorded.write_text(json.dumps(first) + "\n")
    res = run("--check", str(recorded), "--out", str(tmp_path / "refused.jsonl"))
    assert res.returncode != 0 and "differs from its recorded line" in res.stderr
    assert not (tmp_path / "refused.jsonl").exists()
