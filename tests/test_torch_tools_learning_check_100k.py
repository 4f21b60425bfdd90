"""The port's tools run end to end at tiny sizes on the CPU:
``tools/learning_check.py --recipe flagship100k`` (the 100k recipe against
JAX's run that stops there, its held-out block, ``--against``, overlaps,
``--continue-run``, and the forward family split by provenance). The numbers
are CPU numbers and mean nothing; the shapes of the results are checked."""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch_port_helpers import held_out_reading, run_tool, tiny_run

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


JAX_100K = {"holdout": 0.7978515625, "carve": 0.837646484375,
            "forward": 0.74755859375, "train_bank": 0.831787109375}


BANDS = {"holdout": 0.03, "carve": 0.05, "forward": 0.05, "train_bank": 0.03}


def test_flagship100k_recipe_reads_the_jax_run():
    """``--recipe flagship100k``: the flagship flags for 100k steps with a
    4096-episode evaluation on the training bank and none held out in the
    run, as ``tools/round3e.sh`` stage 1 ran them. JAX's 100 rows
    (``train_r3_L5df.log``) are the first 100 of the 500k run's, and
    ``final_eval`` joins the log's training-bank win rate to the held-out
    ones of ``eval_r3_L5df.json``."""
    import learning_check as lc

    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu"])
    full = lc.parse(["--recipe", "flagship", "--device", "cpu"])
    assert (a.steps, a.eval_episodes, a.eval_holdout, a.holdout_bank,
            a.holdout_episodes) == (100_000, 4096, False, 2048, 8192)
    for k in ("lines", "moves", "num_envs", "bank", "log_every", "checkpoint_every",
              "model_flags", "flags", "seed", "actor_fusion"):
        assert getattr(a, k) == getattr(full, k), k
    cmd = lc.train_command(a, a.steps, "CKPT", "HOLD")
    flags = " ".join(cmd[cmd.index("train") + 1:])
    assert "--steps 100000" in flags and "--eval-episodes 4096" in flags
    assert "--eval-holdout" not in flags  # JAX measured it afterwards
    assert " ".join(lc.eval_command(a, "CKPT", "HOLD")).endswith(
        "--eval-holdout --holdout-bank 2048 --episodes 8192 --seed 0 --device cpu "
        "--save-holdout HOLD")
    assert [int(x) for x in a.band_steps.split(",")] == [25_000, 50_000, 75_000, 100_000]
    ref = lc.read_reference(a.reference, a.num_envs, a.reference_eval)
    whole = lc.read_reference(full.reference, full.num_envs)
    key = lambda rows: [(r["step"], r["win_rate"], r["loss"]) for r in rows]  # noqa: E731
    assert len(ref["history"]) == 100
    assert key(ref["history"]) == key(whole["history"][:100])
    rows = {r["step"]: r["win_rate"] for r in ref["history"]}
    assert [rows[s] for s in (25_000, 50_000, 75_000, 100_000)] == [0.100, 0.396, 0.520, 0.579]
    final = ref["final_eval"]
    assert ref["final_greedy_win_rate"] == final["train_bank"]["win_rate"] == 0.831787109375
    assert final["train_bank"]["episodes"] == 4096
    assert [final[k]["win_rate"] for k in ("holdout", "holdout_carve", "holdout_forward")] == [
        JAX_100K["holdout"], JAX_100K["carve"], JAX_100K["forward"]]
    assert final["holdout"]["families"] == {"carve": 1024, "forward": 1024}
    assert all(final[k]["episodes"] == 8192
               for k in ("holdout", "holdout_carve", "holdout_forward"))
    assert ref["eval_bank"]["win_rate"] == 0.8436279296875
    # the log alone holds no held-out reading
    assert sorted(lc.read_reference(a.reference, a.num_envs)["final_eval"]) == ["train_bank"]


@pytest.mark.parametrize("row,side", [(None, 0)] + [
    (row, side) for row in JAX_100K for side in (1, -1)])
def test_flagship100k_held_out_block(row, side):
    """JAX's 100k held-out block bands the port's reading row by row: every
    row 1e-4 inside its band, or the named row 1e-4 outside it, above or
    below. The eval JSON's own training-bank win rate stands beside the
    port's with no band; the forward family's split by provenance passes
    through."""
    import learning_check as lc

    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu"])
    ref = lc.read_reference(a.reference, a.num_envs, a.reference_eval)
    port = {k: JAX_100K[k] + (BANDS[k] + 1e-4 if k == row else BANDS[k] - 1e-4) * (side or 1)
            for k in JAX_100K}
    reading = held_out_reading(100_000, port["holdout"], port["carve"], port["forward"],
                       port["train_bank"])
    reading["forward_by_provenance"] = {"host_dfs": {"rows": 700, "win_rate": 0.8},
                                        "device_beam": {"rows": 324, "win_rate": 0.6}}
    curve = [{"step": s, "env_steps": 2048 * s, "win_rate": 0.5, "loss": 0.1,
              "sps": 6e4} for s in range(1000, 100_001, 1000)]
    block = lc.compare(curve, ref, 0.05, [], None, reading)["held_out"]
    assert {k: (r["port"], r["jax"], r["band"]) for k, r in block["rows"].items()} == {
        k: (port[k], JAX_100K[k], BANDS[k]) for k in JAX_100K}
    assert {k: r["inside"] for k, r in block["rows"].items()} == {
        k: k != row for k in JAX_100K}
    assert block["inside"] == (row is None)
    assert block["port_step"] == block["jax_step"] == 100_000
    assert block["eval_bank"] == {"port": port["train_bank"], "jax": 0.8436279296875,
                                  "band": None}
    assert block["forward_by_provenance"] == reading["forward_by_provenance"]


def test_learning_check_against_an_earlier_record(tmp_path, capsys):
    """``--summarize-only --against``: the run as OUT holds it beside an
    earlier record, the rows equal up to the first step where they part,
    and each run's mean gap to JAX per 25k-step window."""
    import learning_check as lc

    jax = {r["step"]: r["win_rate"] for r in lc.read_reference(
        str(lc.FLAGSHIP100K_REFERENCE), 2048)["history"]}
    mine = {s: round(w + (0.01 if s <= 50_000 else -0.02), 3) for s, w in jax.items()}
    row = "[{:>7}] env_steps=1.00e+00 win_rate={:.3f} loss=0.1 eps=0.05 sps=6.0e+04\n"
    (tmp_path / "segment_0.log").write_text("".join(row.format(s, w)
                                                    for s, w in mine.items()))
    (tmp_path / "segment_0.json").write_text(json.dumps(
        {"first_step": 0, "stop_step": 100_000, "wall_s": 3400.0,
         "card": "a card", "greedy": 0.83}))
    earlier = [{"step": s, "port_win_rate": mine[s] if s <= 50_000 else round(w + 0.03, 3),
                "port_loss": 0.1, "jax_win_rate": w}
               for s, w in jax.items() if s <= 60_000]
    (tmp_path / "earlier.json").write_text(json.dumps({"rows": earlier}))
    rc = lc.main(["--recipe", "flagship100k", "--device", "cpu", "--out", str(tmp_path),
                  "--summarize-only", "--against", str(tmp_path / "earlier.json")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res == json.loads((tmp_path / "result.json").read_text())
    got = res["against"]
    assert (got["rows_compared"], got["rows_equal"], got["equal_through"],
            got["first_apart"], got["window"]) == (60, 50, 50_000, 51_000, 25_000)
    assert {int(k): v for k, v in got["gap"]["this"].items()} == pytest.approx(
        {25_000: 0.01, 50_000: 0.01, 75_000: -0.02, 100_000: -0.02})
    assert {int(k): v for k, v in got["gap"]["earlier"].items()} == pytest.approx(
        {25_000: 0.01, 50_000: 0.01, 75_000: 0.03})
    assert res["last_step"] == 100_000 and res["band"]["training"][1]["inside"]
    assert res["card"] == "a card" and res["held_out"]["port_step"] is None


def test_learning_check_overlaps_of_a_continued_segment(tmp_path):
    """A segment that went on from a checkpoint older than the earlier
    segment's last row logs those steps again: ``overlaps`` names them and
    says whether each row is the same; the merged curve takes the later
    segment's rows."""
    import learning_check as lc

    row = "[{:>7}] env_steps=1.00e+00 win_rate={} loss={} eps=0.05 sps=1.0e+03\n"
    (tmp_path / "segment_0.log").write_text("".join(
        row.format(s, w, 0.1) for s, w in ((10, 0.1), (20, 0.2), (30, 0.3), (40, 0.4))))
    (tmp_path / "segment_20.log").write_text("".join(
        row.format(s, w, 0.1) for s, w in ((10, 0.3), (20, 0.45), (30, 0.5))))
    assert lc.overlaps(tmp_path) == [{"segment": 20, "steps": [30, 40],
                                      "equal": [True, False]}]
    curve = lc.read_curve(tmp_path, num_envs=4)
    assert [(r["step"], r["win_rate"]) for r in curve] == [
        (10, 0.1), (20, 0.2), (30, 0.3), (40, 0.45), (50, 0.5)]
    (tmp_path / "segment_20.log").unlink()
    assert lc.overlaps(tmp_path) == []


def test_learning_check_passes_continue_run(capsys):
    """``--continue-run`` reaches ``cli train`` with the ``--resume``
    checkpoint (``tests/test_torch_continue.py`` holds the continued run
    against one unbroken call), and ``cli train`` refuses it without one."""
    import learning_check as lc

    from tetris_piclim_tpu_torch import cli

    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu", "--resume", "CKPT",
                  "--continue-run"])
    assert lc.train_command(a, 20_000, "OUT")[-3:] == ["--resume", "CKPT",
                                                       "--continue-run"]
    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu", "--resume", "CKPT"])
    assert "--continue-run" not in lc.train_command(a, 20_000, "OUT")
    assert cli.main(["train", "--device", "cpu", "--continue-run"]) == 2
    assert "--resume" in capsys.readouterr().err


def test_forward_by_provenance_splits_the_forward_family(tmp_path):
    """The forward win rate on the host DFS rows and on the device beam
    rows apart (the first ``host_forward`` forward rows, then the next
    ``device_forward``), with ``cli eval``'s draws: each part equals
    ``DQNTrainer.evaluate`` on those rows, and the whole family again
    equals the evaluation on ``subset(FAMILY_FORWARD)``."""
    import learning_check as lc

    from tetris_piclim_tpu_torch.gen.bank import FAMILY_FORWARD, ConfigBank

    trainer, ckpt, hold = tiny_run(tmp_path)
    n_fwd = hold.family_counts["forward"]
    assert n_fwd >= 4
    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu", "-L", "1", "-M", "8",
                  "--bank", "16"])
    ev = {"holdout": {"episodes": 64, "build": {"host_forward": 3,
                                                "device_forward": n_fwd - 3}}}
    split = lc.forward_by_provenance(a, ckpt, str(tmp_path / "holdout"), ev)
    cols, pieces = hold.rows
    want = [trainer.evaluate(64, bank=ConfigBank.from_rows(
        1, 8, cols[lo:hi], pieces[lo:hi], hold.family[lo:hi]))["win_rate"]
        for lo, hi in ((0, 3), (3, n_fwd))]
    assert split["host_dfs"] == {"rows": 3, "episodes": 64, "win_rate": want[0]}
    assert split["device_beam"] == {"rows": n_fwd - 3, "episodes": 64, "win_rate": want[1]}
    assert split["whole_again"] == trainer.evaluate(
        64, bank=hold.subset(FAMILY_FORWARD))["win_rate"]
    # no device rows: that part has no win rate
    ev["holdout"]["build"] = {"host_forward": n_fwd, "device_forward": 0}
    split = lc.forward_by_provenance(a, ckpt, str(tmp_path / "holdout"), ev)
    assert split["device_beam"] == {"rows": 0, "episodes": 64, "win_rate": None}
    # counts that reach past the forward rows are refused
    ev["holdout"]["build"] = {"host_forward": n_fwd, "device_forward": 1}
    with pytest.raises(RuntimeError):
        lc.forward_by_provenance(a, ckpt, str(tmp_path / "holdout"), ev)


def test_on_jax_rows_plays_every_jax_row_once(tmp_path, monkeypatch):
    """The checkpoint's policy on JAX's own held-out rows of the task: each
    part's rows won equal the policy played once per row, and the forward
    family for h host rows is the first h host rows with the first n - h
    beam rows; a task with no such file gives None."""
    import numpy as np

    import holdout_draws as hd
    import learning_check as lc

    from tetris_piclim_tpu_torch.ops.bitboard import unpack_board

    trainer, ckpt, hold = tiny_run(tmp_path)
    boards = unpack_board(hold.cols).numpy()
    pieces = hold.pieces.numpy()
    path = tmp_path / "jax_rows.npz"
    np.savez_compressed(path, beam_boards=boards[:8], beam_pieces=pieces[:8],
                        carve_boards=boards[8:], carve_pieces=pieces[8:],
                        host_boards=boards[3:8], host_pieces=pieces[3:8])
    a = lc.parse(["--recipe", "flagship100k", "--device", "cpu", "-L", "1", "-M", "8",
                  "--bank", "16"])
    assert lc.on_jax_rows(a, ckpt) is None
    monkeypatch.setattr(lc, "JAX_ROWS", {(1, 8): path})
    monkeypatch.setattr(lc, "JAX_HOST_ROWS", (0, 3, 9))
    got = lc.on_jax_rows(a, ckpt)
    won = hd.play(trainer.state.net, boards, pieces, 1, 8, "cpu")
    assert got["beam"] == {"rows": 8, "won": int(won[:8].sum()),
                           "win_fraction": float(won[:8].mean())}
    assert got["carve"]["won"] == int(won[8:].sum())
    assert got["host"]["won"] == int(won[3:8].sum())
    want = []
    for h in (0, 3, 5):  # 9 is cut to the 5 host rows there are
        fwd = int(won[3:3 + h].sum()) + int(won[:8 - h].sum())
        want.append({"host_rows": h, "forward_win_fraction": fwd / 8,
                     "holdout_win_fraction": (fwd + int(won[8:].sum())) / 16})
    assert got["by_host_rows"] == want
    reading = held_out_reading(10, 0.5, 0.5, 0.5, 0.5)
    reading["on_jax_rows"] = got
    ref = lc.read_reference(a.reference, a.num_envs, a.reference_eval)
    assert lc.held_out_block(reading, ref)["on_jax_rows"] == got


def test_learning_check_flagship100k_small(tmp_path):
    """``--recipe flagship100k`` at a toy size on the CPU: the run ends
    with the evaluation on the training bank and no held-out one, and the
    result names JAX's run and its held-out reading."""
    out = run_tool(["tools/learning_check.py", "--recipe", "flagship100k", "--device", "cpu",
                 "-L", "1", "-M", "8", "--num-envs", "8", "--bank", "16",
                 "--steps", "10", "--log-every", "10", "--checkpoint-every", "10",
                 "--eval-episodes", "32", "--out", str(tmp_path)], timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r["step"] for r in res["rows"]] == [10] and res["held_out_readings"] == []
    assert res["reference"] == "results/train_r3_L5df.log"
    assert res["reference_eval"] == "results/eval_r3_L5df.json"
    assert res["band"]["greedy"]["jax"] == JAX_100K["train_bank"]
    assert res["held_out"]["port_step"] is None and res["holdout_bank"] == 2048
    assert (tmp_path / "ckpt" / "final" / "bank.pt").exists()


def test_learning_check_flagship100k_holdout_only_small(tmp_path):
    """``--recipe flagship100k --holdout-only`` end to end on a toy
    checkpoint: ``cli eval`` reads it, and the result's ``held_out`` block
    holds JAX's 100k values, the forward family split by provenance (the
    whole family again equal to the reading's) and the eval JSON's
    training-bank win rate unbanded."""
    tiny_run(tmp_path)
    out = run_tool(["tools/learning_check.py", "--recipe", "flagship100k", "--device", "cpu",
                 "-L", "1", "-M", "8", "--bank", "16", "--holdout-bank", "16",
                 "--holdout-episodes", "48", "--holdout-only",
                 "--resume", str(tmp_path / "ckpt" / "final"), "--out", str(tmp_path)],
                timeout=150)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    block = res["held_out"]
    assert block["port_step"] == 0 and block["episodes"] == 48
    assert {k: r["jax"] for k, r in block["rows"].items()} == JAX_100K
    assert all(isinstance(r["inside"], bool) for r in block["rows"].values())
    assert block["eval_bank"]["jax"] == 0.8436279296875 and block["eval_bank"]["band"] is None
    assert block["eval_bank"]["port"] == block["rows"]["train_bank"]["port"]
    split, build = block["forward_by_provenance"], block["build"]
    assert (split["host_dfs"]["rows"], split["device_beam"]["rows"]) == (
        build["host_forward"], build["device_forward"])
    assert split["whole_again"] == block["rows"]["forward"]["port"]
    assert (tmp_path / "holdout_0.json").exists()
