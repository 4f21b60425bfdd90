"""``tools/learning_check.py --resume`` of a state packed by
``tools/ckpt_pack.py``: the flagship recipe's flags at a toy task and the
``--smoke`` widths, 10 steps, then pack, unpack and ``--continue-run`` to
20, equal the unbroken 20 steps word for word (rows, greedy win rate and
every tensor of the state), and a packed state of another seed, recipe or
extra flags is refused before anything runs. CPU numbers; they mean nothing
but their equality."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port_helpers import run_tool

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)

# --steps is past every --stop-at, so no call builds the held-out bank
TOY = ["tools/learning_check.py", "--recipe", "flagship", "--device", "cpu",
       "-L", "1", "-M", "8", "--num-envs", "8", "--bank", "16", "--steps", "100",
       "--log-every", "5", "--checkpoint-every", "5", "--eval-episodes", "16"]
WIDTHS = ["--", "--channels", "4,8", "--replay", "256", "--warmup", "16",
          "--batch", "16"]


def toy_call(out: Path, *flags: str) -> list:
    return [*TOY, "--out", str(out), *flags, *WIDTHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unbroken 20 steps and the first 10, side by side, then the
    packed state of the 10 carried on to 20."""
    import ckpt_pack

    tmp = tmp_path_factory.mktemp("carry")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *toy_call(tmp / name, "--stop-at", stop)],
                              cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, stop in (("whole", "20"), ("first", "10"))]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    packed = tmp / "state_10.ckpt.xz"
    ckpt_pack.pack(str(tmp / "first" / "ckpt" / "final"), str(packed))
    out = run_tool(toy_call(tmp / "second", "--resume", str(packed), "--continue-run",
                            "--stop-at", "20"), timeout=120)
    assert out.returncode == 0, out.stderr
    return tmp, packed


def test_packed_carry_equals_the_unbroken_run(runs):
    """Rows 5-20, the segment's greedy win rate and every tensor of the
    final state equal the unbroken run's; the packed state kept the run's
    record and was unpacked at its step."""
    import ckpt_pack
    import learning_check

    tmp, packed = runs
    whole = learning_check.read_curve(tmp / "whole", 8)
    carried = (learning_check.read_curve(tmp / "first", 8)
               + learning_check.read_curve(tmp / "second", 8))
    assert [r["step"] for r in whole] == [5, 10, 15, 20]
    key = lambda rows: [(r["step"], r["win_rate"], r["loss"]) for r in rows]  # noqa: E731
    assert key(carried) == key(whole)
    assert all(r["loss"] > 0 for r in whole[1:])  # the learner ran
    seg = json.loads((tmp / "second" / "segment_10.json").read_text())
    assert seg["greedy"] == json.loads(
        (tmp / "whole" / "segment_0.json").read_text())["greedy"]
    assert sorted(p.name for p in (tmp / "second" / "ckpt").iterdir()) == ["final"]
    for name in ("state.pt", "bank.pt"):
        a, b = (torch.load(tmp / run / "ckpt" / "final" / name, map_location="cpu",
                           weights_only=True) for run in ("whole", "second"))
        assert ckpt_pack.same(a, b), name
    record = json.loads(ckpt_pack.read_packed(packed)[learning_check.CARRY])
    assert record == {"recipe": "flagship", "seed": 0,
                      "bank_stream": learning_check.BANK_STREAM, "extra": WIDTHS[1:]}
    assert json.loads((tmp / "second" / "ckpt" / "final" / learning_check.CARRY)
                      .read_text()) == record


@pytest.mark.parametrize("flags,extra,key", [
    (["--seed", "1"], [], "seed"), (["--recipe", "flagship100k"], [], "recipe"),
    ([], ["--lr", "1e-3"], "extra")], ids=["seed", "recipe", "extra"])
def test_packed_state_of_another_run_is_refused(runs, tmp_path, flags, extra, key):
    """A packed state made under another seed, recipe or flags after ``--``
    stops the call before it unpacks or trains anything."""
    import learning_check

    _, packed = runs
    argv = toy_call(tmp_path / "out", "--resume", str(packed), "--continue-run",
                    "--stop-at", "20")[1:]
    cut = argv.index("--")
    with pytest.raises(SystemExit, match=f'"{key}"'):
        learning_check.main(argv[:cut] + flags + argv[cut:] + extra)
    assert not (tmp_path / "out" / "ckpt").exists()


def test_holdout_only_refuses_extra_flags(tmp_path, capsys):
    """Flags after ``--`` reach ``cli train`` only: ``--holdout-only``,
    whose ``cli eval`` would build the recipe's own widths, refuses them."""
    import learning_check

    with pytest.raises(SystemExit):
        learning_check.main(["--recipe", "flagship", "--device", "cpu", "--holdout-only",
                             "--resume", str(tmp_path), "--out", str(tmp_path),
                             "--", "--channels", "4,8"])
    assert "reach cli train only" in capsys.readouterr().err


def test_summary_with_two_records(tmp_path, capsys):
    """``--summarize-only`` to 200k with two ``--against`` records: the
    run's own window gaps under ``window``, the first record under
    ``against`` and the second under ``against_others``, each with its own
    gaps only, and the extra flags in ``train_flags``."""
    import learning_check as lc

    jax = {r["step"]: r["win_rate"] for r in lc.read_reference(
        str(lc.FLAGSHIP_REFERENCE), 2048)["history"] if r["step"] <= 200_000}
    row = "[{:>7}] env_steps=1.00e+00 win_rate={:.3f} loss=0.1 eps=0.05 sps=6.0e+04\n"
    (tmp_path / "segment_0.log").write_text("".join(
        row.format(s, w - 0.06 if s > 175_000 else w) for s, w in jax.items()))
    (tmp_path / "segment_0.json").write_text(json.dumps(
        {"first_step": 0, "stop_step": 200_000, "wall_s": 6400.0, "card": "a card"}))
    first = [{"step": s, "port_win_rate": round(w, 3), "port_loss": 0.1, "jax_win_rate": w}
             for s, w in jax.items() if s <= 100_000]
    second = [{**r, "port_win_rate": r["port_win_rate"] + 0.01} for r in first]
    for name, body in (("a.json", {"rows": first}), ("b.json", {"rows": second})):
        (tmp_path / name).write_text(json.dumps(body))
    assert lc.main(["--recipe", "flagship", "--device", "cpu", "--out", str(tmp_path),
                    "--summarize-only", "--against", str(tmp_path / "a.json"),
                    "--against", str(tmp_path / "b.json"), "--", "--lr", "1e-3"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    gap = {int(k): v for k, v in res["window"]["gap"].items()}
    assert res["window"]["width"] == 25_000 and sorted(gap) == list(range(25_000, 200_001, 25_000))
    assert gap[175_000] == pytest.approx(0, abs=1e-3) and gap[200_000] == pytest.approx(-0.06, abs=1e-3)
    assert (res["against"]["rows_equal"], res["against"]["equal_through"]) == (100, 100_000)
    [other_block] = res["against_others"]
    assert (other_block["rows_equal"], other_block["first_apart"]) == (0, 1000)
    assert {int(k): v for k, v in other_block["gap"].items()} == pytest.approx(
        {25_000: 0.01, 50_000: 0.01, 75_000: 0.01, 100_000: 0.01}, abs=1e-3)
    assert res["train_flags"][-2:] == ["--lr", "1e-3"]
