"""The curriculum's segment carry (``tools/curriculum_segment.py``): ``cli
curriculum`` split into segments, the trainer's whole state carried between
them, equals the unbroken run word for word. A toy run on the CPU: two
levels, 32 envs, four 10-step chunks, a threshold low enough that level 0
is promoted at the segments' boundary."""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import ckpt_pack  # noqa: E402
import curriculum_segment as seg  # noqa: E402

TOY = ["--levels", "1:8,2:12", "--num-envs", "32", "--bank", "16", "--replay", "2048",
       "--warmup", "64", "--steps", "40", "--chunk", "10", "--threshold", "0.1",
       "--eval-episodes", "8", "--seed", "0", "--device", "cpu"]


def _segment(flags, **kw) -> tuple[int, str, str]:
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = seg.run_segment(flags, **kw)
    return rc, err.getvalue(), out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The toy run unbroken, then as 2 + 2 chunks through the packed state."""
    tmp = tmp_path_factory.mktemp("segments")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a toy run gains nothing from more
    try:
        whole = _segment(TOY, save=str(tmp / "whole"))
        first = _segment(TOY, stop_at=20, save=str(tmp / "first"))
        packed = ckpt_pack.pack(str(tmp / "first"), str(tmp / "first.xz"))
        second = _segment(TOY, restore_from=str(tmp / "first.xz"),
                          save=str(tmp / "second"))
    finally:
        torch.set_num_threads(threads)
    return tmp, whole, first, second, packed


def _final(stdout: str) -> dict:
    line = json.loads(stdout.strip().splitlines()[-1])
    line["train"].pop("steps_per_s")  # a measurement, not a result
    return line


def test_two_segments_equal_four_unbroken_chunks(runs):
    tmp, whole, first, second, _ = runs
    assert whole[0] == first[0] == second[0] == 0
    # the rows, with the unbroken run's step numbers, and the evaluation
    assert whole[1] == first[1] + second[1]
    rows = [seg.parse_row(ln) for ln in whole[1].splitlines() if seg.parse_row(ln)]
    assert [r["step"] for r in rows] == [10, 20, 30, 40]
    assert [seg.parse_row(ln)["step"] for ln in first[1].splitlines()] == [10, 20]
    # level 0 was promoted at the boundary: the carried level array moved
    assert rows[1]["level_distribution"] != rows[0]["level_distribution"]
    assert first[2] == "" and _final(second[2]) == _final(whole[2])
    a, b = seg.load_state(tmp / "whole"), seg.load_state(tmp / "second")
    assert sorted(a) == sorted(b) == sorted([
        "recipe", "step", "bank_sha256", "net", "target_net", "opt", "replay", "env",
        "gen", "level", "rng"])
    for key in a:
        assert ckpt_pack.same(a[key], b[key]), key
    assert a["step"] == 40 and a["replay"]["size"] == 40 * 32
    assert a["opt"]["count"] > 0 and sum(a["level"].tolist()) > 0
    # the carried state at the boundary is not the end state
    mid = seg.load_state(tmp / "first")
    assert mid["step"] == 20 and not ckpt_pack.same(mid["net"], a["net"])
    assert not ckpt_pack.same(mid["gen"], a["gen"]) and mid["rng"] != a["rng"]


def test_packed_state_round_trips_word_for_word(runs, tmp_path):
    tmp, *_, packed = runs
    raw, back = seg.load_state(tmp / "first"), seg.load_state(tmp / "first.xz")
    assert ckpt_pack.same(raw, back)
    assert packed["bytes"] == (tmp / "first" / seg.STATE).stat().st_size
    assert 0 < packed["packed_bytes"] < packed["bytes"]
    ckpt_pack.unpack(str(tmp / "first.xz"), str(tmp_path / "again"))
    assert ckpt_pack.same(raw, seg.load_state(tmp_path / "again"))
    # the tensors come back with their dtypes and shapes
    assert back["level"].dtype == torch.int64 and back["level"].shape == (32,)
    assert back["gen"].dtype == torch.uint8


def _flags(**change) -> list:
    out = list(TOY)
    for k, v in change.items():
        out[out.index(f"--{k}") + 1] = v
    return out


def _moved_state(tmp, tmp_path, **change) -> Path:
    sd = seg.load_state(tmp / "first")
    sd.update(change)
    (tmp_path / "moved").mkdir()
    torch.save(sd, tmp_path / "moved" / seg.STATE)
    return tmp_path / "moved"


@pytest.mark.parametrize("case", ["flags", "off_boundary", "stop_off_boundary",
                                  "stop_before_start", "banks"])
def test_a_segment_is_refused(runs, tmp_path, case):
    tmp = runs[0]
    restore, flags, stop = tmp / "first.xz", TOY, None
    if case == "flags":
        flags, match = _flags(threshold="0.2"), r"flags differ: \['threshold'\]"
    elif case == "off_boundary":
        restore, match = _moved_state(tmp, tmp_path, step=25), "not on a chunk boundary"
    elif case == "stop_off_boundary":
        stop, match = 35, "cannot stop at 35"
    elif case == "stop_before_start":
        stop, match = 20, "cannot stop at 20"
    else:
        restore = _moved_state(tmp, tmp_path, bank_sha256="0" * 64)
        match = "banks differ"
    with pytest.raises(seg.Refused, match=match):
        _segment(flags, restore_from=restore, stop_at=stop)
    # a refused segment leaves the CLI's trainer as it was
    from tetris_piclim_tpu_torch.dqn import curriculum_train

    assert curriculum_train.CurriculumTrainer.__name__ == "CurriculumTrainer"


def test_run_mode_carries_each_seed_over_calls(tmp_path, monkeypatch):
    """``run`` twice: the second call goes on from the first's packed state,
    keeps only the newest, and ``summarize`` joins the segments."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    toy = TOY[:TOY.index("--seed")]
    for stop in (20, 40):
        (rec,) = seg.run_seeds(range(1, 2), stop, tmp_path, "cpu", 120.0, toy)
        assert rec["rc"] == 0 and rec["stop"] == stop and rec["state_packed_bytes"] > 0
    assert sorted(p.name for p in (tmp_path / "s1").glob("state_*")) == ["state_40.xz"]
    assert rec["restored_from"] == "state_20.xz" and rec["final"]["train"]["step"] == 40
    runs = seg.seed_runs(tmp_path)
    assert [r["step"] for r in runs[1]["rows"]] == [10, 20, 30, 40]
    assert runs[1]["reached"] == 40


def test_proof_mode_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    toy = TOY[:TOY.index("--seed")]
    toy[toy.index("--steps"):toy.index("--steps") + 2] = []
    res = seg.proof(tmp_path, "cpu", toy, timeout=120)
    assert res["equal"] and res["rcs"] == [0, 0, 0] and res["chunk"] == 10
    assert [r["step"] for r in res["rows_segmented"]] == [10, 20, 30, 40]
    assert res["rows_segmented"] == res["rows_unbroken"]
    assert json.loads((tmp_path / "proof.json").read_text())["equal"] is True
