"""The host-producer refresh on a multi-rank mesh and the sub-mesh
(``make_mesh(n)`` of fewer ranks than the group), on the CPU over gloo.

Each scenario runs once, in ranks started by
``parallel.distributed.launch_local`` from ``torch_mesh_worker.py`` (every
rank killed after its time limit, so a hang fails the tests):

* ``refresh``: ``train(refresh_bank=True)`` on 2 ranks, L=1/M=8, the
  trainer's own 16-row host bank, 4 chunks of 2 per-step steps. Rank 0
  fills the bank and runs the producers; every chunk steps on rank 0's
  rows, broadcast; before the last chunk rank 0 waits (under a limit) for
  the producers' first rows, so the check does not depend on timing. Each
  chunk is held against one process stepping on the same rows, with
  ``tests/test_torch_parallel.py``'s tolerances (counts and env state
  exact, reward and loss rtol 1e-5, parameters atol 1e-5).
* ``submesh``: 3 ranks, ``make_mesh(2)``: ranks 0-1 run the learner
  against JAX's ``make_mesh(2)`` learner on the conftest's 8 CPU devices
  and the per-step chunk against one process, as the 2-rank tests do;
  rank 2 gets None and exits cleanly; ``make_mesh(4)`` raises.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.parallel.distributed import launch_local
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig
from test_torch_parallel import (
    BANK, CHUNKS, _assert_sd_close, _assert_sd_equal, _jax_mesh_learner, _jax_sd,
    _one_process,
)

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
REFRESH_CFG = TrainConfig(env=EnvConfig(L=1, M=8), dqn=DQNConfig(batch_size=16),
                          num_envs=16, bank_capacity=16, replay_capacity=128,
                          warmup_steps=1, log_every=2, seed=0)
CHUNKS_N = 4


def _launch(tmp_path_factory, scenario: str, n: int, inputs: dict, timeout: float):
    work = tmp_path_factory.mktemp(scenario)
    torch.save(inputs, work / "inputs.pt")
    error = None
    try:
        launch_local(n, [HERE / "torch_mesh_worker.py", scenario, work],
                     timeout=timeout)
    except RuntimeError as e:  # each test reports what it lacks
        error = str(e)

    def result(rank: int):
        path = work / f"{scenario}_rank{rank}.pt"
        assert path.exists(), f"rank {rank} of {scenario} wrote nothing: {error}"
        return torch.load(path, weights_only=False)

    return result


@pytest.fixture(scope="module")
def refresh(tmp_path_factory):
    return _launch(tmp_path_factory, "refresh", 2,
                   {"refresh": {"cfg": REFRESH_CFG, "chunks": CHUNKS_N}}, timeout=240)


@pytest.fixture(scope="module")
def submesh(tmp_path_factory):
    learner_inp, learner_want = _jax_mesh_learner(1, False, 8, 3)
    spec = CHUNKS["chunk_mlp"]
    inputs = {"learner": learner_inp,
              "chunk_mlp": {k: v for k, v in spec.items() if k != "save_to"} | {"bank": BANK}}
    result = _launch(tmp_path_factory, "submesh", 3, inputs, timeout=150)
    return {"result": result, "learner": learner_want,
            "chunk_mlp": _one_process(spec)}


def test_refresh_banks_equal_on_every_rank_at_every_chunk(refresh):
    r0, r1 = refresh(0), refresh(1)
    assert len(r0["chunks"]) == len(r1["chunks"]) == CHUNKS_N
    for k, (a, b) in enumerate(zip(r0["chunks"], r1["chunks"])):
        for x, y in zip(a["rows"], b["rows"]):
            assert torch.equal(x, y), f"chunk {k}"
    for x, y in zip(r0["init_rows"], r1["init_rows"]):
        assert torch.equal(x, y)  # rank 1 filled nothing: rank 0's fill
    np.testing.assert_array_equal(r0["init_family"], r1["init_family"])
    for x, y in zip(r0["final_rows"], r1["final_rows"]):
        assert torch.equal(x, y)  # and at the call's end
    np.testing.assert_array_equal(r0["final_family"], r1["final_family"])
    assert r0["history"] == [dict(h, steps_per_s=r["steps_per_s"],
                                  learner_share=r["learner_share"])
                             for h, r in zip(r1["history"], r0["history"])]
    assert r0["staged"] == r1["staged"] == 0


def test_refresh_producers_land_and_stop_on_rank_zero_only(refresh):
    r0, r1 = refresh(0), refresh(1)
    assert r0["started"] == [0] and r1["started"] == []
    assert r0["waited_s"] and r0["waited_s"][0] < 120, r0["waited_s"]
    assert r0["history"][-1]["bank_writes"] > 0
    assert r0["history"][0]["bank_families"]["carve"] == 12  # 75% of 16 carved
    # the last chunk read the producers' rows
    first, last = r0["chunks"][0]["rows"], r0["chunks"][-1]["rows"]
    assert not all(torch.equal(x, y) for x, y in zip(first, last))
    assert r0["children_after"] == [] and not any(r0["producers_alive"])
    assert r1["children_after"] == [] and r1["producers_alive"] == []


def test_refresh_chunks_match_one_process_on_the_same_rows(refresh):
    r0 = refresh(0)
    cols, pieces = r0["init_rows"]
    bank = ConfigBank.from_rows(1, 8, cols, pieces, r0["init_family"])
    one = DQNTrainer(REFRESH_CFG, bank=bank, device="cpu")
    for k, c in enumerate(r0["chunks"]):
        m = one.run_chunk(REFRESH_CFG.log_every, c["rows"])._asdict()
        got = c["metrics"]
        for key in ("episodes", "wins", "lines", "loss_count"):
            assert int(got[key]) == int(m[key]), (k, key)
        for key in ("reward", "loss_sum"):
            np.testing.assert_allclose(float(got[key]), float(m[key]), rtol=1e-5,
                                       err_msg=f"chunk {k} {key}")
    assert sum(int(c["metrics"]["episodes"]) for c in r0["chunks"]) > 0
    _assert_sd_close(r0["net"], one.state.net.state_dict(), 0, 1e-5, "net")
    for key, v in one.state.env._asdict().items():
        assert torch.equal(r0["env"][key], v), key


def test_submesh_learner_matches_jax_make_mesh_2(submesh):
    want = submesh["learner"]
    for rank in range(2):
        got = submesh["result"](rank)
        assert got["mesh"] == (rank, 2, 0)
        np.testing.assert_allclose(got["learner"]["losses"], want["losses"], rtol=1e-5)
        _assert_sd_close(got["learner"]["net"], _jax_sd(want["params"]), 1e-5, 1e-6,
                         f"rank {rank}")
        assert got["learner"]["count"] == 5
    _assert_sd_equal(submesh["result"](1)["learner"]["net"],
                     submesh["result"](0)["learner"]["net"])


def test_submesh_chunk_matches_one_process(submesh):
    got, want = submesh["result"](0)["chunk_mlp"], submesh["chunk_mlp"]
    ts = want["trainer"].state
    assert got["updates_done"] == ts.updates_done > 0
    for k in ("episodes", "wins", "lines"):
        assert int(got["metrics"][k]) == int(want["metrics"][k]), k
    np.testing.assert_allclose(float(got["metrics"]["reward"]),
                               float(want["metrics"]["reward"]), rtol=1e-5)
    _assert_sd_close(got["net"], ts.net.state_dict(), 0, 1e-5, "chunk")
    for k, v in ts.env._asdict().items():
        assert torch.equal(got["env"][k], v), k


def test_submesh_outside_rank_gets_none_and_too_many_raises(submesh):
    outside = submesh["result"](2)
    assert outside["mesh"] is None and "learner" not in outside
    for rank in range(3):
        assert submesh["result"](rank)["too_many"] == "requested 4 devices, have 3"


def test_allocate_gives_rows_of_the_filled_shape():
    """A rank other than 0 allocates the bank rows rank 0 fills."""
    filled = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
    empty = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").allocate()
    for a, b in zip(filled.rows, empty.rows):
        assert a.shape == b.shape and a.dtype == b.dtype and not b.any()
