"""The port's data-parallel training (``tetris_piclim_tpu_torch/parallel``)
against JAX's mesh and against one process, on the CPU over gloo.

The 2-rank scenarios run once, in two processes started by
``parallel.distributed.launch_local`` (a free port, a gloo timeout of 60 s,
every rank killed after 120 s), from inputs this file writes; each test
then reads its scenario's results (``torch_parallel_worker.py``). Tolerances:

* the learner (5 updates on a 2-rank ring against JAX's learner on a
  2-device mesh, given JAX's draws): parameters and moments within rtol
  1e-5, as ``test_torch_replay_agent.py::test_five_learner_updates_match_optax``;
* the per-step chunk against one process: episodes, wins, lines, env state
  and replay ring exact, reward rtol 1e-5, parameters atol 1e-5, as
  ``tests/test_parallel.py::test_sharded_equals_single_device_numerics``
  (the loss is summed per rank and the gradients across ranks, another
  order of float32 sums);
* the fused chunk and the checkpoints: word for word.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.dqn import agent as jagent
from tetris_piclim_tpu.dqn import replay as jreplay
from tetris_piclim_tpu.dqn.train import DQNTrainer as JDQNTrainer
from tetris_piclim_tpu.dqn.train import TrainState as JTrainState
from tetris_piclim_tpu.gen.bank import ConfigBank as JConfigBank
from tetris_piclim_tpu.models.qnet import QNetwork as JQNetwork
from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu.parallel import make_mesh as jmake_mesh
from tetris_piclim_tpu.parallel import shard_train_state as jshard_train_state
from tetris_piclim_tpu.utils.config import DQNConfig as JDQNConfig
from tetris_piclim_tpu.utils.config import EnvConfig as JEnvConfig
from tetris_piclim_tpu.utils.config import TrainConfig as JTrainConfig
from tetris_piclim_tpu_torch.dqn.replay import ReplayBuffer
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.models.qnet import params_from_flax
from tetris_piclim_tpu_torch.ops.actor import actor_rollout_fused
from tetris_piclim_tpu_torch.parallel import (
    dryrun_multigpu, init_distributed, make_mesh, shard_train_state, sync_hosts,
)
from tetris_piclim_tpu_torch.parallel.distributed import launch_local
from tetris_piclim_tpu_torch.parallel.mesh import Mesh
from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig
from torch_parallel_worker import make_bank, make_net
from torch_port_helpers import filled_replays, t

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
CAP, N, B = 256, 32, 32      # the learner scenarios' ring, env count, batch
BANK = (1, 2, 16)            # L, M, rows of the chunk scenarios' bank


def _chunk_cfg(**kw) -> TrainConfig:
    """``tests/test_parallel.py``'s tiny config at 2 devices, with JAX's
    dry-run move limit 2, so every env crosses episode boundaries and
    resets from the bank within the chunk."""
    base = dict(env=EnvConfig(L=1, M=2), dqn=DQNConfig(batch_size=32),
                num_envs=16, bank_capacity=16, replay_capacity=128,
                warmup_steps=1, total_steps=4, log_every=2, seed=0)
    base.update(kw)
    return TrainConfig(**base)


CHUNKS = {
    "chunk_mlp": dict(cfg=_chunk_cfg(), net="mlp", steps=3, save_to="ckpt2"),
    "chunk_conv": dict(cfg=_chunk_cfg(updates_per_step=2), net="conv", steps=3),
    # no learning: the policy of both phases is the initial one
    "fused": dict(cfg=_chunk_cfg(actor_fusion=2, warmup_steps=10**6), net="mlp",
                  steps=4),
}


def _jax_mesh_learner(n_step: int, prioritized: bool, writes: int, seed: int):
    """Five JAX ``learner_update``s on a replay sharded over a 2-device mesh
    (``shard_train_state``); returns the inputs the port's ranks need and
    JAX's final parameters, target, optimizer state and replay."""
    jr, _ = filled_replays(CAP, N, writes, seed)
    prio = None
    if prioritized:
        prio = (np.random.default_rng(seed).gamma(1.0, 1.0, CAP)
                .astype(np.float32) + 1e-3)
        jr = jr._replace(priority=jnp.asarray(prio), max_prio=jnp.float32(prio.max()))
    jnet = JQNetwork(joint=False)
    params = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 217)))
    kw = dict(batch_size=B, lr=1e-3, n_step=n_step, prioritized=prioritized)
    jcfg = JDQNConfig(**kw)
    jopt = jagent.make_optimizer(jcfg)
    env = jbb.make_state_batch(jnp.zeros((N, 10), jnp.uint32),
                               jnp.zeros((N, 7), jnp.int8), 1, 6)
    ts = JTrainState(params=params, target_params=params,
                     opt_state=jopt.init(params), replay=jr, env=env,
                     key=jax.random.PRNGKey(0), global_step=jnp.int32(0),
                     updates_done=jnp.int32(0))
    ts = jshard_train_state(jmake_mesh(2), ts)
    assert len(ts.replay.cols.sharding.device_set) == 2
    upd = jax.jit(lambda p, tp, o, r, k: jagent.learner_update(
        p, tp, o, r, k, apply_fn=jnet.apply, optimizer=jopt, cfg=jcfg, step_gap=N))
    p, tp, o, r = ts.params, ts.target_params, ts.opt_state, ts.replay
    draws, losses = [], []
    for i in range(5):
        key = jax.random.PRNGKey(100 + i)
        if prioritized:
            _, idx0 = jreplay.replay_sample_ext(
                r, key, B, gamma=jcfg.gamma, n_step=n_step, step_gap=N,
                prioritized=True, alpha=jcfg.per_alpha, beta=jcfg.per_beta)
            draws.append(t(np.asarray(idx0)).long())
        else:
            valid = max(int(r.size) - (n_step - 1) * N, 1)
            draws.append(t(np.asarray(jax.random.randint(key, (B,), 0, valid))))
        p, tp, o, r, aux = upd(p, tp, o, r, key)
        losses.append(float(aux["loss"]))
    inp = dict(kind="learner", cap=CAP, n=N, writes=writes, seed=seed,
               cfg=DQNConfig(**kw), draws=draws,
               params=params_from_flax(jax.tree.map(np.asarray, params)))
    if prio is not None:
        inp["priority"] = torch.as_tensor(prio)
    return inp, {"params": p, "target": tp, "opt": o, "replay": r, "losses": losses}


def _one_process(spec: dict) -> dict:
    """The chunk on one process; for the fused chunk, the plain actor on
    each half of the envs with seed and seed + 7919."""
    cfg = spec["cfg"]
    trainer = DQNTrainer(cfg, bank=make_bank(*BANK), net=make_net(spec["net"]),
                         device="cpu")
    if cfg.actor_fusion == 0:
        m = trainer.run_chunk(spec["steps"])
        return {"trainer": trainer, "metrics": m._asdict()}
    ts, dqn, K = trainer.state, cfg.dqn, cfg.actor_fusion
    cols, pieces = trainer.bank.rows
    kb = min(256, cols.shape[0])
    half = cfg.num_envs // 2
    halves = [type(ts.env)(*[f[r * half:(r + 1) * half] for f in ts.env])
              for r in range(2)]
    episodes = wins = 0
    for phase in range(spec["steps"] // K):
        off = int(torch.randint(0, cols.shape[0] - kb + 1, (), generator=ts.host_gen))
        seed = int(torch.randint(0, 2**31 - 1, (), generator=ts.host_gen))
        for r in range(2):
            halves[r], _, e, w = actor_rollout_fused(
                halves[r], ts.net, cols[off:off + kb], pieces[off:off + kb],
                phase * K, seed + r * 7919, eps_start=dqn.eps_start,
                eps_end=dqn.eps_end, eps_decay=dqn.eps_decay, n_steps=K)
            episodes, wins = episodes + int(e), wins + int(w)
    env = {k: torch.cat([h[i] for h in halves]) for i, k in enumerate(ts.env._fields)}
    return {"env": env, "metrics": {"episodes": episodes, "wins": wins}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Prepare every scenario's inputs, run the 2 ranks once, and give each
    test its scenario's results, the expected values and the launch error
    (if any)."""
    work = tmp_path_factory.mktemp("ranks")
    inputs, expected = {}, {}
    inputs["learner"], expected["learner"] = _jax_mesh_learner(1, False, 8, 3)
    inputs["learner_per"], expected["learner_per"] = _jax_mesh_learner(3, True, 11, 5)
    for name, spec in CHUNKS.items():
        inputs[name] = dict(spec, bank=BANK)
        expected[name] = _one_process(spec)
    expected["chunk_mlp"]["trainer"].save_checkpoint(str(work / "ckpt1"))
    inputs["restore"] = dict(cfg=CHUNKS["chunk_mlp"]["cfg"], bank=BANK, path="ckpt1")
    torch.save(inputs, work / "inputs.pt")
    error = None
    try:
        launch_local(2, [HERE / "torch_parallel_worker.py", work], timeout=120)
    except RuntimeError as e:  # each test reports what it lacks
        error = str(e)

    def result(name: str, rank: int = 0):
        path = work / f"{name}_rank{rank}.pt"
        assert path.exists(), f"scenario {name} produced nothing: {error}"
        return torch.load(path, weights_only=False)

    return {"result": result, "expected": expected, "work": work}


def _jax_sd(tree) -> dict:
    return params_from_flax(jax.tree.map(np.asarray, tree))


def _assert_sd_close(got: dict, want: dict, rtol: float, atol: float, msg=""):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{msg} {name}")


def _assert_sd_equal(got: dict, want: dict, msg=""):
    for name, w in want.items():
        assert torch.equal(got[name].cpu(), w.cpu()), f"{msg} {name}"


@pytest.mark.parametrize("scenario", ["learner", "learner_per"])
def test_learner_matches_jax_mesh(ranks, scenario):
    """5 updates on 2 ranks, given JAX's global draws (offsets ``j``, or
    the base slots of the n-step PER sample), against JAX's learner on a
    sharded ring."""
    got, want = ranks["result"](scenario), ranks["expected"][scenario]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _assert_sd_close(got["net"], _jax_sd(want["params"]), 1e-5, 1e-6, "net")
    _assert_sd_close(got["target"], _jax_sd(want["target"]), 1e-5, 1e-6, "target")
    amsgrad = want["opt"][0]
    names = list(got["net"])
    for mine, theirs in ((got["mu"], amsgrad.mu), (got["nu_max"], amsgrad.nu_max)):
        ref = _jax_sd(theirs)
        for name, m in zip(names, mine):
            w = ref[name].numpy()
            np.testing.assert_allclose(m.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=name)
    assert got["count"] == int(amsgrad.count) == 5
    # the ranks' weights stay identical
    _assert_sd_equal(ranks["result"](scenario, 1)["net"], got["net"], "rank 1")
    if scenario == "learner_per":  # the owned write-back, gathered
        np.testing.assert_allclose(got["replay"]["priority"].numpy(),
                                   np.asarray(want["replay"].priority),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(got["replay"]["max_prio"]),
                                   float(want["replay"].max_prio), rtol=1e-5)


def test_ring_bijection_gathers_to_the_one_process_ring(ranks):
    """Two ranks' local rings, gathered, are the one-process ring after the
    same writes (and JAX's), and the slot map is a bijection."""
    got = ranks["result"]("learner")["replay"]
    jr, tr = filled_replays(CAP, N, writes=8, seed=3)
    assert (got["pos"], got["size"]) == (tr.pos, tr.size)
    for name, buf in tr.buf.items():
        assert torch.equal(got["buf"][name], buf), name
        np.testing.assert_array_equal(
            got["buf"][name].numpy().astype(np.int64) if buf.dtype != torch.float32
            else got["buf"][name].numpy(),
            np.asarray(getattr(jr, name)).astype(
                np.int64 if buf.dtype != torch.float32 else np.float32), err_msg=name)
    for rank in range(2):
        ring = ReplayBuffer(CAP, mesh=Mesh(rank=rank, size=2, device=torch.device("cpu")),
                            num_envs=N)
        owner, slot = ring.global_to_local(torch.arange(CAP))
        assert sorted(zip(owner.tolist(), slot.tolist())) == [
            (r, s) for r in range(2) for s in range(CAP // 2)]
        chain = torch.arange(CAP // N) * N + 5          # env 5's slots
        assert (owner[chain] == 0).all()


@pytest.mark.parametrize("scenario", ["chunk_mlp", "chunk_conv"])
def test_per_step_chunk_matches_one_process(ranks, scenario):
    """3 steps of the per-step chunk (the MLP, and the flagship net's layout
    with 2 updates per step) on 2 ranks against one process."""
    got, want = ranks["result"](scenario), ranks["expected"][scenario]
    ts = want["trainer"].state
    assert got["updates_done"] == ts.updates_done > 0
    for k in ("episodes", "wins", "lines"):
        assert int(got["metrics"][k]) == int(want["metrics"][k]), k
    assert int(want["metrics"]["episodes"]) > 0
    np.testing.assert_allclose(float(got["metrics"]["reward"]),
                               float(want["metrics"]["reward"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["metrics"]["loss_sum"]),
                               float(want["metrics"]["loss_sum"]), rtol=1e-5)
    _assert_sd_close(got["net"], ts.net.state_dict(), 0, 1e-5, scenario)
    for k, v in ts.env._asdict().items():
        assert torch.equal(got["env"][k], v), k
    for k, v in ts.replay.state_dict()["buf"].items():
        assert torch.equal(got["replay"]["buf"][k], v), k


def test_fused_chunk_is_the_plain_actor_per_half(ranks):
    """Two fused phases on 2 ranks: each rank's envs, word for word, are the
    plain actor's on its half with seed + rank * 7919; the episode and win
    counts are summed over the ranks."""
    got, want = ranks["result"]("fused"), ranks["expected"]["fused"]
    for k, v in want["env"].items():
        assert torch.equal(got["env"][k], v), k
    assert int(got["metrics"]["episodes"]) == want["metrics"]["episodes"] > 0
    assert int(got["metrics"]["wins"]) == want["metrics"]["wins"]


def test_two_rank_checkpoint_restores_in_one_process(ranks):
    got = ranks["result"]("chunk_mlp")
    spec = CHUNKS["chunk_mlp"]
    fresh = DQNTrainer(spec["cfg"], bank=make_bank(*BANK), device="cpu")
    fresh.restore_checkpoint(str(ranks["work"] / "ckpt2"))
    ts = fresh.state
    assert ts.global_step == spec["steps"]
    _assert_sd_equal(ts.net.state_dict(), got["net"])
    for k, v in ts.env._asdict().items():
        assert torch.equal(got["env"][k], v), k
    sd = ts.replay.state_dict()
    assert (sd["pos"], sd["size"]) == (got["replay"]["pos"], got["replay"]["size"])
    for k, v in sd["buf"].items():
        assert torch.equal(got["replay"]["buf"][k], v), k


def test_one_process_checkpoint_restores_on_two_ranks(ranks):
    """Each rank gets its env slice and, in its local ring, global slot
    ``t N + r N/2 + e`` at local slot ``t N/2 + e``."""
    one = ranks["expected"]["chunk_mlp"]["trainer"].state
    cfg = CHUNKS["chunk_mlp"]["cfg"]
    n, half = cfg.num_envs, cfg.num_envs // 2
    slots = np.arange(cfg.replay_capacity // 2)
    for r in range(2):
        got = ranks["result"]("restore", r)
        assert got["global_step"] == one.global_step
        assert (got["pos"], got["size"]) == (one.replay.pos, one.replay.size)
        _assert_sd_equal(got["net"], one.net.state_dict(), f"rank {r}")
        for k, v in one.env._asdict().items():
            assert torch.equal(got["env"][k], v[r * half:(r + 1) * half]), k
        g = torch.as_tensor(slots // half * n + r * half + slots % half)
        for k, v in one.replay.buf.items():
            assert torch.equal(got["ring"][k], v[g]), k
        assert torch.equal(got["priority"], one.replay.priority[g])


@pytest.mark.parametrize("num_envs,replay,fusion",
                         [(12, 64, 0), (16, 60, 0), (12, 64, 2)])
def test_divisibility_errors_match_jax(num_envs, replay, fusion):
    """The configs that make JAX raise on the conftest's 8-device mesh make
    the port raise on a mesh of 8 (no collective runs before the check)."""
    jmesh = jmake_mesh(8)
    jcfg = JTrainConfig(env=JEnvConfig(L=1, M=6), num_envs=num_envs,
                        bank_capacity=8, replay_capacity=replay, seed=0,
                        actor_fusion=fusion)
    jbank = JConfigBank(1, 6, capacity=8)   # empty boards: no host fill
    jbank.boards = jnp.zeros((8, 20, 10), bool)
    jbank.pieces = jnp.zeros((8, 7), jnp.int8)
    with pytest.raises(ValueError, match="divisible"):
        if fusion:
            JDQNTrainer(jcfg, bank=jbank, mesh=jmesh)
        else:
            jshard_train_state(jmesh, JDQNTrainer(jcfg, bank=jbank).state)
    mesh8 = Mesh(rank=0, size=8, device=torch.device("cpu"))
    cfg = TrainConfig(env=EnvConfig(L=1, M=6), num_envs=num_envs, bank_capacity=8,
                      replay_capacity=replay, seed=0, actor_fusion=fusion)
    bank = make_bank(1, 6, 8)
    with pytest.raises(ValueError, match="divisible"):
        if fusion:
            DQNTrainer(cfg, bank=bank, device="cpu", mesh=mesh8)
        else:
            shard_train_state(mesh8, DQNTrainer(cfg, bank=bank, device="cpu").state)


def test_single_process_helpers_and_one_rank_mesh():
    info = init_distributed(device="cpu")   # no group to join: reports only
    assert info["process_count"] == info["global_devices"] == 1
    assert info["process_index"] == 0 and info["backend"] is None
    sync_hosts()                            # no group: returns at once
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1} and mesh.is_root and not mesh.active
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    # a one-process mesh trains word for word as no mesh does
    spec = CHUNKS["chunk_mlp"]
    plain = DQNTrainer(spec["cfg"], bank=make_bank(*BANK), device="cpu")
    meshed = DQNTrainer(spec["cfg"], bank=make_bank(*BANK), mesh=mesh)
    a, b = plain.run_chunk(3), meshed.run_chunk(3)
    assert all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
               for x, y in zip(a, b))
    _assert_sd_equal(meshed.state.net.state_dict(), plain.state.net.state_dict())


def test_dryrun_multigpu_two_ranks():
    out = dryrun_multigpu(2, timeout=120)
    assert "dryrun_multigpu(2): ok" in out and "fused phase ok" in out


def test_replay_buffer_defaults_to_the_card():
    assert ReplayBuffer(64, "cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ReplayBuffer(64)
