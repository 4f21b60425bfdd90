"""The device bank's stream, seeded as the JAX bank seeds it.

An unseeded ``fill_device`` / ``refresh_device`` of the JAX bank draws a
fresh key from the bank's ``random.Random``
(``tetris_piclim_tpu/gen/bank.py``: ``PRNGKey(self._rng.randint(0, 2**31 -
1))``); the port seeds a fresh device generator from the same draw. Held
here against ``tetris_piclim_tpu.gen.bank.ConfigBank`` on the CPU:

* after every unseeded fill or refresh (carves only and with a forward
  share), the bank's ``random.Random`` and numpy generator stand where
  JAX's stand, and the producer seeds ``start_refresh`` draws next are
  JAX's;
* a trainer built on a ``fill_device()`` bank of its own seed does not
  replay the fill's stream (it did while the bank seeded its generator
  with the bank's seed, the trainer's seed on the same device).

Then the pairs of generators the port still seeds from one integer within
one run on one device type (ROADMAP §C, C-3), each shown by recording the
seeds of every ``torch.Generator`` a constructor makes.
"""

import copy
import random

import pytest
import torch

from tetris_piclim_tpu.gen.bank import ConfigBank as JaxBank
from tetris_piclim_tpu_torch.gen import bank as bank_mod
from tetris_piclim_tpu_torch.gen.bank import ConfigBank

torch.set_num_threads(1)

TASKS = [(1, 8), (2, 20)]
SEEDS = [0, 1, 2]
CAPACITY = 16


def _host_state(bank) -> tuple:
    return bank._rng.getstate(), bank._np_rng.bit_generator.state


def _apply(bank, op: str) -> None:
    """One unseeded call; a refresh follows an unseeded fill."""
    if op == "fill":
        bank.fill_device()
    elif op == "fill_forward":
        bank.fill_device(forward_fraction=0.25)
    else:
        bank.fill_device()
        bank.refresh_device(forward_fraction=0.25 if op == "refresh_forward" else 0.0)


@pytest.mark.parametrize("op", ["fill", "fill_forward", "refresh_carve",
                                "refresh_forward"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("L,M", TASKS)
def test_host_generators_stand_where_jax_stands(L, M, seed, op):
    jb = JaxBank(L, M, capacity=CAPACITY, seed=seed)
    tb = ConfigBank(L, M, capacity=CAPACITY, seed=seed, device="cpu")
    assert _host_state(tb) == _host_state(jb)
    _apply(jb, op)
    _apply(tb, op)
    assert _host_state(tb) == _host_state(jb)
    fam = tb.family_counts
    assert fam["carve"] + fam["forward"] == CAPACITY


class _Pool:
    """Stands for the producer processes: records their specs."""
    specs: list = []

    def __init__(self, specs):
        _Pool.specs = specs

    def receive(self, timeout):
        return []

    def restart_dead(self):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("L,M", TASKS)
def test_producer_seeds_follow_jax(L, M, seed, monkeypatch):
    """The carve and forward producer seeds that ``start_refresh`` draws
    after a fill and a carve refresh are the ones JAX's draws there
    (``start_refresh``: one per carving producer, then the forward one)."""
    from tetris_piclim_tpu_torch.gen import _producers

    monkeypatch.setattr(_producers, "ProducerPool", _Pool)
    jb = JaxBank(L, M, capacity=CAPACITY, seed=seed)
    tb = ConfigBank(L, M, capacity=CAPACITY, seed=seed, device="cpu")
    for b in (jb, tb):
        _apply(b, "refresh_carve")
    tb.start_refresh()
    tb.stop_refresh()
    carve_seed = _Pool.specs[0][1][2]
    forward_seed = _Pool.specs[1][1][-1]
    assert [carve_seed, forward_seed] == [jb._rng.randint(0, 2**31 - 1)
                                          for _ in range(2)]


def _words(seed: int) -> list:
    return torch.randint(0, 2**31 - 1, (16,),
                         generator=torch.Generator().manual_seed(seed)).tolist()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("L,M", TASKS)
def test_trainer_does_not_replay_the_fill_stream(L, M, seed, monkeypatch):
    """The generator the first fill carves from is seeded by one draw of
    ``random.Random(seed)``, not ``seed``; the trainer's, seeded ``seed``,
    then draws other words."""
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

    seen = []
    carve = bank_mod.device_carver.generate_batch_device

    def spy(*args, generator=None, **kw):
        seen.append(generator.initial_seed())
        return carve(*args, generator=generator, **kw)

    monkeypatch.setattr(bank_mod.device_carver, "generate_batch_device", spy)
    bank = ConfigBank(L, M, capacity=CAPACITY, seed=seed, device="cpu").fill_device()
    cfg = TrainConfig(env=EnvConfig(L=L, M=M), dqn=DQNConfig(batch_size=16),
                      num_envs=8, bank_capacity=CAPACITY, replay_capacity=256,
                      warmup_steps=8, total_steps=8, log_every=8, seed=seed)
    trainer = DQNTrainer(cfg, bank=bank, device="cpu")
    assert seen == [random.Random(seed).randint(0, 2**31 - 1)]
    assert trainer.state.gen.initial_seed() == seed
    assert _words(seen[0]) != _words(trainer.state.gen.initial_seed())


# -- C-3: the pairs of generators still seeded from one integer ----------------


class _Recorder(torch.Generator):
    """A ``torch.Generator`` that records (device type, seed) of each
    ``manual_seed``."""
    seen: list = []

    def manual_seed(self, seed):
        _Recorder.seen.append((self.device.type, int(seed)))
        return super().manual_seed(seed)


def _tiny_cfg(seed: int, **kw):
    from tetris_piclim_tpu_torch.utils.config import DQNConfig, EnvConfig, TrainConfig

    return TrainConfig(env=EnvConfig(L=1, M=6), dqn=DQNConfig(batch_size=16),
                       num_envs=8, bank_capacity=16, replay_capacity=256,
                       warmup_steps=8, total_steps=8, log_every=8, seed=seed, **kw)


def _bank(seed: int):
    return ConfigBank(1, 6, capacity=16, seed=seed, device="cpu").fill_device()


def _cli_device_bank(seed: int):
    """``cli train --device-bank --device cpu``'s bank, net and trainer."""
    from tetris_piclim_tpu_torch import cli
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer

    args = cli.build_parser().parse_args(
        ["train", "--device", "cpu", "-L", "1", "-M", "6", "--device-bank",
         "--seed", str(seed)])
    bank = cli._device_bank(args, 1, 6, 16, seed)
    return DQNTrainer(_tiny_cfg(seed), bank=bank, net=cli._net(args, seed),
                      device="cpu")


def _trainer_and_evaluate(seed: int):
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer

    bank = _bank(seed)
    _Recorder.seen.clear()  # the pair below is the trainer's alone
    tr = DQNTrainer(_tiny_cfg(seed), bank=bank, device="cpu")
    tr.evaluate(n_episodes=8)


def _entry(seed: int):
    from tetris_piclim_tpu_torch.entry import entry

    entry(device="cpu", seed=seed)


def _curriculum(seed: int):
    from tetris_piclim_tpu_torch.dqn.curriculum_train import CurriculumTrainer

    CurriculumTrainer([(1, 6), (1, 8)], _tiny_cfg(seed), seed=seed, device="cpu")


def _bench_mfu(seed: int):
    from tetris_piclim_tpu_torch import bench_mfu

    bench_mfu.measure(num_envs=16, scan=1, updates=1, device="cpu")


# case -> (what builds it, seed, the (device type, seed) pairs it must hold:
# each seeded by two generators or more, and no other seed twice)
PAIRS = {
    # main path on a CPU run: the net's init generator (cli.py:_net) and the
    # trainer's (dqn/train.py, TrainState.gen); the bank's fill is apart
    "cli_net_init_and_trainer": (_cli_device_bank, 3, {("cpu", 3): 2}),
    # the default net's init (dqn/train.py, QNetwork) and the trainer's;
    # host_gen and evaluate's generator (cfg.seed + 1)
    "net_init_trainer_host_gen_evaluate": (_trainer_and_evaluate, 3,
                                           {("cpu", 3): 2, ("cpu", 4): 2}),
    # entry(): the flagship net's init and the draws' generator
    "entry_net_init_and_draws": (_entry, 3, {("cpu", 3): 2}),
    # CurriculumTrainer at seed 0: the net's init and the trainer's; each
    # level's bank generator is seeded from its own draw (gen/curriculum.py,
    # level_seeds), so none shares the trainer's seed
    "curriculum_net_init_and_trainer": (_curriculum, 0, {("cpu", 0): 2}),
    # bench_mfu.measure (its trainer at seed 0): the conv net's init and the
    # trainer's; the FLOP count's sampler is seeded FLOP_COUNT_SEED
    "bench_mfu_net_init_and_trainer": (_bench_mfu, 0, {("cpu", 0): 2}),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_same_seed_generator_pairs(case, monkeypatch):
    build, seed, pairs = PAIRS[case]
    monkeypatch.setattr(torch, "Generator", _Recorder)
    _Recorder.seen.clear()
    build(seed)
    counts: dict = {}
    for key in _Recorder.seen:
        counts[key] = counts.get(key, 0) + 1
    assert {k: n for k, n in counts.items() if n > 1} == pairs


def test_main_path_bank_is_not_paired():
    """On ``cli train --device-bank``'s path the first fill's generator is
    seeded from the bank's ``random.Random``, so no generator of the bank
    shares the trainer's seed."""
    _Recorder.seen.clear()
    import unittest.mock as mock

    with mock.patch.object(torch, "Generator", _Recorder):
        tr = _cli_device_bank(5)
    fill = random.Random(5).randint(0, 2**31 - 1)
    assert ("cpu", fill) in _Recorder.seen
    assert _Recorder.seen.count(("cpu", 5)) == 2  # the net's init, the trainer's
    assert tr.state.gen.initial_seed() == 5 != fill


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_curriculum_level_generators_apart_from_trainer(seed, monkeypatch):
    """Each level's bank generator is seeded by one draw of
    ``random.Random(seed)``, in level order, and none by the trainer's seed:
    the trainer's reset, epsilon and sample draws are not the words that
    carved a level's bank (at seed 0 level 0's were, while level k was
    seeded ``seed * 1000 + k``)."""
    from tetris_piclim_tpu_torch.dqn.curriculum_train import CurriculumTrainer
    from tetris_piclim_tpu_torch.gen.curriculum import level_seeds

    levels = [(1, 6), (1, 8), (2, 10)]
    draws = random.Random(seed)
    want = [draws.randint(0, 2**31 - 1) for _ in levels]
    monkeypatch.setattr(torch, "Generator", _Recorder)
    _Recorder.seen.clear()
    tr = CurriculumTrainer(levels, _tiny_cfg(seed), seed=seed, device="cpu")
    assert level_seeds(seed, len(levels)) == want
    assert _Recorder.seen[:len(levels)] == [("cpu", s) for s in want]
    assert tr.state.gen.initial_seed() == seed not in want
    assert all(_words(s) != _words(seed) for s in want)


# bench_mfu's learner_update FLOPs at its default batch, counted on the tree
# before the FLOP count's sampler was seeded apart (its sampler seeded 0)
PARENT_LEARNER_FLOPS = 6_905_200_640.0


def test_bench_mfu_flop_count_unmoved(monkeypatch):
    """The count does not depend on the rows the sampler draws: it equals
    the parent tree's, and a count with the old sampler (seed 0)."""
    from tetris_piclim_tpu_torch import bench_mfu

    counted, seen = bench_mfu.mfu_lib.counted_flops, []

    def record(fn, *args, **kw):
        flops = counted(fn, *args, **kw)
        if fn is bench_mfu.agent_lib.learner_update:
            seen.append(flops)
            kw["generator"] = torch.Generator().manual_seed(0)
            seen.append(counted(fn, *copy.deepcopy(args), **kw))
        return flops

    monkeypatch.setattr(bench_mfu.mfu_lib, "counted_flops", record)
    res = bench_mfu.measure(num_envs=16, scan=1, updates=1, device="cpu")
    assert bench_mfu.FLOP_COUNT_SEED not in (0, 1, random.Random(0).randint(0, 2**31 - 1))
    assert seen == [PARENT_LEARNER_FLOPS] * 2
    assert res["learner_gflops_per_update"] == round(PARENT_LEARNER_FLOPS / 1e9, 4)



@pytest.mark.parametrize("stream,refused", [(None, True), ("jax_order", False)])
def test_check_refuses_an_old_stream_train_line(stream, refused):
    """``tools/holdout_draws.py --check`` of a port ``train`` line drawn on
    the old stream (no ``bank_stream``) stops with a message that says so,
    not with a mismatch; a line of this stream is compared as before."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import holdout_draws

    line = {"family": "train", "seed": 3_000_000, "package": "port", "device": "cpu",
            "stats": {"filled": 1}, "beam": None, "forward_rows": 4,
            "bank_stream": "jax_order",
            "policies": {"p.npz": {"rows": 8, "won_hex": "ff"}}}
    recorded = {k: v for k, v in line.items() if k != "bank_stream"}
    if stream is not None:
        recorded["bank_stream"] = stream
    if refused:
        with pytest.raises(SystemExit, match="old bank stream"):
            holdout_draws.check_recorded(line, recorded)
    else:
        holdout_draws.check_recorded(line, recorded)
        with pytest.raises(SystemExit, match="differs from its recorded line"):
            holdout_draws.check_recorded(line, {**recorded, "forward_rows": 5})
