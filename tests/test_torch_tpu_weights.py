"""The TPU-trained L=2/M=20 policy in the port: the weights and the greedy
evaluation of the JAX package's first DQN run, carried across as numpy
(``tools/tpu_checkpoint.py`` wrote ``results/tpu_L2M20_v2_params.npz`` and
``results/tpu_L2M20_v2_eval.npz`` from the run's orbax checkpoint).

Tolerances: Q values within 1e-5 absolute of flax's on the same
observations; a greedy action may differ from JAX's only where the two best
Q values of that head part lie within 1e-5 (a near-tie, where float32 sum
order decides); the greedy evaluation on the carried rows and indices may
end differently from JAX's in at most 2 episodes of 4096, each one that
first parts from JAX's trajectory at such a near-tie."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.models.qnet import QNetwork as JQNetwork
from tetris_piclim_tpu_torch.dqn.agent import greedy_rollout
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import ConfigBank
from tetris_piclim_tpu_torch.models.qnet import QNetwork
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from tetris_piclim_tpu_torch.utils.checkpoint import load_flax_npz, read_flax_npz
from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

RESULTS = Path(__file__).resolve().parents[1] / "results"
PARAMS = RESULTS / "tpu_L2M20_v2_params.npz"
EVAL = RESULTS / "tpu_L2M20_v2_eval.npz"
JAX_WIN_RATE = 0.562744140625  # the JAX package on the CPU, 4096 episodes
Q_ATOL = 1e-5
TIE = 1e-5
MAX_EPISODES_APART = 2


@pytest.fixture(scope="module")
def carried():
    with np.load(EVAL) as z:
        ev = {k: z[k] for k in z.files}
    jparams = jax.tree.map(jnp.asarray, read_flax_npz(str(PARAMS)))
    nets = []
    for sd in load_flax_npz(str(PARAMS), "cpu"):
        net = QNetwork()
        net.load_state_dict(sd)
        nets.append(net.eval())
    return ev, jparams, nets


def initial_states(ev, idx=None):
    boards = tbb.pack_board(torch.from_numpy(ev["boards"]))
    pieces = torch.from_numpy(ev["pieces"])
    if idx is not None:
        boards, pieces = boards[idx], pieces[idx]
    return tbb.make_state_batch(boards, pieces, 2, 20)


def near_tie_or_equal(q_port: np.ndarray, q_jax: np.ndarray) -> np.ndarray:
    """Per row: the greedy (rotation, column) of both Q arrays agree, or
    every head part where they differ has its two best values within TIE."""
    ok = np.ones(q_port.shape[0], bool)
    for lo, hi in ((0, 4), (4, 14)):
        a, b = q_port[:, lo:hi], q_jax[:, lo:hi]
        differ = a.argmax(1) != b.argmax(1)
        top2 = np.sort(a, axis=1)[:, -2:]
        ok &= ~differ | (top2[:, 1] - top2[:, 0] < TIE)
    return ok


def test_carried_files_are_the_tpu_run(carried):
    ev, jparams, _ = carried
    assert ev["boards"].shape == (4096, 20, 10) and ev["pieces"].shape == (4096, 21)
    assert ev["idx"].shape == (4096,) and ev["status"].shape == (4096,)
    assert float(ev["win_rate"]) == JAX_WIN_RATE == float((ev["status"] == 1).mean())
    assert sorted(jparams) == ["params", "target_params"]
    assert sorted(jparams["params"]["params"]) == [f"Dense_{i}" for i in range(5)]
    assert jparams["params"]["params"]["Dense_0"]["kernel"].shape == (217, 128)
    # the key that evaluate() draws from
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4096,), 0, 4096))
    np.testing.assert_array_equal(ev["idx"], want)


@pytest.mark.parametrize("which", ["params", "target_params"])
def test_tpu_q_values_match_flax(carried, which):
    """Both networks of the train state, on the observations of all 4096
    carried rows: Q within 1e-5, greedy actions equal or near-ties."""
    ev, jparams, nets = carried
    net = nets[["params", "target_params"].index(which)]
    obs = tbb.observe(initial_states(ev))
    with torch.no_grad():
        q_port = net(obs).numpy()
    q_jax = np.asarray(JQNetwork().apply(jparams[which], jnp.asarray(obs.numpy())))
    assert q_port.shape == q_jax.shape == (4096, 14)
    assert np.abs(q_port - q_jax).max() <= Q_ATOL
    assert np.abs(q_port).max() > 1.0  # trained weights, not a fresh init
    assert near_tie_or_equal(q_port, q_jax).all()


class Recorded(torch.nn.Module):
    """The network, keeping every observation it is given."""

    def __init__(self, net):
        super().__init__()
        self.net, self.seen = net, []

    def forward(self, obs):
        self.seen.append(obs)
        return self.net(obs)


def test_tpu_greedy_evaluation_matches_jax(carried):
    """The port's greedy rollout on the carried rows at JAX's draws ends
    each episode as JAX's did, but for at most 2 that part at a near-tie."""
    ev, jparams, nets = carried
    net = Recorded(nets[0])
    env = initial_states(ev, torch.from_numpy(ev["idx"]).long())
    status = greedy_rollout(net, env, 21, tbb).status.numpy()
    apart = np.flatnonzero(status != ev["status"])
    assert len(apart) <= MAX_EPISODES_APART, apart
    assert abs(float((status == 1).mean()) - JAX_WIN_RATE) <= MAX_EPISODES_APART / 4096
    assert set(np.unique(status)) <= {1, 2}  # every episode decided in M+1 steps

    # every action JAX's network would choose otherwise on the port's
    # trajectory is a near-tie (up to its first such action an episode's
    # trajectory is JAX's, so this covers where any episode parts)
    assert len(net.seen) == 21
    obs = torch.cat(net.seen)
    with torch.no_grad():
        q_port = nets[0](obs).numpy()
    q_jax = np.asarray(JQNetwork().apply(jparams["params"], jnp.asarray(obs.numpy())))
    assert np.abs(q_port - q_jax).max() <= Q_ATOL
    assert near_tie_or_equal(q_port, q_jax).all()


def test_warm_start_reads_the_npz():
    """``DQNTrainer.warm_start`` takes the carried file beside its own
    checkpoints: online and target nets as ``load_flax_npz`` gives them."""
    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=8, bank_capacity=8,
                      replay_capacity=256, seed=0)
    bank = ConfigBank(2, 20, capacity=8, seed=0, device="cpu").fill_device()
    tr = DQNTrainer(cfg, bank=bank, device="cpu")
    tr.warm_start(str(PARAMS))
    online, target = load_flax_npz(str(PARAMS), "cpu")
    for got, want in ((tr.state.net, online), (tr.state.target_net, target)):
        for k, v in got.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    assert not torch.equal(online["dense.0.weight"], target["dense.0.weight"])
