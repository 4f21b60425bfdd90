"""The flagship policies the port trained on the H100 (L=5/M=25, conv (32,64)
+ dueling + joint): at 175k steps (``tools/learning_check.py --recipe
flagship``, ``results/flagship_L5M25_h100_policy.npz``) and at 100k steps
of one unbroken run (``--recipe flagship100k``,
``results/flagship_L5M25_100k_h100_policy.npz``), each carried out of its
checkpoint by ``tools/flagship_policy.py`` with its training bank, its
held-out rows and their recorded evaluation. Every test runs on each file.

The port's ``ConvQNetwork`` and the JAX package's flax conv net, given the
same weights (the flax tree built here by inverting
``models/convnet.py::params_from_flax``), give the same Q within 1e-4 on 64
observations of the carried held-out rows; the held-out rows share no row
with the training rows."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.models.convnet import ConvQNetwork as JConvQNetwork
from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
from tetris_piclim_tpu_torch.gen.bank import FAMILY_CARVE, FAMILY_FORWARD
from tetris_piclim_tpu_torch.models import convnet as tconv
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from tetris_piclim_tpu_torch.utils.checkpoint import read_policy_npz
from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

torch.set_num_threads(1)

RESULTS = Path(__file__).resolve().parents[1] / "results"
# each carried policy and the step its run stopped at
POLICIES = {"175k": (RESULTS / "flagship_L5M25_h100_policy.npz", 175_000),
            "100k": (RESULTS / "flagship_L5M25_100k_h100_policy.npz", 100_000)}
Q_ATOL = 1e-4
N_PARAMS = 1_681_321


@pytest.fixture(scope="module", params=sorted(POLICIES), ids=sorted(POLICIES))
def carried(request):
    path, step = POLICIES[request.param]
    pol = read_policy_npz(str(path))
    assert pol["meta"]["step"] == step
    net = tconv.ConvQNetwork(channels=(32, 64), dueling=True, joint=True)
    net.load_state_dict(pol["net"])
    return pol, net.eval(), path


def flax_tree(sd: dict) -> dict:
    """The JAX conv impl's parameter tree of the dueling net whose port
    state_dict is ``sd``: the inverse of ``params_from_flax``."""
    sd = {k: v.numpy() for k, v in sd.items()}
    dense = lambda w, b: {"kernel": w.T.copy(), "bias": b}  # noqa: E731
    p = {f"Conv_{i}": {"kernel": sd[f"convs.{i}.weight"].transpose(2, 3, 1, 0).copy(),
                       "bias": sd[f"convs.{i}.bias"]} for i in range(2)}
    for k, name in enumerate(["dense.0", "dense.1", "head.value", "head.adv"]):
        p[f"Dense_{k}"] = dense(sd[f"{name}.weight"], sd[f"{name}.bias"])
    return {"params": p}


def test_carried_file_is_the_flagship_run(carried):
    pol, net, _ = carried
    meta, banks = pol["meta"], pol["banks"]
    assert (meta["L"], meta["M"]) == (5, 25) and meta["step"] > 0
    assert meta["n_params"] == N_PARAMS == sum(v.numel() for v in pol["net"].values())
    assert all(v.dtype == torch.float32 for v in pol["net"].values())
    assert sorted(banks) == ["holdout", "train"]
    assert banks["train"].capacity == 4096 and banks["holdout"].capacity == 2048
    assert banks["train"].pieces.shape == (4096, 26)
    ev = meta["eval"]
    assert banks["holdout"].family_counts == ev["holdout"]["families"]
    build = ev["holdout"]["build"]
    assert build["host_forward"] + build["device_forward"] == \
        ev["holdout"]["families"]["forward"]
    for key in ("holdout", "holdout_carve", "holdout_forward"):
        assert 0.0 <= ev[key]["win_rate"] <= 1.0 and ev[key]["episodes"] == 8192
    train_bank = ev.get("bank") or ev["train_bank"]
    assert 0.0 <= train_bank["win_rate"] <= 1.0
    # the forward rows come first, as make_holdout_bank lays them out
    fam = banks["holdout"].family
    n_fwd = ev["holdout"]["families"]["forward"]
    assert (fam[:n_fwd] == FAMILY_FORWARD).all() and (fam[n_fwd:] == FAMILY_CARVE).all()


def test_flagship_q_matches_jax(carried):
    """64 held-out rows' observations through both packages' conv nets:
    Q within 1e-4, and the tree given to flax reads back to the carried
    state_dict exactly."""
    pol, net, _ = carried
    tree = flax_tree(pol["net"])
    back = tconv.params_from_flax(tree, net)
    assert sorted(back) == sorted(pol["net"])
    assert all(torch.equal(back[k], pol["net"][k]) for k in back)
    hold = pol["banks"]["holdout"]
    idx = torch.as_tensor(np.random.default_rng(0).choice(hold.capacity, 64, replace=False))
    obs = tbb.observe(tbb.make_state_batch(hold.cols[idx], hold.pieces[idx], 5, 25))
    with torch.no_grad():
        q_port = net(obs).numpy()
    q_jax = np.asarray(JConvQNetwork(dueling=True, joint=True).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(obs.numpy())))
    assert q_port.shape == q_jax.shape == (64, 40)
    assert np.abs(q_port - q_jax).max() <= Q_ATOL
    assert np.abs(q_port).max() > 1.0  # trained weights, not a fresh init


def test_holdout_rows_are_not_training_rows(carried):
    pol, _, _ = carried
    train, hold = pol["banks"]["train"], pol["banks"]["holdout"]
    keys = hold.row_keys()
    assert len(keys) == hold.capacity  # no row twice
    assert not keys & train.row_keys()


def test_warm_start_reads_the_policy_npz(carried):
    """``DQNTrainer.warm_start`` (and so ``cli eval --checkpoint``) loads the
    carried online net into both of the trainer's nets."""
    pol, _, path = carried
    cfg = TrainConfig(env=EnvConfig(L=5, M=25), num_envs=8, bank_capacity=4096,
                      replay_capacity=256, seed=0)
    net = tconv.ConvQNetwork(channels=(32, 64), dueling=True, joint=True)
    tr = DQNTrainer(cfg, bank=pol["banks"]["train"], net=net, device="cpu")
    tr.warm_start(str(path))
    for got in (tr.state.net, tr.state.target_net):
        for k, v in got.state_dict().items():
            assert torch.equal(v, pol["net"][k])
