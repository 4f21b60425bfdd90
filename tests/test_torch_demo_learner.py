"""The port's learner update with demonstrations against the JAX package's:
the conv dueling joint net of the flagship recipe, a quarter of the batch
from the demonstration buffer and the DQfD margin on those rows; the sample
offsets are JAX's, replayed into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tetris_piclim_tpu.dqn import agent as jagent
from tetris_piclim_tpu.models.convnet import ConvQNetwork as JConvQNetwork
from tetris_piclim_tpu.utils.config import DQNConfig as JDQNConfig
from tetris_piclim_tpu_torch.dqn import agent as tagent
from tetris_piclim_tpu_torch.models import convnet as tconv
from tetris_piclim_tpu_torch.utils.config import DQNConfig
from torch_port_helpers import filled_replays, t

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _conv_nets(seed):
    kw = dict(channels=(4, 8), dueling=True, joint=True)
    jnet = JConvQNetwork(**kw)
    jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 217)))
    nets = []
    for _ in range(2):
        net = tconv.ConvQNetwork(**kw)
        net.load_state_dict(tconv.params_from_flax(jax.tree.map(np.asarray, jparams), net))
        nets.append(net)
    return jnet, jparams, *nets


def test_learner_update_with_demos_and_margin_matches_jax():
    """Two updates of the flagship learner: 3/4 of the batch from the env
    replay, 1/4 from the demonstration buffer, the DQfD margin 0.8 on the
    demo rows. The JAX key is split into k_env / k_demo as the JAX learner
    splits it (agent.py:229-230), and the offsets it draws are given to the
    port."""
    cap, n, B, demo_n, margin = 256, 32, 32, 8, 0.8
    jr, tr = filled_replays(cap, n, writes=6, seed=11)
    jd, td = filled_replays(128, 32, writes=4, seed=12)
    jnet, jparams, tnet, ttarget = _conv_nets(seed=3)
    jtarget = jparams
    jcfg, tcfg = JDQNConfig(batch_size=B), DQNConfig(batch_size=B)
    jopt = jagent.make_optimizer(jcfg)
    jopt_state = jopt.init(jparams)
    topt = tagent.make_optimizer(tnet, tcfg)
    upd = jax.jit(lambda p, tp, o, r, d, k: jagent.learner_update(
        p, tp, o, r, k, apply_fn=jnet.apply, optimizer=jopt, cfg=jcfg,
        step_gap=n, demo_rpl=d, demo_n=demo_n, demo_margin=margin))
    for i in range(2):
        key = jax.random.PRNGKey(40 + i)
        jparams, jtarget, jopt_state, jr, jaux = upd(jparams, jtarget, jopt_state,
                                                     jr, jd, key)
        k_env, k_demo = jax.random.split(key)
        j_env = jax.random.randint(k_env, (B - demo_n,), 0, int(jr.size))
        j_demo = jax.random.randint(k_demo, (demo_n,), 0, int(jd.size))
        taux = tagent.learner_update(
            tnet, ttarget, topt, tr, tcfg, step_gap=n, j=t(np.asarray(j_env)),
            demo=td, demo_n=demo_n, demo_j=t(np.asarray(j_demo)),
            demo_margin=margin)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(taux["demo_margin_loss"]),
                                   float(jaux["demo_margin_loss"]), rtol=1e-5)
        assert float(jaux["demo_margin_loss"]) > 0
    for net, tree in ((tnet, jparams), (ttarget, jtarget)):
        want = tconv.params_from_flax(jax.tree.map(np.asarray, tree), net)
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
