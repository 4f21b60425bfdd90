"""Port replay ring and learner vs the JAX package on identical inputs.

Replay: the same writes give identical buffers, and the same sample offsets
identical batches. Learner: ``td_loss`` and its gradients within rtol 1e-5,
and five ``learner_update`` steps (Huber double-DQN loss, AdamW-amsgrad in
optax's order, Polyak) from identical weights and replay within rtol 1e-5,
atol 1e-6. The tolerance covers float32 sums taken in another order by XLA
and by torch on the CPU; nothing else differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.dqn import agent as jagent
from tetris_piclim_tpu.dqn import replay as jreplay
from tetris_piclim_tpu.models.qnet import QNetwork as JQNetwork
from tetris_piclim_tpu.utils.config import DQNConfig as JDQNConfig
from tetris_piclim_tpu_torch.dqn import agent as tagent
from tetris_piclim_tpu_torch.dqn.replay import ReplayBuffer
from tetris_piclim_tpu_torch.models.qnet import QNetwork, params_from_flax
from tetris_piclim_tpu_torch.utils.config import DQNConfig
from torch_port_helpers import adversarial_boards, pack_np, t

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _transitions(rng, n):
    """One step's worth of packed transition fields (numpy)."""
    return dict(
        cols=pack_np(adversarial_boards(rng, n)),
        cur=rng.integers(0, 7, n).astype(np.int8),
        nxt=rng.integers(0, 7, n).astype(np.int8),
        ll=rng.integers(0, 4, n).astype(np.int32),
        ml=rng.integers(0, 21, n).astype(np.int32),
        rot=rng.integers(0, 4, n).astype(np.int32),
        col=rng.integers(0, 10, n).astype(np.int32),
        reward=rng.choice([-10.0, 0.0, 1.0, 10.0], n).astype(np.float32),
        done=rng.random(n) < 0.2,
        n_cols=pack_np(adversarial_boards(rng, n)),
        n_cur=rng.integers(0, 7, n).astype(np.int8),
        n_nxt=rng.integers(0, 7, n).astype(np.int8),
        n_ll=rng.integers(0, 4, n).astype(np.int32),
        n_ml=rng.integers(0, 21, n).astype(np.int32),
        n_st=rng.integers(0, 3, n).astype(np.int8),
    )


_jadd = jax.jit(jreplay.replay_add_fields)


def _filled(cap, n, writes, seed=0):
    rng = np.random.default_rng(seed)
    jr = jreplay.replay_init(cap)
    tr = ReplayBuffer(cap, "cpu")
    for _ in range(writes):
        f = _transitions(rng, n)
        jr = _jadd(jr, *[jnp.asarray(v) for v in f.values()])
        tr.add_fields(*[t(v) for v in f.values()])
    return jr, tr


def test_replay_buffers_and_batches_identical():
    cap, n = 96, 24
    jr, tr = _filled(cap, n, writes=5)  # wraps once
    assert (tr.pos, tr.size) == (int(jr.pos), int(jr.size))
    for name, buf in tr.buf.items():
        np.testing.assert_array_equal(
            buf.numpy().astype(np.int64) if buf.dtype != torch.float32 else buf.numpy(),
            np.asarray(getattr(jr, name)).astype(buf.numpy().dtype), err_msg=name)
    key = jax.random.PRNGKey(4)
    jb, _ = jreplay.replay_sample_ext(jr, key, 64, gamma=0.99)
    j = jax.random.randint(key, (64,), 0, jnp.maximum(jr.size, 1))
    tb = tr.sample(64, j=t(np.asarray(j)))
    for f in ("obs", "next_obs", "reward"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)
    for f in ("rot", "col", "done"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)
    assert not tb.obs[:, 216].any()  # the status lane of s is 0
    with pytest.raises(ValueError, match="multiple"):
        ReplayBuffer(10, "cpu").add_fields(*[t(v) for v in _transitions(
            np.random.default_rng(0), 4).values()])


def _nets(joint, seed=0):
    jnet = JQNetwork(joint=joint)
    jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 217)))
    sd = params_from_flax(jax.tree.map(np.asarray, jparams))
    tnet, ttarget = QNetwork(joint=joint), QNetwork(joint=joint)
    tnet.load_state_dict(sd)
    ttarget.load_state_dict(sd)
    return jnet, jparams, tnet, ttarget


def _assert_params_close(tnet, jparams, rtol, atol):
    want = params_from_flax(jax.tree.map(np.asarray, jparams))
    for name, p in tnet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("joint,double", [(False, True), (True, True), (False, False)])
def test_td_loss_and_grads_match(joint, double):
    jr, tr = _filled(128, 32, writes=4, seed=1)
    jnet, jparams, tnet, ttarget = _nets(joint, seed=2)
    # a target that differs from the online net
    jtarget = jax.tree.map(lambda x: x * 0.9, jparams)
    ttarget.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtarget)))
    jcfg, tcfg = JDQNConfig(double_dqn=double), DQNConfig(double_dqn=double)
    key = jax.random.PRNGKey(9)
    jb, _ = jreplay.replay_sample_ext(jr, key, 48, gamma=jcfg.gamma)
    loss_fn = lambda p, tp, b: jagent.td_loss(p, tp, jnet.apply, b, jcfg)  # noqa: E731
    (jl, jaux), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, jtarget, jb)
    tb = tr.sample(48, j=t(np.asarray(
        jax.random.randint(key, (48,), 0, jnp.maximum(jr.size, 1)))))
    tl, taux = tagent.td_loss(tnet, ttarget, tb, tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(taux["q_mean"]), float(jaux["q_mean"]),
                               rtol=1e-5, atol=1e-6)
    jgrads = params_from_flax(jax.tree.map(np.asarray, jg))
    for name, p in tnet.named_parameters():
        g = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


def test_five_learner_updates_match_optax():
    cap, n, B = 256, 32, 32
    jr, tr = _filled(cap, n, writes=8, seed=3)
    jnet, jparams, tnet, ttarget = _nets(False, seed=4)
    jcfg = JDQNConfig(batch_size=B, lr=1e-3)
    tcfg = DQNConfig(batch_size=B, lr=1e-3)
    jopt = jagent.make_optimizer(jcfg)
    jopt_state = jopt.init(jparams)
    jtarget = jparams
    topt = tagent.make_optimizer(tnet, tcfg)
    upd = jax.jit(lambda p, tp, o, r, k: jagent.learner_update(
        p, tp, o, r, k, apply_fn=jnet.apply, optimizer=jopt, cfg=jcfg,
        step_gap=n))
    for i in range(5):
        key = jax.random.PRNGKey(100 + i)
        jparams, jtarget, jopt_state, jr, jaux = upd(jparams, jtarget, jopt_state, jr, key)
        j = jax.random.randint(key, (B,), 0, jnp.maximum(jr.size, 1))
        taux = tagent.learner_update(tnet, ttarget, topt, tr, tcfg, j=t(np.asarray(j)))
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    _assert_params_close(tnet, jparams, rtol=1e-5, atol=1e-6)
    _assert_params_close(ttarget, jtarget, rtol=1e-5, atol=1e-6)
    # the moments too (optax's ScaleByAmsgradState is the chain's first state)
    amsgrad = jopt_state[0]
    for mine, theirs in ((topt.mu, amsgrad.mu), (topt.nu_max, amsgrad.nu_max)):
        want = params_from_flax(jax.tree.map(np.asarray, theirs))
        for (name, _), got in zip(tnet.named_parameters(), mine):
            w = want[name].numpy()
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=name)
    assert topt.count == int(amsgrad.count) == 5


def test_select_actions_and_eps_match():
    jcfg, tcfg = JDQNConfig(), DQNConfig()
    for step in (0, 10, 1000, 5000):
        np.testing.assert_allclose(
            tagent.eps_schedule(step, tcfg),
            float(jagent.eps_schedule(jnp.int32(step), jcfg)), rtol=1e-7)
    jnet, jparams, tnet, _ = _nets(False, seed=6)
    rng = np.random.default_rng(5)
    obs = rng.random((64, 217)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    eps = 0.4
    jrot, jcol = jagent.select_actions(jnet.apply, jparams, jnp.asarray(obs),
                                       jnp.float32(eps), key)
    k_expl, k_rot, k_col = jax.random.split(key, 3)
    draws = dict(
        explore_u=t(np.asarray(jax.random.uniform(k_expl, (64,)))),
        r_rot=t(np.asarray(jax.random.randint(k_rot, (64,), 0, 4))),
        r_col=t(np.asarray(jax.random.randint(k_col, (64,), 0, 10))),
    )
    trot, tcol = tagent.select_actions(tnet, t(obs), eps, **draws)
    np.testing.assert_array_equal(trot.numpy(), np.asarray(jrot))
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tagent.make_optimizer(tnet, DQNConfig(n_step=3))
