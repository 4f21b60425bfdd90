"""Port learner extensions against the JAX package: the bf16-moment
optimizer, the n-step / prioritized sampler and its priority write-back and
the PER beta schedule. Base indices come from the JAX side and are replayed
into the port. Also the port's own draws: PER frequencies follow
``priority ** alpha`` and duplicate priority writes keep the last one. The
learner update with demonstrations is in ``test_torch_demo_learner.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from tetris_piclim_tpu.dqn import agent as jagent
from tetris_piclim_tpu.dqn import replay as jreplay
from tetris_piclim_tpu.utils.config import DQNConfig as JDQNConfig
from tetris_piclim_tpu_torch.dqn import agent as tagent
from tetris_piclim_tpu_torch.dqn.replay import ReplayBuffer
from tetris_piclim_tpu_torch.utils.config import DQNConfig
from torch_port_helpers import filled_replays, t

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _bf16_bits(x) -> np.ndarray:
    """bfloat16 values as their 16-bit patterns (int32, for ulp distances)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def test_bf16_moments_match_jax_over_five_steps():
    rng = np.random.default_rng(0)
    shapes = {"w": (96, 40), "b": (40,), "v": (7,)}
    params = {k: rng.normal(0, 0.3, s).astype(np.float32) for k, s in shapes.items()}
    jopt = jagent.make_optimizer(JDQNConfig(opt_state_bf16=True, lr=1e-3))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    names = list(shapes)
    topt = tagent.make_optimizer(
        torch.nn.ParameterList([torch.nn.Parameter(tp[k]) for k in names]),
        DQNConfig(opt_state_bf16=True, lr=1e-3))
    assert isinstance(topt, tagent.AmsgradBf16)
    upd = jax.jit(jopt.update)
    for step in range(5):
        # gradients over several decades, so the bf16 stores round often
        grads = {k: (rng.normal(0, 1, s) * 10.0 ** rng.integers(-4, 1, s))
                 .astype(np.float32) for k, s in shapes.items()}
        u, jstate = upd({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        for p, k in zip(topt.params, names):
            p.grad = torch.as_tensor(grads[k])
        topt.step()
    st = jstate[0]
    assert int(st.count) == topt.count == 5
    n_off = n_all = 0
    for field in ("mu", "nu", "nu_max"):
        for k, got in zip(names, getattr(topt, field)):
            assert got.dtype == torch.bfloat16
            dist = np.abs(_bf16_bits(got) - _bf16_bits(getattr(st, field)[k]))
            assert dist.max() <= 1, (field, k)
            n_off += int((dist > 0).sum())
            n_all += dist.size
    assert n_off <= 0.001 * n_all, (n_off, n_all)
    for p, k in zip(topt.params, names):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def _set_priorities(jr, tr, seed):
    rng = np.random.default_rng(seed)
    prio = rng.gamma(1.0, 1.0, tr.capacity).astype(np.float32) + 1e-3
    jr = jr._replace(priority=jnp.asarray(prio), max_prio=jnp.float32(prio.max()))
    tr.priority.copy_(t(prio))
    tr.max_prio.fill_(float(prio.max()))
    return jr, tr


@pytest.mark.parametrize("n_step,prioritized,wrapped",
                         [(3, False, True), (3, True, True), (1, True, False),
                          (4, True, False)])
def test_sample_ext_matches_jax(n_step, prioritized, wrapped):
    cap, n, B = 256, 32, 64   # the replay shapes of every test here: one compile
    jr, tr = filled_replays(cap, n, writes=11 if wrapped else 5, seed=n_step)
    if prioritized:
        jr, tr = _set_priorities(jr, tr, seed=n_step)
    key = jax.random.PRNGKey(7 + n_step)
    kw = dict(gamma=0.99, n_step=n_step, step_gap=n, prioritized=prioritized,
              alpha=0.6, beta=0.55)
    jb, idx0 = jreplay.replay_sample_ext(jr, key, B, **kw)
    if prioritized:
        tb, tidx = tr.sample_ext(B, idx0=t(np.asarray(idx0)), **kw)
    else:
        valid = max(int(jr.size) - (n_step - 1) * n, 1)
        j = jax.random.randint(key, (B,), 0, valid)
        tb, tidx = tr.sample_ext(B, j=t(np.asarray(j)), **kw)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx0))
    for f in ("obs", "next_obs", "rot", "col", "done"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_allclose(tb.reward.numpy(), np.asarray(jb.reward), rtol=0,
                               atol=1e-6)
    if n_step > 1:
        np.testing.assert_allclose(tb.discount.numpy(), np.asarray(jb.discount),
                                   rtol=0, atol=1e-6)
        assert (np.asarray(jb.discount) < 0.99 ** n_step + 1e-6).any()  # full chains
        assert (np.asarray(jb.discount) > 0.99 ** n_step + 1e-6).any()  # cut chains
    if prioritized:
        np.testing.assert_allclose(tb.weight.numpy(), np.asarray(jb.weight),
                                   rtol=0, atol=1e-6)


def test_update_priority_matches_jax_without_duplicates():
    jr, tr = filled_replays(128, 32, writes=3, seed=5)
    rng = np.random.default_rng(5)
    idx = rng.permutation(96)[:40].astype(np.int32)
    td = np.abs(rng.normal(0, 2, 40)).astype(np.float32)
    want = jreplay.replay_update_priority(jr, jnp.asarray(idx), jnp.asarray(td), 1e-3)
    tr.update_priority(t(idx).long(), t(td), 1e-3)
    np.testing.assert_array_equal(tr.priority.numpy(), np.asarray(want.priority))
    assert float(tr.max_prio) == float(want.max_prio)
    # fresh writes take the running max, on both write paths
    rows = {k: v[:32] for k, v in tr.buf.items()}
    tr.add_fields(*rows.values())
    assert (tr.priority[96:128] == tr.max_prio).all()


def test_duplicate_priority_indices_keep_the_last_write():
    tr = ReplayBuffer(64, "cpu")
    idx = torch.tensor([5, 9, 5, 3, 9, 5, 12])
    td = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    tr.update_priority(idx, td, 0.0)
    assert tr.priority[5] == 6.0 and tr.priority[9] == 5.0
    assert tr.priority[3] == 4.0 and tr.priority[12] == 7.0
    assert float(tr.max_prio) == 7.0
    assert int((tr.priority != 0).sum()) == 4


def test_per_frequencies_follow_priority_power():
    """The port's own PER draw: over many samples, slot counts follow
    ``priority ** alpha`` on the live window, and masked slots (unwritten,
    or the newest whose n-step chain is not yet written) never come up."""
    cap, n = 128, 32
    _, tr = filled_replays(cap, n, writes=3, seed=2)    # 96 of 128 slots written
    prio = np.random.default_rng(2).uniform(0.2, 3.0, cap).astype(np.float32)
    tr.priority.copy_(t(prio))
    n_step, alpha, draws = 2, 0.6, 60000
    gen = torch.Generator().manual_seed(0)
    _, idx0 = tr.sample_ext(draws, gamma=0.99, n_step=n_step, step_gap=n,
                            prioritized=True, alpha=alpha, generator=gen)
    counts = np.bincount(idx0.numpy(), minlength=cap)
    live = 96 - (n_step - 1) * n
    assert counts[live:].sum() == 0
    p = prio[:live].astype(np.float64) ** alpha
    res = scipy.stats.chisquare(counts[:live], draws * p / p.sum())
    assert res.pvalue > 1e-3, res


@pytest.mark.parametrize("anneal,steps", [(True, 0), (True, 300), (False, 0)])
def test_per_beta_schedule_matches_jax(anneal, steps):
    kw = dict(per_beta=0.4, per_beta_anneal=anneal, per_beta_steps=steps)
    jcfg, tcfg = JDQNConfig(**kw), DQNConfig(**kw)
    for step in (0, 1, 77, 299, 300, 999, 1000, 5000):
        want = float(jagent.per_beta_schedule(jnp.int32(step), jcfg, 1000))
        assert tagent.per_beta_schedule(step, tcfg, 1000) == want, step
